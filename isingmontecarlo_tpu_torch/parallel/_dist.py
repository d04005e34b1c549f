"""Collectives of the sharded tempering path over a ``torch.distributed``
process group, and a launcher that runs a function on ``n`` spawned ranks.

The collectives take an explicit ``group`` (``None``: the world group) and
use forms that both the ``gloo`` and the ``nccl`` backend take with CUDA
tensors: the list form of ``all_gather`` and ``all_reduce``. Bool tensors
travel as bytes. Each call adds what it moved to ``profiling``'s counters
``dist.<tag>.calls`` and ``dist.<tag>.bytes`` under a tag, and is the span
``dist.all_gather.<tag>`` or ``dist.all_reduce.<tag>``: an all-gather
counts the gathered tensor, ``world`` times the local one; an all-reduce
the reduced tensor. :func:`traffic` reads those counters, with the local
shapes of each tag: how a caller checks that only label vectors cross
ranks.
"""

from __future__ import annotations

import datetime
import multiprocessing
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from isingmontecarlo_tpu_torch import profiling

# The timeout of every collective of a group that :func:`spawn` starts, its
# rendezvous included: a rank that waits longer on the others fails.
COLLECTIVE_TIMEOUT_S = 60.0

# The local (shape, dtype) of each tag's collectives; their calls and bytes
# are profiling's ``dist.`` counters.
_SHAPES: dict[str, set] = {}


def reset_traffic() -> None:
    _SHAPES.clear()
    profiling.reset_counters("dist.")


def traffic() -> dict[str, dict]:
    """Per tag: ``calls``, ``bytes`` and the local ``shapes`` (with dtype)
    that went through a collective since :func:`reset_traffic`."""
    counts = profiling.counters()
    return {tag: {"calls": counts.get(f"dist.{tag}.calls", 0),
                  "bytes": counts.get(f"dist.{tag}.bytes", 0), "shapes": sorted(shapes)}
            for tag, shapes in _SHAPES.items()}


def _count(tag: str, local: torch.Tensor, nbytes: int) -> None:
    profiling.count(f"dist.{tag}.calls")
    profiling.count(f"dist.{tag}.bytes", nbytes)
    _SHAPES.setdefault(tag, set()).add(
        (tuple(local.shape), str(local.dtype).removeprefix("torch.")))


def require_group() -> None:
    """Raise unless a process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group is initialised: call "
                           "torch.distributed.init_process_group first")


def all_gather(x: torch.Tensor, group=None, dim: int = 0, tag: str = "swap") -> torch.Tensor:
    """Every rank's ``x``, concatenated along ``dim`` in rank order: the
    tiled all-gather of a rank's block of a ``[R, ...]`` tensor."""
    src = x.contiguous()
    as_bytes = src.dtype == torch.bool
    if as_bytes:
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    with profiling.span(f"dist.all_gather.{tag}"):
        dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    _count(tag, x, out.numel() * out.element_size())
    return out.view(torch.bool) if as_bytes else out


def _all_reduce(x: torch.Tensor, op, group, tag: str) -> torch.Tensor:
    out = x.clone()
    with profiling.span(f"dist.all_reduce.{tag}"):
        dist.all_reduce(out, op=op, group=group)
    _count(tag, x, out.numel() * out.element_size())
    return out


def all_reduce_max(x: torch.Tensor, group=None, tag: str = "grow") -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks (a small int vector)."""
    return _all_reduce(x, dist.ReduceOp.MAX, group, tag)


def all_true(flag: bool, device: torch.device, group=None, tag: str = "verify") -> bool:
    """``flag`` and-ed over the ranks."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    return bool(_all_reduce(t, dist.ReduceOp.MIN, group, tag)[0])


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s sweep generator: a different stream for
    every rank of one ``seed``."""
    return int(np.random.SeedSequence([seed, 0x5EED, rank]).generate_state(1, np.uint64)[0])


def rank_device(device: torch.device | str, rank: int, backend: str) -> torch.device:
    """The device of rank ``rank``: the CPU where ``device`` is the CPU,
    else card ``rank`` modulo the card count (the ``gloo`` ranks of a
    one-card host share it; ``nccl`` refuses two ranks on one card)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"no sharded path for device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank} was asked for {dev}, but CUDA is not available")
    cards = torch.cuda.device_count()
    if backend == "nccl" and rank >= cards:
        raise ValueError(f"nccl needs a card a rank: rank {rank} of a host with {cards}")
    return torch.device("cuda", rank % cards)


def _rank_main(fn, rank: int, world: int, backend: str, init_method: str, out_dir: str,
               args: tuple) -> None:
    torch.set_num_threads(1)
    out = Path(out_dir)
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world,
                                rank=rank,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn(fn: Callable, world_size: int, backend: str, *args, timeout: float = 300.0,
          workdir: str | None = None) -> list:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned processes,
    each in a process group of ``backend`` (``"gloo"`` or ``"nccl"``) that a
    ``file://`` rendezvous under ``workdir`` (a new temporary directory when
    None) joins; collectives time out after ``COLLECTIVE_TIMEOUT_S`` seconds. Returns
    each rank's result (``torch.save``-able) in rank order. Raises with
    every failed rank's traceback when a rank fails, and kills every rank
    that is still running after ``timeout`` seconds. ``fn`` must be
    importable by its module path."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init = f"file://{Path(tmp, 'rendezvous').resolve()}"
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, backend, init, tmp, args), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        # Wait for every rank, or until one fails: the others would then
        # wait in a collective until it times out.
        deadline = time.monotonic() + timeout
        while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.05)
        failed = any(p.exitcode for p in procs)
        hung = [] if failed else [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        errors = [f"rank {r}:\n{Path(tmp, f'rank{r}.err').read_text()}"
                  for r in range(world_size) if Path(tmp, f"rank{r}.err").exists()]
        if errors or hung:
            raise RuntimeError(
                (f"ranks {hung} still ran after {timeout} s and were killed\n" if hung else "")
                + "\n".join(errors))
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
