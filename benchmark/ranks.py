"""The harness's own launcher of a cell's ranks: one spawned process a
card, joined in a ``torch.distributed`` process group through a ``file://``
rendezvous in a new directory under ``TMPDIR``. Modelled on the program's
``parallel/_dist.py::spawn``, and kept apart from it so that a change to the
program cannot change how the benchmark starts its ranks.

This module imports no torch until a rank runs or a result is read, so that
a run can start its ranks first and import torch while they import theirs."""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, NamedTuple

# Every collective of the group, the rendezvous included, fails after this.
COLLECTIVE_TIMEOUT_S = 120.0

# This process's set-up stages: name -> (wall clock, CPU seconds) at its end.
_MARKS: dict = {}


def mark(stage: str) -> None:
    """Notes that a set-up stage of this process has ended."""
    _MARKS[stage] = (time.time(), time.process_time())


def marks() -> dict:
    return dict(_MARKS)


def stage_report(t0_epoch: float, per_process: list) -> str:
    """One line: each stage's end in seconds from ``t0_epoch`` (the slowest
    process's) and its CPU seconds (the processes' mean), stages in the
    order of their ends."""
    if not per_process or not per_process[0]:
        return "none"
    names = sorted(per_process[0], key=lambda k: per_process[0][k][0])
    parts, cpu0 = [], [0.0] * len(per_process)
    for k in names:
        cpu = [m[k][1] - c for m, c in zip(per_process, cpu0)]
        cpu0 = [m[k][1] for m in per_process]
        parts.append(f"{k} {max(m[k][0] for m in per_process) - t0_epoch:.3f} "
                     f"(cpu {sum(cpu) / len(cpu):.3f})")
    return ", ".join(parts)


def _rank_main(fn, rank: int, world: int, backend: str, init: str, out_dir: str,
               args: tuple) -> None:
    out = Path(out_dir)
    try:
        if isinstance(fn, str):
            module, name = fn.split(":")
            fn = getattr(importlib.import_module(module), name)
        import torch
        import torch.distributed as dist

        mark("rank_started")
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        mark("group")
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


class Ranks(NamedTuple):
    procs: list
    tmp: str


def start(fn: Callable | str, world: int, backend: str, *args) -> Ranks:
    """Starts ``fn(rank, world, *args)`` on ``world`` spawned processes.
    ``fn`` may be ``"module:name"``, which the ranks import and the caller
    need not."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="bench-ranks-")
    init = f"file://{Path(tmp, 'rendezvous').resolve()}"
    ranks = Ranks([ctx.Process(target=_rank_main, args=(fn, r, world, backend, init, tmp, args))
                   for r in range(world)], tmp)
    try:
        for p in ranks.procs:
            p.start()
    except BaseException:
        stop(ranks)
        raise
    return ranks


def _kill(procs: list) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
        if p.pid is not None:
            p.join()


def stop(ranks: Ranks) -> None:
    """Kills every rank still running, waits for each, and removes the
    ranks' directory."""
    _kill(ranks.procs)
    shutil.rmtree(ranks.tmp, ignore_errors=True)


def join(ranks: Ranks, timeout: float) -> list:
    """Each rank's result in rank order. Raises with every failed rank's
    traceback when one fails; kills and joins every rank still running
    after ``timeout`` seconds or after another failed."""
    procs, tmp = ranks
    try:
        deadline = time.monotonic() + timeout
        while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.05)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        _kill(procs)
        errors = [f"rank {r}:\n{Path(tmp, f'rank{r}.err').read_text()}"
                  for r in range(len(procs)) if Path(tmp, f"rank{r}.err").exists()]
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if errors or bad:
            raise RuntimeError(f"ranks {hung} killed; exit codes {bad}\n" + "\n".join(errors))
        import torch

        return [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(len(procs))]
    finally:
        stop(ranks)


def spawn(fn: Callable | str, world: int, backend: str, *args, timeout: float) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned processes; returns
    each rank's result in rank order, as :func:`join`."""
    return join(start(fn, world, backend, *args), timeout)
