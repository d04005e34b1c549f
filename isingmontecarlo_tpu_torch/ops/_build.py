"""Build, load and call the CUDA kernels under ``csrc/``.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` (one compiler
process per source, all started together) and links into one shared library
with a plain C interface, loaded with ``ctypes``. The build runs at first
use, into ``_build/`` beside the sources, and the library's file name
carries a hash of the sources and flags, so a changed source is rebuilt. A
missing ``nvcc`` or a failed build raises with the compiler's output.

Each C entry point launches on the stream it is given, does not synchronise,
and returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# --fmad=false: no multiply-add contraction, so every f32 expression rounds
# as it does in the plain PyTorch versions and in XLA.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {
    # in, out, table, seed word 0, seed word 1, R, L, CTAs per replica,
    # nsweeps, stream
    "ising_checkerboard": (_P, _P, _P, _U, _U, _I, _I, _I, _I, _P),
    # in, out, halo (scratch), flags (zeroed), table, seed word 0, seed word
    # 1, L, nsweeps, first replica, replicas, bands a replica, stream
    "ising_checkerboard_bands": (_P, _P, _P, _P, _P, _U, _U, _I, _I, _I, _I, _I, _P),
    # in, out, table, seed word 0, seed word 1, R, L, first sweep, sweeps,
    # k (sweeps a launch: the halo), tile rows, tile columns, threads, stream
    "ising_checkerboard_tiles": (_P, _P, _P, _U, _U, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # in, out, planes (scratch), table, seed word 0, seed word 1, R, L,
    # nsweeps, stream
    "ising_checkerboard_global": (_P, _P, _P, _P, _U, _U, _I, _I, _I, _P),
    # table, idx, out, idx2, out2 (both null for one grid), C, E, E2, R, stream
    "ising_take0": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # P, Pn, u, v, first, S, E, R, stream
    "ising_hook_min": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # Pn, P_start, out, flag, tag, hops, S, R, stream
    "ising_pointer_jump": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # state, v_idx, tog, vq, seg (scratch), pb, sb, K, M, R, N, seg_len, stream
    "ising_parity_bits": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # the same for the wide and the global-memory variants
    "ising_parity_bits_wide": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "ising_parity_bits_global": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # n0, u0, idp, dgp, num_ins, num_rem, insert, remove, M, R, stream
    "ising_carry_metropolis": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # n0, u0, idp, dgp, insw, bwt, insert, remove, M, R, stream
    "ising_carry_heatbath": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libising_kernels_{h.hexdigest()[:16]}.so"


def nvcc_path() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
            "isingmontecarlo_tpu_torch cannot be built"
        )
    return path


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; return their joined output, or raise
    with the output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {p.returncode}:\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(path: Path) -> None:
    """Compile every source into ``path``; the compilers' output (with
    ``-Xptxas -v``'s register and shared-memory report) goes beside it as
    ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    objs, compiles = [], []
    for src in _sources():
        if src.suffix == ".cu":
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            objs.append(obj)
            compiles.append([nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    log = _run_all(compiles)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    log += _run_all([[nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    path.with_suffix(".log").write_text(log)
    os.replace(tmp, path)  # atomic: concurrent builders never load a partial file


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed."""
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ising_error_string.argtypes = (_I,)
    lib.ising_error_string.restype = ctypes.c_char_p
    return lib


def use_kernel(device: torch.device) -> bool:
    """The dispatch rule of every wrapper: the plain PyTorch version serves
    a CPU tensor, the CUDA kernel a CUDA tensor, and nothing else is served."""
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {device}")


def sm_count(device: torch.device) -> int:
    """The card's number of SMs, which sets some kernels' launch geometry."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: {t.numel()} elements exceed the int32 sizes of the C interface")


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` with ``args`` (tensors pass their data
    pointers) on the current stream of the first tensor's device; raise if
    the launch reports an error."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    lib = library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = getattr(lib, name)(*c_args, stream)
    if status != 0:
        raise RuntimeError(
            f"{name}: CUDA error {status}: {lib.ising_error_string(status).decode()}"
        )
