"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every source in ``csrc/`` is compiled with one ``nvcc`` call into one
shared library with a plain C interface, loaded with :mod:`ctypes` — no
PyTorch headers, so a build takes seconds.  The build happens at the first
CUDA call, into ``otto_tpu_torch/_build/``; the library's name carries a
hash of all the sources and the flags, so an edited source is rebuilt.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.

The launchers take tensors that the calling wrapper has already checked
(device, dtype, shape, contiguity), pass their ``data_ptr()`` and PyTorch's
current stream, and raise if the launch was refused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((PKG_DIR / "csrc").glob("*.cu")))
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
                           "and PATH): the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libotto_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for this exact source exists.
    Raises with nvcc's output if the compile fails.  The ptxas report
    (registers, shared memory, spills) is kept beside the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            for name in ("fused_stage1_bf16", "fused_stage1_f32"):
                fn = getattr(cdll, name)
                fn.argtypes = [p, p, p, i, i, ll, i, p]
                fn.restype = i
            cdll.peel_rows_f32.argtypes = [p, p, p, i, i, i, i, p]
            cdll.peel_rows_f32.restype = i
            cdll.aid_vote_f32.argtypes = [p, p, p, p, p, i, i, i, p]
            cdll.aid_vote_f32.restype = i
            _lib = cdll
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_fused_stage1(q: torch.Tensor, t: torch.Tensor, out: torch.Tensor) -> None:
    """q [B, DA], t [DA, N_pad] (both bf16 or both f32), out [B, N_pad/128] f32."""
    name = "fused_stage1_bf16" if t.dtype == torch.bfloat16 else "fused_stage1_f32"
    err = getattr(lib(), name)(q.data_ptr(), t.data_ptr(), out.data_ptr(),
                               q.shape[0], q.shape[1], t.shape[1], t.device.index,
                               _stream(t))
    _check(err, name)


def launch_peel_rows(x: torch.Tensor, rounds: int, vals: torch.Tensor,
                     cols: torch.Tensor) -> None:
    """x [B, M] f32 -> vals [B, rounds, M/128] f32, cols int32 (same shape)."""
    err = lib().peel_rows_f32(x.data_ptr(), vals.data_ptr(), cols.data_ptr(),
                              x.shape[0], x.shape[1], rounds, x.device.index, _stream(x))
    _check(err, "peel_rows_f32")


def launch_aid_vote(aids: torch.Tensor, weights: torch.Tensor, agg: torch.Tensor,
                    first: torch.Tensor, firstpos: torch.Tensor) -> None:
    """aids int32 [S, L], weights f32 [S, L] -> agg f32, first and firstpos
    int32 (all [S, L])."""
    err = lib().aid_vote_f32(aids.data_ptr(), weights.data_ptr(), agg.data_ptr(),
                             first.data_ptr(), firstpos.data_ptr(), aids.shape[0],
                             aids.shape[1], aids.device.index, _stream(aids))
    _check(err, "aid_vote_f32")
