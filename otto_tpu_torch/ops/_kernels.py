"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every source in ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with :mod:`ctypes` — no PyTorch headers, so a
build takes seconds.  The build happens at the first
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def library_path(sources=SOURCES) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libotto_kernels_{h.hexdigest()[:16]}.so"


def build(sources=SOURCES, out: Path | None = None) -> Path:
    """Compile ``sources`` (the package's, by default) into the library
    ``out`` (by default named by their hash in ``_build/``) unless it
    exists.  Raises with nvcc's output if a compile or the link fails.  The
    ptxas report (registers, shared memory, spills) is kept beside the
    library."""
    out = out or library_path(sources)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    reports = [proc.communicate()[0] for proc in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for cmd, proc, report in zip(cmds, procs, reports):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{report}")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".ptxas.txt").write_text("".join(reports))
    os.replace(tmp, out)
    return out


_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the C entry points and their arguments; each returns a cudaError_t
ENTRY_POINTS = {
    "fused_stage1_bf16": [_p, _p, _p, _i, _i, _ll, _i, _p],
    "fused_stage1_f32": [_p, _p, _p, _i, _i, _ll, _i, _p],
    "fused_stage1_bf16_fma": [_p, _p, _p, _i, _i, _ll, _i, _p],
    "peel_rows_f32": [_p, _p, _p, _i, _i, _i, _i, _p],
    "aid_vote_f32": [_p, _p, _p, _p, _p, _i, _i, _i, _p],
    "predict_forest_binned": [_p, _p, _p, _p, _p, _ll, _i, _i, _i, _i, _f, _i, _p],
    "predict_forest_rows": [_p, _p, _p, _p, _p, _p, _ll, _i, _i, _i, _i, _f, _i, _p],
    "bin_rows": [_p, _p, _p, _ll, _i, _i, _p],
    "build_histogram_rows": [_p, _p, _p, _p, _p, _p, _p, _p, _ll, _i, _i, _i, _i, _i, _p],
}


def load(path: Path) -> ctypes.CDLL:
    """Load a kernel library and declare those of :data:`ENTRY_POINTS`
    that it defines."""
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        if hasattr(cdll, name):
            fn = getattr(cdll, name)
            fn.argtypes, fn.restype = argtypes, _i
    return cdll


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_fused_stage1_bf16(q: torch.Tensor, t: torch.Tensor, out: torch.Tensor) -> None:
    """q [B, DA], t [DA, N_pad] bf16 (DA <= 256), out [B, N_pad/128] f32,
    on the wgmma kernel;
    the launcher works out the padded depth and the ring from DA.  Besides
    CUDA errors it returns -1 (``cuTensorMapEncodeTiled`` not found) and
    -1000 - CUresult (tensor map refused)."""
    err = lib().fused_stage1_bf16(q.data_ptr(), t.data_ptr(), out.data_ptr(), q.shape[0],
                                  q.shape[1], t.shape[1], t.device.index, _stream(t))
    _check(err, "fused_stage1_bf16")


def launch_fused_stage1_fma(q: torch.Tensor, t: torch.Tensor, out: torch.Tensor) -> None:
    """q [B, DA], t [DA, N_pad], both f32 or both bf16, out [B, N_pad/128]
    f32, on the CUDA-core FMA kernel (``fused_stage1_fma_kernel<T>``).  The
    launcher returns cudaErrorInvalidValue when the query tile of DA rows
    does not fit in shared memory."""
    fn = lib().fused_stage1_f32 if q.dtype == torch.float32 else lib().fused_stage1_bf16_fma
    err = fn(q.data_ptr(), t.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1], t.shape[1],
             t.device.index, _stream(t))
    _check(err, "fused_stage1_fma")


def launch_peel_rows(x: torch.Tensor, rounds: int, vals: torch.Tensor,
                     cols: torch.Tensor) -> None:
    """x [B, M] f32, 16-byte aligned -> vals [B, rounds, M/128] f32, cols
    int32 (same shape)."""
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


def launch_predict_forest(x: torch.Tensor, edges: torch.Tensor | None, model: torch.Tensor,
                          n_trees: int, fold_end: torch.Tensor, base: torch.Tensor,
                          out: torch.Tensor, depth: int, inv: float) -> None:
    """x uint8 bins [N, F] (``edges`` None) or float32 rows [N, F] with
    ``edges`` f32 [F, 256] (non-decreasing, +inf pads); model int32 [ceil(T /
    32), 2^(depth + 1), 32], the slices of ``ops/forest.py``; fold_end int32
    and base f32 [n_folds] -> out f32 [N], the fold sum times ``inv``."""
    args = (model.data_ptr(), fold_end.data_ptr(), base.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], n_trees, fold_end.shape[0], depth, inv, x.device.index,
            _stream(x))
    if edges is None:
        _check(lib().predict_forest_binned(x.data_ptr(), *args), "predict_forest_binned")
    else:
        _check(lib().predict_forest_rows(x.data_ptr(), edges.data_ptr(), *args),
               "predict_forest_rows")


def launch_bin_rows(x: torch.Tensor, edges: torch.Tensor, out: torch.Tensor) -> None:
    """x float32 rows [N, F] (16-byte aligned), edges f32 [F, 256] (non-decreasing,
    +inf pads) -> out uint8 [N, F] bins (``csrc/forest_kernels.cu::bin_rows``)."""
    err = lib().bin_rows(x.data_ptr(), edges.data_ptr(), out.data_ptr(), x.shape[0],
                         x.shape[1], x.device.index, _stream(x))
    _check(err, "bin_rows")


def launch_build_histogram(rows: torch.Tensor, n_feat: int, vals: torch.Tensor,
                           vmax: torch.Tensor, order: torch.Tensor, start: torch.Tensor,
                           pre: torch.Tensor, acc: torch.Tensor, out: torch.Tensor,
                           n_bins: int) -> None:
    """rows uint8 [N, P] (P the features rounded up to 32, zero pads, 16-byte
    aligned), vals f32 [N, 3], vmax f32 [3] (each column's largest |val| over
    all N rows), order int32 (the row list), start int64 [n_keys] and pre int64
    [n_keys + 1] (key k's rows are order[start[k] + j], j < pre[k + 1] -
    pre[k]); acc int64 [n_keys, n_feat, n_bins, 3] scratch -> out f32 of that
    shape (``csrc/hist_kernels.cu``)."""
    err = lib().build_histogram_rows(rows.data_ptr(), vals.data_ptr(), vmax.data_ptr(),
                                     order.data_ptr(), start.data_ptr(), pre.data_ptr(),
                                     acc.data_ptr(), out.data_ptr(), rows.shape[0],
                                     rows.shape[1], n_feat, start.shape[0], n_bins,
                                     rows.device.index, _stream(rows))
    _check(err, "build_histogram_rows")
