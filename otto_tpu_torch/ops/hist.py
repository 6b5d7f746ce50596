"""The GBDT histogram: node x feature x bin sums of (grad, hess, weight) (K5).

Port of ``otto_tpu/models/gbdt.py::_mm_hist`` (:109) and of the scatter
branch of ``_grow_tree_impl`` (:233-266).  In the JAX package both are XLA
programs (the first a one-hot matmul on the MXU through a bf16 hi/lo pair),
not Pallas kernels.  Here :func:`build_histogram` launches a hand-written
CUDA kernel (``csrc/hist_kernels.cu``) on a CUDA tensor and runs its plain
twin on a CPU tensor::

    hist[k, f, b, c] = sum_r [key_r = k] [binned_rf = b] vals_rc

A row whose key is outside ``[0, n_keys)`` adds nothing (the GBDT marks a
right-going row with -1), and so does a bin of ``n_bins`` or more.

The kernel sums in integer fixed point (a power-of-two scale a column and a
launch, 64-bit atomics), so it gives the same bits on every launch; the twin
sums in float64 with ``index_add_`` and rounds once to float32.  Both return
the exact sum rounded once where the values are dyadic (multiples of a power
of two, as in the tests), and agree to about 2^-24 of the column's sum of
|vals| otherwise.  Before the kernel the wrapper groups the rows by key
(``torch.sort``), so that a stretch of rows adds into one key's histogram.
"""

from __future__ import annotations

import torch

from otto_tpu_torch.ops import _kernels

MAX_KEYS = 2048  # the kernel's limit (a depth-12 tree builds at most 1,024 left children)
MAX_BINS = 256
# (row, feature) entries the twin indexes at a time
_TWIN_ENTRIES = 1 << 22


def _build_histogram_reference(binned: torch.Tensor, key: torch.Tensor, vals: torch.Tensor,
                               n_keys: int, n_bins: int) -> torch.Tensor:
    """Plain-torch twin: ``index_add_`` of each (row, feature)'s vals at the
    flat key ``(key F + f) n_bins + b`` in float64, rounded once to float32,
    over the rows whose key is in the grid; a bin past it goes to a spare
    slot past the end.  Rows go in blocks so the index tensors stay small."""
    N, F = binned.shape
    size = n_keys * F * n_bins
    out = torch.zeros((size + 1, 3), dtype=torch.float64, device=binned.device)
    feat = torch.arange(F, device=binned.device)
    step = max(1, _TWIN_ENTRIES // max(F, 1))
    for r0 in range(0, N, step):
        k = key[r0:r0 + step].long()
        rows = torch.nonzero((k >= 0) & (k < n_keys))[:, 0] + r0  # the rows that add
        k = key[rows].long()
        b = binned[rows].long()
        flat = torch.where(b < n_bins, (k[:, None] * F + feat) * n_bins + b, size).reshape(-1)
        out.index_add_(0, flat, vals[rows].double()[:, None, :].expand(-1, F, 3).reshape(-1, 3))
    return out[:size].to(torch.float32).reshape(n_keys, F, n_bins, 3)


def build_histogram(binned: torch.Tensor, key: torch.Tensor, vals: torch.Tensor,
                    n_keys: int, n_bins: int) -> torch.Tensor:
    """Histogram float32 [n_keys, F, n_bins, 3] of uint8 bins [N, F], int32
    keys [N] and float32 vals [N, 3] (finite), all on one device.

    On a CUDA tensor this groups the rows by key and launches the histogram
    kernel (n_keys <= 2,048, n_bins <= 256; anything else raises); on a CPU
    tensor it runs :func:`_build_histogram_reference`.
    """
    if binned.ndim != 2 or binned.dtype != torch.uint8:
        raise TypeError(f"build_histogram: binned must be uint8 [N, F], got {binned.dtype} "
                        f"{tuple(binned.shape)}")
    N, F = binned.shape
    if key.dtype != torch.int32 or tuple(key.shape) != (N,):
        raise TypeError(f"build_histogram: key must be int32 [{N}], got {key.dtype} "
                        f"{tuple(key.shape)}")
    if vals.dtype != torch.float32 or tuple(vals.shape) != (N, 3):
        raise TypeError(f"build_histogram: vals must be float32 [{N}, 3], got {vals.dtype} "
                        f"{tuple(vals.shape)}")
    if not (key.device == vals.device == binned.device):
        raise ValueError("build_histogram: binned, key and vals on different devices")
    if not (1 <= n_keys and 1 <= n_bins <= MAX_BINS):
        raise ValueError(f"build_histogram: n_keys {n_keys}, n_bins {n_bins} (<= {MAX_BINS})")
    if binned.device.type == "cpu":
        return _build_histogram_reference(binned, key, vals, n_keys, n_bins)
    if binned.device.type != "cuda":
        raise ValueError(f"build_histogram: no kernel for device {binned.device}")
    if n_keys > MAX_KEYS or F < 1:
        raise ValueError(f"build_histogram: the kernel takes 1 <= n_keys <= {MAX_KEYS} and "
                         f"F >= 1, got {n_keys}, {F}")
    out = torch.empty((n_keys, F, n_bins, 3), dtype=torch.float32, device=binned.device)
    if N == 0:
        return out.zero_()
    key_sorted, order = torch.sort(key)
    rows = binned.index_select(0, order)
    v = vals.index_select(0, order)
    seg = torch.searchsorted(key_sorted, torch.arange(n_keys + 1, dtype=torch.int32,
                                                      device=key.device))
    vmax = vals.abs().amax(dim=0)
    acc = torch.empty((n_keys, F, n_bins, 3), dtype=torch.int64, device=binned.device)
    _kernels.launch_build_histogram(rows, v, seg, vmax, acc, out, n_bins)
    build_histogram.launches += 1
    return out


build_histogram.launches = 0  # kernel launches made by this wrapper
