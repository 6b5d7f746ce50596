"""The GBDT histogram: node x feature x bin sums of (grad, hess, weight) (K5).

Port of ``otto_tpu/models/gbdt.py::_mm_hist`` (:109) and of the scatter
branch of ``_grow_tree_impl`` (:233-266).  In the JAX package both are XLA
programs (the first a one-hot matmul on the MXU through a bf16 hi/lo pair),
not Pallas kernels.  Here :func:`node_histograms` launches a hand-written
CUDA kernel (``csrc/hist_kernels.cu``) on CUDA tensors and runs the plain
twin on CPU tensors::

    hist[k, f, b, c] = sum_r [key_r = k] [binned_rf = b] vals_rc

The rows of key k are named by a row list: ``order[start[k] + j]`` for ``j <
pre[k + 1] - pre[k]``.  The GBDT keeps such a list grouped by tree node across
the levels of a tree, so the kernel reads a node's rows where they lie, with
no sort and no gather; :func:`build_histogram` takes one key a row instead
(a key outside ``[0, n_keys)`` adds nothing) and makes the list with one
sort.  A bin of ``n_bins`` or more adds nothing.

The kernel sums in integer fixed point (a power-of-two scale a column, set by
the number of rows and the largest |val| of all rows, and integer atomics),
so it gives the same bits on every launch; the twin sums in float64 with
``index_add_`` and rounds once to float32.  Both return the exact sum rounded
once where the values are dyadic (multiples of a power of two, as in the
tests), and agree to about 2^-24 of the column's sum of |vals| otherwise;
:func:`_fixed_point_histogram` repeats the kernel's arithmetic in plain torch
and equals it bit for bit on any vals (a test helper: the CPU path keeps the
float64 twin).  The kernel reads the bins from a copy whose rows are padded
to a multiple of 32 bytes (:func:`pad_rows`, made once per fit).
"""

from __future__ import annotations

import math

import torch

from otto_tpu_torch.ops import _kernels

MAX_KEYS = 2048  # the kernel's limit (a depth-12 tree builds at most 1,024 left children)
MAX_BINS = 256
ROW_ALIGN = 32  # the kernel reads a row's features 32 at a time
# (row, feature) entries the twin indexes at a time
_TWIN_ENTRIES = 1 << 22


def _build_histogram_reference(binned: torch.Tensor, key: torch.Tensor, vals: torch.Tensor,
                               n_keys: int, n_bins: int, reduce=None) -> torch.Tensor:
    """Plain-torch twin: ``index_add_`` of each (row, feature)'s vals at the
    flat key ``(key F + f) n_bins + b`` in float64, rounded once to float32,
    over the rows whose key is in the grid; a bin past it goes to a spare
    slot past the end.  Rows go in blocks so the index tensors stay small.
    ``reduce`` (if given) is applied in place to the float64 sums [n_keys
    * F * n_bins + 1, 3] before the rounding."""
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
    if reduce is not None:
        reduce(out)
    return out[:size].to(torch.float32).reshape(n_keys, F, n_bins, 3)


def _scale_exp(n_rows: int, vmax: float) -> int:
    """The kernel's fixed-point scale: the largest s with n_rows vmax 2^s <=
    2^61, in double (0 where vmax is 0 or not finite)."""
    b = float(n_rows) * float(vmax)
    if not b > 0.0 or math.isinf(b):
        return 0
    return 61 - math.frexp(b)[1]


def _fixed_point_histogram(binned: torch.Tensor, key: torch.Tensor, vals: torch.Tensor,
                           n_keys: int, n_bins: int, scale_rows: int | None = None,
                           vmax=None, reduce=None) -> torch.Tensor:
    """The kernel's arithmetic in plain torch (a test helper): each val
    rounded to an int64 ``rn(v 2^s_c)`` with the kernel's scale (over all N
    rows of ``vals``, or ``scale_rows`` rows of largest magnitudes ``vmax``),
    summed exactly with ``index_add_`` (``reduce``, if given, applied in place
    to the int64 sums), then ``float32(sum) 2^-s_c``.  Bit-equal to the kernel
    on any vals."""
    N, F = binned.shape
    size = n_keys * F * n_bins
    if vmax is None:
        vmax = vals.abs().amax(dim=0) if N else torch.zeros(3)
    exps = [_scale_exp(N if scale_rows is None else scale_rows, v)
            for v in torch.as_tensor(vmax).tolist()]
    q = torch.stack([torch.round(vals[:, c].double() * 2.0 ** exps[c]) for c in range(3)],
                    dim=1).to(torch.int64)
    k = key.long()
    ok = (k >= 0) & (k < n_keys)
    flat = (k[:, None] * F + torch.arange(F, device=binned.device)) * n_bins + binned.long()
    flat = torch.where(ok[:, None] & (binned.long() < n_bins), flat, size).reshape(-1)
    acc = torch.zeros((size + 1, 3), dtype=torch.int64, device=binned.device)
    acc.index_add_(0, flat, q[:, None, :].expand(-1, F, 3).reshape(-1, 3))
    if reduce is not None:
        reduce(acc)
    scale = torch.tensor([2.0 ** -e for e in exps], dtype=torch.float64, device=binned.device)
    out = (acc[:size].to(torch.float32).double() * scale).to(torch.float32)
    return out.reshape(n_keys, F, n_bins, 3)


def pad_rows(binned: torch.Tensor) -> torch.Tensor:
    """The kernel's copy of uint8 bins [N, F]: uint8 [N, P], P = F rounded up
    to a multiple of 32, the features first and zeros after."""
    N, F = binned.shape
    rows = torch.zeros((N, -(-F // ROW_ALIGN) * ROW_ALIGN), dtype=torch.uint8,
                       device=binned.device)
    rows[:, :F] = binned
    return rows


def list_keys(order: torch.Tensor, start: torch.Tensor, pre: torch.Tensor,
              n_rows: int) -> torch.Tensor:
    """The key of each of ``n_rows`` rows under a row list (int32 [n_rows],
    -1 for a row no key lists)."""
    n_keys = start.shape[0]
    counts = pre[1:] - pre[:-1]
    total = int(pre[-1])
    k = torch.repeat_interleave(torch.arange(n_keys, device=order.device), counts)
    pos = torch.repeat_interleave(start - pre[:-1], counts) + torch.arange(total,
                                                                           device=order.device)
    key = torch.full((n_rows,), -1, dtype=torch.int32, device=order.device)
    key[order[pos].long()] = k.to(torch.int32)
    return key


def node_histograms(rows: torch.Tensor, n_feat: int, vals: torch.Tensor, vmax: torch.Tensor,
                    order: torch.Tensor, start: torch.Tensor, pre: torch.Tensor,
                    n_bins: int, *, scale_rows: int | None = None,
                    reduce=None) -> torch.Tensor:
    """Histogram float32 [n_keys, n_feat, n_bins, 3] of the listed rows,
    key by key, all tensors on one device.

    rows uint8 [N, P] (:func:`pad_rows`: the first ``n_feat`` columns are the
    bins); vals float32 [N, 3] (finite); vmax float32 [3], each column's
    largest |val| over all N rows, and ``scale_rows`` (default N): together
    they set the kernel's scale, so that every level of a tree shares it;
    order int32, the row list; start int64 [n_keys] and pre int64 [n_keys +
    1]: key k's rows are ``order[start[k] + j]`` for ``j < pre[k + 1] -
    pre[k]``, and ``pre[0]`` is 0.

    ``reduce`` is called once, in place, on the unrounded sums between the
    sums and the rounding to float32: the kernel's int64 fixed-point
    accumulators on the card, the twin's float64 sums on the CPU.  A
    data-parallel level passes an all-reduce over its ranks there, with the
    whole fit's ``scale_rows`` and ``vmax``: each rank then quantises as one
    device would, the integer sum is exact in any order, and the result has
    the bits of one launch over every rank's rows (the twin's float64 sums
    agree with its one-process sums to float64 rounding).

    On CUDA tensors this launches the histogram kernel (n_keys <= 2,048,
    n_bins <= 256; anything else raises); on CPU tensors it gives each row its
    key (:func:`list_keys`) and runs :func:`_build_histogram_reference`.
    """
    if rows.ndim != 2 or rows.dtype != torch.uint8:
        raise TypeError(f"node_histograms: rows must be uint8 [N, P], got {rows.dtype} "
                        f"{tuple(rows.shape)}")
    N, P = rows.shape
    if not 1 <= n_feat <= P or P % ROW_ALIGN or P - n_feat >= ROW_ALIGN:
        raise ValueError(f"node_histograms: rows of {P} bytes for {n_feat} features; "
                         f"pad_rows makes them")
    if vals.dtype != torch.float32 or tuple(vals.shape) != (N, 3):
        raise TypeError(f"node_histograms: vals must be float32 [{N}, 3], got {vals.dtype} "
                        f"{tuple(vals.shape)}")
    n_keys = start.shape[0]
    if (order.dtype != torch.int32 or order.ndim != 1 or start.dtype != torch.int64
            or pre.dtype != torch.int64 or tuple(pre.shape) != (n_keys + 1,)
            or vmax.dtype != torch.float32 or tuple(vmax.shape) != (3,)):
        raise TypeError("node_histograms: order int32 [M], start int64 [n_keys], pre int64 "
                        "[n_keys + 1] and vmax float32 [3] expected")
    if len({t.device for t in (rows, vals, vmax, order, start, pre)}) != 1:
        raise ValueError("node_histograms: tensors on different devices")
    if not (1 <= n_keys <= MAX_KEYS and 1 <= n_bins <= MAX_BINS):
        raise ValueError(f"node_histograms: n_keys {n_keys} (<= {MAX_KEYS}), n_bins {n_bins} "
                         f"(<= {MAX_BINS})")
    scale_rows = N if scale_rows is None else int(scale_rows)
    if scale_rows < N:
        raise ValueError(f"node_histograms: scale_rows {scale_rows} is below the {N} rows")
    if rows.device.type == "cpu":
        key = list_keys(order, start, pre, N)
        return _build_histogram_reference(rows[:, :n_feat], key, vals, n_keys, n_bins, reduce)
    if rows.device.type != "cuda":
        raise ValueError(f"node_histograms: no kernel for device {rows.device}")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("node_histograms: the kernel takes contiguous, 16-byte aligned rows")
    out = torch.empty((n_keys, n_feat, n_bins, 3), dtype=torch.float32, device=rows.device)
    if N == 0 and reduce is None:
        return out.zero_()
    acc = torch.empty((n_keys, n_feat, n_bins, 3), dtype=torch.int64, device=rows.device)
    _kernels.launch_build_histogram(rows, n_feat, vals.contiguous(), vmax.contiguous(),
                                    order.contiguous(), start.contiguous(), pre.contiguous(),
                                    acc, out, n_bins, max(scale_rows, 1), reduce)
    node_histograms.launches += 1
    return out


node_histograms.launches = 0  # kernel launches made by this wrapper


def build_histogram(binned: torch.Tensor, key: torch.Tensor, vals: torch.Tensor,
                    n_keys: int, n_bins: int) -> torch.Tensor:
    """Histogram float32 [n_keys, F, n_bins, 3] of uint8 bins [N, F], int32
    keys [N] and float32 vals [N, 3] (finite), all on one device.

    On CUDA tensors this lists the rows by key (one ``torch.sort``), pads
    them (:func:`pad_rows`) and calls :func:`node_histograms`, which launches
    the kernel (n_keys <= 2,048, n_bins <= 256; anything else raises); on CPU
    tensors it runs :func:`_build_histogram_reference`.
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
    key_sorted, order = torch.sort(key)
    seg = torch.searchsorted(key_sorted, torch.arange(n_keys + 1, dtype=torch.int32,
                                                      device=key.device))
    vmax = vals.abs().amax(dim=0) if N else torch.zeros(3, device=vals.device)
    return node_histograms(pad_rows(binned), F, vals, vmax, order.to(torch.int32), seg[:-1],
                           seg - seg[0], n_bins)
