"""Approximate row-wise top-k by iterative window peeling.

Port of ``otto_tpu/ops/row_topk.py``.  For ``rounds`` iterations, pop the
maximum of every 128-column window of each row; after R rounds the R*(M/128)
collected candidates contain every element that is among the top-R of its own
window, and an exact sort over that small set finishes the job.

Quality bound: a true top-k element is missed only if >= R elements of its
row exceed it *within its own 128-slot window*: P(miss) ~ C(k-1, R) *
(128/M)^R for rows whose large values are spread evenly.  ``rounds >= k``
makes the result exact.

:func:`peel_rows` launches the hand-written CUDA kernel ``peel_rows_kernel``
(``csrc/retrieval_kernels.cu``) on a CUDA tensor and runs its plain twin
:func:`peel_rows_reference` on a CPU tensor.
"""

from __future__ import annotations

import torch

from otto_tpu_torch.ops import _kernels

WINDOW = 128


def peel_rows_reference(x: torch.Tensor, rounds: int):
    """Plain-torch twin of the peel kernel (any ordered dtype, any device).

    Each round takes every window's maximum and its first column, then sets
    every slot equal to that maximum to the dtype's minimum (-inf for floats).
    """
    b, m = x.shape
    w = m // WINDOW
    fill = float("-inf") if x.dtype.is_floating_point else torch.iinfo(x.dtype).min
    x3 = x.reshape(b, w, WINDOW).clone()
    lane = torch.arange(WINDOW, device=x.device, dtype=torch.int32)
    base = torch.arange(w, device=x.device, dtype=torch.int32) * WINDOW
    vals = torch.empty((b, rounds, w), dtype=x.dtype, device=x.device)
    cols = torch.empty((b, rounds, w), dtype=torch.int32, device=x.device)
    for r in range(rounds):
        mx = x3.amax(dim=2)
        eq = x3 == mx[:, :, None]
        am = torch.where(eq, lane, WINDOW).amin(dim=2)
        vals[:, r] = mx
        cols[:, r] = base + am
        x3.masked_fill_(eq, fill)
    return vals.reshape(b, rounds * w), cols.reshape(b, rounds * w)


def peel_rows(x: torch.Tensor, rounds: int):
    """Pop the per-128-window max of each row, ``rounds`` times.

    x: [B, M] with M % 128 == 0.  Returns (vals [B, rounds*M/128] in x's
    dtype, cols [B, rounds*M/128] int32), round-major, where ``cols`` are
    column indices into x.  Peeled slots are replaced with the dtype's
    minimum, so rows with fewer than ``rounds`` live entries per window
    repeat the fill value.

    On a CUDA tensor this launches the kernel (float32 only, any
    ``rounds``; other dtypes raise); on a CPU tensor it runs
    :func:`peel_rows_reference`.
    """
    b, m = x.shape
    if m % WINDOW:
        raise ValueError(f"peel_rows: row length {m} is not a multiple of {WINDOW}")
    if rounds < 1:
        raise ValueError(f"peel_rows: rounds must be >= 1, got {rounds}")
    if x.device.type == "cpu":
        return peel_rows_reference(x, rounds)
    if x.device.type != "cuda":
        raise ValueError(f"peel_rows: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"peel_rows: the CUDA kernel takes float32, got {x.dtype}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel copies 512-byte windows with cp.async.bulk
        x = x.clone()
    w = m // WINDOW
    vals = torch.empty((b, rounds, w), dtype=torch.float32, device=x.device)
    cols = torch.empty((b, rounds, w), dtype=torch.int32, device=x.device)
    if b:
        _kernels.launch_peel_rows(x, rounds, vals, cols)
        peel_rows.launches += 1
    return vals.reshape(b, rounds * w), cols.reshape(b, rounds * w)


peel_rows.launches = 0  # kernel launches made by this wrapper


def _topk_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` semantics: descending, ties to the lower index."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def row_topk(x: torch.Tensor, k: int, rounds: int | None = None):
    """Drop-in (approximate) replacement for a row top-k.

    Returns (values [B, k], indices [B, k]) sorted descending, ties to the
    lower index.  With ``rounds >= k`` the result is exact; the default picks
    ``ceil(k * 128 / M) + 4`` rounds.  Takes an exact sort when the row is
    small or does not tile into 128-column windows.  (The reference also
    falls back when B is not a multiple of its TPU row block; the port has no
    row block.)
    """
    b, m = x.shape
    w = m // WINDOW if m % WINDOW == 0 else 0
    if rounds is None and w:
        rounds = min(-(-k * WINDOW // m) + 4, k)
    if not w or w * min(rounds, k) < k or m <= 4 * WINDOW:
        return _topk_stable(x, k)
    rounds = min(rounds, k)
    vals, cols = peel_rows(x, rounds)
    top_v, pos = _topk_stable(vals, k)
    return top_v, torch.gather(cols, 1, pos)
