"""Per-session aid-vote aggregation, fused.

Port of ``otto_tpu/ops/pallas_sessions.py``.  The plain path builds the
pairwise equality tensor ``eq [S, L, L]`` in device memory before reducing
it; :func:`aid_vote_aggregate` launches the hand-written CUDA kernel
``aid_vote_kernel`` (``csrc/session_kernels.cu``), which computes per
session row, with the ``[L, L]`` tile never leaving the chip:

- ``agg[i]      = sum_j weights[j] * (aids[i] == aids[j])``  (the Counter sum)
- ``first[i]    = no j < i with aids[j] == aids[i]``          (first occurrence)
- ``firstpos[i] = min j with aids[j] == aids[i]``             (stable tie-break)

Padding positions arrive with ``aids == -1`` and come out as ``agg 0``,
``first 0``, ``firstpos L``.  On a CPU tensor the wrapper runs the plain
twin :func:`_vote_reference`.  The reference's ``session_tile`` padding (a
TPU block shape) has no counterpart: one CUDA block serves one row.
"""

from __future__ import annotations

import torch

from otto_tpu_torch.ops import _kernels

MAX_L = 1024  # one thread per position, one block per row


def _vote_reference(aids: torch.Tensor, weights: torch.Tensor):
    """Plain-torch twin of the vote kernel over the ``[S, L, L]`` equality
    tensor (sums by einsum)."""
    L = aids.shape[1]
    eq = (aids[:, :, None] == aids[:, None, :]) & (aids >= 0)[:, :, None]
    agg = torch.einsum("sij,sj->si", eq.to(torch.float32), weights)
    lower = torch.tril(torch.ones((L, L), dtype=torch.bool, device=aids.device), diagonal=-1)
    dup = (eq & lower).any(dim=2)
    first = (~dup & (aids >= 0)).to(torch.int32)
    col = torch.arange(L, dtype=torch.int32, device=aids.device)
    firstpos = torch.where(eq, col, L).amin(dim=2).to(torch.int32)
    return agg, first, firstpos


def aid_vote_aggregate(aids: torch.Tensor, weights: torch.Tensor):
    """Fused per-session vote aggregation of aids int32 [S, L] (padding -1)
    and weights float32 [S, L].

    Returns (agg float32 [S, L], first int32 [S, L], firstpos int32 [S, L]).
    On a CUDA tensor this launches ``aid_vote_kernel`` (int32/float32,
    contiguous, L <= 1024; anything else raises); on a CPU tensor it runs
    :func:`_vote_reference`.
    """
    if aids.ndim != 2 or aids.shape != weights.shape:
        raise ValueError(f"aid_vote_aggregate: shapes {tuple(aids.shape)} and "
                         f"{tuple(weights.shape)}; both must be [S, L]")
    if aids.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"aid_vote_aggregate: dtypes {aids.dtype}, {weights.dtype}; "
                        "must be int32 and float32")
    if aids.device != weights.device:
        raise ValueError("aid_vote_aggregate: operands on different devices")
    if aids.device.type == "cpu":
        return _vote_reference(aids, weights)
    if aids.device.type != "cuda":
        raise ValueError(f"aid_vote_aggregate: no kernel for device {aids.device}")
    S, L = aids.shape
    if L > MAX_L:
        raise ValueError(f"aid_vote_aggregate: the kernel takes L <= {MAX_L}, got {L}")
    if not (aids.is_contiguous() and weights.is_contiguous()):
        raise ValueError("aid_vote_aggregate: the kernel takes contiguous tensors")
    agg = torch.empty((S, L), dtype=torch.float32, device=aids.device)
    first = torch.empty((S, L), dtype=torch.int32, device=aids.device)
    firstpos = torch.empty((S, L), dtype=torch.int32, device=aids.device)
    if S and L:
        _kernels.launch_aid_vote(aids, weights, agg, first, firstpos)
        aid_vote_aggregate.launches += 1
    return agg, first, firstpos


aid_vote_aggregate.launches = 0  # kernel launches made by this wrapper


def per_aid_weight_top_fused(aids: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor,
                             k: int = 20):
    """Counterpart of ``per_aid_weight_top_pallas``: the ranking of
    :func:`otto_tpu_torch.ops.sessions.per_aid_weight_top` (sums by
    :func:`aid_vote_aggregate`, score desc, first position asc) with the
    Pallas version's padding.

    Returns ([S, k] aids int32 padded -1, [S, k] summed weights padded 0.0).
    """
    from otto_tpu_torch.ops.sessions import per_aid_weight_top  # it imports this module

    picked, score = per_aid_weight_top(aids, weights, mask, k)
    return picked, torch.where(picked >= 0, score, 0.0)
