"""Batched fixed-shape session ranking on torch tensors.

Port of ``otto_tpu/ops/sessions.py:32-143`` (plain torch; XLA in the
reference).  The reference model iterates Python dicts per session:
``np.logspace(0.1, 1, n, base=2) - 1`` recency weights x per-type
coefficients summed per aid, ranked descending
(src/baseline/aid_weight.py:40-46).  Here it is a masked O(L^2) comparison
over packed ``[S, L]`` tensors: the pairwise aid-equality tensor is built
once and reused for first-occurrence detection and per-aid weight
aggregation.  Ties break as in the reference — first-occurrence position
ascending.

The equality tensor is ``[S, L, L]``, so :func:`recency_weighted_top_aids`
walks the sessions in chunks; the result does not depend on the chunk size.
"""

from __future__ import annotations

import torch

NEG = -3.4e38


def _eq_matrix(aids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[S, L, L] pairwise equality, masked to valid positions."""
    eq = aids[:, :, None] == aids[:, None, :]
    valid = mask[:, :, None] & mask[:, None, :]
    return eq & valid


def first_occurrence(aids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Bool [S, L]: True where this position is the first occurrence of its aid."""
    eq = _eq_matrix(aids, mask)
    L = aids.shape[1]
    earlier = torch.tril(torch.ones((L, L), dtype=torch.bool, device=aids.device), diagonal=-1)
    dup = (eq & earlier[None]).any(dim=2)
    return mask & ~dup


def _rank_select(aids: torch.Tensor, score: torch.Tensor, tie_pos: torch.Tensor, k: int):
    """Top-k aids by (score desc, tie_pos asc).  Returns ([S,k] aids padded -1,
    [S,k] scores padded NEG)."""
    # lexicographic sort by two stable passes: the minor key first
    order = torch.sort(tie_pos, dim=1, stable=True).indices
    order = torch.gather(order, 1, torch.sort(torch.gather(-score, 1, order), dim=1,
                                              stable=True).indices)
    picked = torch.gather(aids, 1, order[:, :k])
    picked_score = torch.gather(score, 1, order[:, :k])
    picked = torch.where(picked_score > NEG / 2, picked, -1)
    return picked.to(torch.int32), picked_score


def recency_weights(lengths: torch.Tensor, true_pos: torch.Tensor, mask: torch.Tensor,
                    lo: float = 0.1, hi: float = 1.0) -> torch.Tensor:
    """``np.logspace(lo, hi, n, base=2) - 1`` evaluated at each event's true
    position (src/baseline/aid_weight.py:40); a one-event session gets
    ``2^lo - 1``."""
    n = lengths[:, None].to(torch.float32).clamp(min=1.0)
    frac = torch.where(n > 1, true_pos / (n - 1.0).clamp(min=1.0), 0.0)
    w = torch.exp2(lo + (hi - lo) * frac) - 1.0
    return torch.where(mask, w, 0.0)


def _recency_top_chunk(aids, types, mask, lengths, type_coefficients, k, lo, hi):
    S, L = aids.shape
    clipped = mask.sum(dim=1)
    offset = (lengths - clipped)[:, None].to(torch.float32)  # events dropped from the front
    col = torch.arange(L, dtype=torch.float32, device=aids.device)[None, :]
    true_pos = offset + col
    w = recency_weights(lengths, true_pos, mask, lo=lo, hi=hi)
    w = w * type_coefficients[types.long()]

    eq = _eq_matrix(aids, mask)
    agg = torch.einsum("sij,sj->si", eq.to(torch.float32), w)
    first = first_occurrence(aids, mask)
    # first-occurrence position of each aid (for the stable tie-break)
    first_pos = torch.where(eq, col[:, None, :], float(L)).amin(dim=2)
    score = torch.where(first, agg, NEG)
    return _rank_select(aids, score, first_pos, k)


def recency_weighted_top_aids(
    aids: torch.Tensor,
    types: torch.Tensor,
    mask: torch.Tensor,
    lengths: torch.Tensor,
    type_coefficients: torch.Tensor,
    k: int = 20,
    lo: float = 0.1,
    hi: float = 1.0,
    chunk: int = 1024,
):
    """The aid-weight model (src/baseline/aid_weight.py:34-46): per-aid sum of
    recency weight x type coefficient, ranked descending with first-insertion
    tie-break.  Supports packed tails (keep='last'): the true event position is
    reconstructed from the clip offset.  Runs on the tensors' device, ``chunk``
    sessions at a time (the [chunk, L, L] equality tensor bounds memory).
    Returns ([S,k] aids int32 padded -1, [S,k] float32 weights padded NEG).
    """
    tops, scores = [], []
    for s0 in range(0, aids.shape[0], chunk):
        sl = slice(s0, s0 + chunk)
        t, s = _recency_top_chunk(aids[sl], types[sl], mask[sl], lengths[sl],
                                  type_coefficients, k, lo, hi)
        tops.append(t)
        scores.append(s)
    if not tops:
        dev = aids.device
        return (torch.empty((0, k), dtype=torch.int32, device=dev),
                torch.empty((0, k), dtype=torch.float32, device=dev))
    return torch.cat(tops), torch.cat(scores)
