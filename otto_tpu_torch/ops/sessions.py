"""Batched fixed-shape session ranking on torch tensors.

Port of ``otto_tpu/ops/sessions.py``.  Every reference model iterates Python
dicts per session:

- ``list(dict.fromkeys(aids[::-1]))`` — distinct aids, most-recent first
  (src/covisitation/inference.py:147)
- ``list(Counter(aids).keys())[:20]`` — distinct aids in first-seen order
  (src/baseline/aid_frequency.py:46)
- ``np.logspace(0.1, 1, n, base=2) - 1`` recency weights x per-type
  coefficients summed per aid, ranked descending
  (src/baseline/aid_weight.py:40-46)

Here each is a masked O(L^2) comparison over packed ``[S, L]`` tensors.
Ties break as in the reference — first-occurrence position ascending.

The per-aid weight sums (:func:`per_aid_weight_top`, and through it
:func:`recency_weighted_top_aids`) go through
:func:`otto_tpu_torch.ops.fused_sessions.aid_vote_aggregate`: on the card
the hand-written vote kernel, on the CPU its ``[S, L, L]`` plain twin.
On a CPU tensor :func:`recency_weighted_top_aids` walks the sessions in
chunks, which bounds the twin's equality tensor; on the card the whole batch
is one launch.  The result does not depend on the chunk size.
"""

from __future__ import annotations

import torch

from otto_tpu_torch.ops.fused_sessions import aid_vote_aggregate
from otto_tpu_torch.ops.multiset import lexsort_rows

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


def last_occurrence(aids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Bool [S, L]: True where this position is the last occurrence of its aid."""
    eq = _eq_matrix(aids, mask)
    L = aids.shape[1]
    later = torch.triu(torch.ones((L, L), dtype=torch.bool, device=aids.device), diagonal=1)
    dup = (eq & later[None]).any(dim=2)
    return mask & ~dup


def _rank_select(aids: torch.Tensor, score: torch.Tensor, tie_pos: torch.Tensor, k: int):
    """Top-k aids by (score desc, tie_pos asc).  Returns ([S,k] aids padded -1,
    [S,k] scores padded NEG)."""
    order = lexsort_rows(-score, tie_pos)[:, :k]
    picked = torch.gather(aids, 1, order)
    picked_score = torch.gather(score, 1, order)
    picked = torch.where(picked_score > NEG / 2, picked, -1)
    return picked.to(torch.int32), picked_score


def distinct_recent_first(aids: torch.Tensor, mask: torch.Tensor, k: int = 20) -> torch.Tensor:
    """Distinct session aids ordered most-recent-last-occurrence first —
    ``list(dict.fromkeys(aids[::-1]))[:k]``.  Returns [S, k] padded with -1."""
    pos = torch.arange(aids.shape[1], dtype=torch.float32, device=aids.device)[None, :]
    score = torch.where(last_occurrence(aids, mask), pos, NEG)
    picked, _ = _rank_select(aids, score, (-pos).expand(aids.shape), k)
    return picked


def distinct_first_seen(aids: torch.Tensor, mask: torch.Tensor, k: int = 20) -> torch.Tensor:
    """Distinct session aids in first-seen order — ``list(Counter(a).keys())[:k]``.
    Returns [S, k] padded with -1."""
    pos = torch.arange(aids.shape[1], dtype=torch.float32, device=aids.device)[None, :]
    score = torch.where(first_occurrence(aids, mask), -pos, NEG)
    picked, _ = _rank_select(aids, score, pos.expand(aids.shape), k)
    return picked


def per_aid_weight_top(aids: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor,
                       k: int = 20):
    """Generic per-aid weight aggregation + top-k (the Counter pattern):
    sums ``weights`` over equal aids, ranks descending, first-insertion
    tie-break.  The sums come from :func:`aid_vote_aggregate`.  Returns
    ([S,k] aids padded -1, [S,k] summed weights padded NEG)."""
    masked_aids = torch.where(mask, aids, -1).to(torch.int32)
    agg, first, firstpos = aid_vote_aggregate(
        masked_aids, torch.where(mask, weights, 0.0).to(torch.float32))
    score = torch.where(first > 0, agg, NEG)
    return _rank_select(masked_aids, score, firstpos, k)


def recency_weights(lengths: torch.Tensor, true_pos: torch.Tensor, mask: torch.Tensor,
                    lo: float = 0.1, hi: float = 1.0) -> torch.Tensor:
    """``np.logspace(lo, hi, n, base=2) - 1`` evaluated at each event's true
    position (src/baseline/aid_weight.py:40); a one-event session gets
    ``2^lo - 1``."""
    n = lengths[:, None].to(torch.float32).clamp(min=1.0)
    frac = torch.where(n > 1, true_pos / (n - 1.0).clamp(min=1.0), 0.0)
    w = torch.exp2(lo + (hi - lo) * frac) - 1.0
    return torch.where(mask, w, 0.0)


def recency_event_weights(aids, types, mask, lengths, type_coefficients, lo: float = 0.1,
                          hi: float = 1.0) -> torch.Tensor:
    """Each event's recency weight at its true position times its type's
    coefficient, float32 [S, L] (0 at padding).  Packed tails (keep='last')
    are supported: the true position is rebuilt from the clip offset."""
    L = aids.shape[1]
    clipped = mask.sum(dim=1)
    offset = (lengths - clipped)[:, None].to(torch.float32)  # events dropped from the front
    true_pos = offset + torch.arange(L, dtype=torch.float32, device=aids.device)[None, :]
    w = recency_weights(lengths, true_pos, mask, lo=lo, hi=hi)
    return w * type_coefficients[types.long()]


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
    recency weight x type coefficient (:func:`recency_event_weights`), ranked
    descending with first-insertion tie-break (:func:`per_aid_weight_top`).
    Runs on the tensors' device: on the CPU ``chunk`` sessions at a time (the
    twin's [chunk, L, L] equality tensor bounds memory), on the card the
    whole batch in one launch of the vote kernel.
    Returns ([S,k] aids int32 padded -1, [S,k] float32 weights padded NEG).
    """
    S = aids.shape[0]
    if S == 0:
        dev = aids.device
        return (torch.empty((0, k), dtype=torch.int32, device=dev),
                torch.empty((0, k), dtype=torch.float32, device=dev))
    step = chunk if aids.device.type == "cpu" else S
    tops, scores = [], []
    for s0 in range(0, S, step):
        sl = slice(s0, s0 + step)
        w = recency_event_weights(aids[sl], types[sl], mask[sl], lengths[sl], type_coefficients,
                                  lo, hi)
        t, s = per_aid_weight_top(aids[sl], w, mask[sl], k)
        tops.append(t)
        scores.append(s)
    return torch.cat(tops), torch.cat(scores)
