"""The numbers that decide ``correct``.  Every number is a gap, 0 for a
perfect match; a run is correct when each is at or below its limit
(``benchmark/limits/<cell>.json``).

Serving (a served list is judged by the reference's scores of the session):

- ``model_gap``: over the sampled model-route sessions and the three event
  types' lists, the widest ``s_(j) - s(served_j)``, where ``s_(j)`` is the
  reference's j-th best catalog score, in units of the standard deviation of
  the session's catalog scores.  An id outside the catalog or repeated in a
  list reads infinite.
- ``model_misrank``: over the same lists, the share of served (rank j, id)
  pairs whose reference score lies further than :data:`MISRANK_TOL`
  standard deviations of the session's scores from the reference's j-th
  best, below or above it (an invalid list counts every pair).
  ``model_gap`` sees one far-off id; this sees the order and the set: a
  list in the wrong order, or the top of a part of the catalog, misranks
  most of its pairs.
- ``recency_gap``: ``model_gap``'s shortfall over the recency-route
  sessions, with the aid-weight sums in float64, in units of the session's
  best sum.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Above the program's own resolution (its packed key keeps 16 bits of the
# shifted score) and below the usual gap between neighbouring top-20 scores
# of a ~2M catalog.  Readings on an H100 at full size: sound runs misrank
# 0.7-8% of pairs at 0.002, at most 0.5% at 0.02; lists reversed, shuffled
# or taken from half the catalog misrank 86-94% at 0.02.
MISRANK_TOL = 0.02


def model_gap(lists: list[np.ndarray], scores: torch.Tensor) -> float:
    """``lists``: the served lists of one session (one per event type);
    ``scores``: the reference's catalog scores [N] of the session.  The
    widest shortfall of a served id's score below the j-th best score at
    its rank j, in standard deviations of the session's scores."""
    n = scores.shape[0]
    k = max(len(x) for x in lists)
    best = torch.topk(scores, k).values.double()
    unit = float(scores.double().std())
    out = 0.0
    for x in lists:
        x = np.asarray(x, np.int64)
        if len(np.unique(x)) != len(x) or x.min() < 0 or x.max() >= n:
            return math.inf
        got = scores[torch.as_tensor(x, device=scores.device)].double()
        out = max(out, float((best[:len(x)] - got).max()) / unit)
    return out


def misranked(lists: list[np.ndarray], scores: torch.Tensor) -> tuple[int, int]:
    """The served (rank j, id) pairs of ``lists`` whose score lies further
    than :data:`MISRANK_TOL` standard deviations of the session's scores
    from the reference's j-th best, and the number of pairs."""
    n = scores.shape[0]
    k = max(len(x) for x in lists)
    best = torch.topk(scores, k).values.double()
    unit = float(scores.double().std())
    count = pairs = 0
    for x in lists:
        x = np.asarray(x, np.int64)
        pairs += len(x)
        if len(np.unique(x)) != len(x) or x.min() < 0 or x.max() >= n:
            count += len(x)
            continue
        off = (best[:len(x)] - scores[torch.as_tensor(x, device=scores.device)].double()).abs()
        count += int((off > MISRANK_TOL * unit).sum())
    return count, pairs


def recency_gap(lists: list[np.ndarray], ids: np.ndarray, sums: np.ndarray) -> float:
    """``ids``/``sums``: the session's aids and their float64 weight sums; a
    served id the session lacks weighs 0."""
    weight = dict(zip(ids.tolist(), sums.tolist()))
    best = np.sort(sums)[::-1]
    out = 0.0
    for x in lists:
        x = [int(a) for a in x]
        if len(set(x)) != len(x) or len(x) > len(best):
            return math.inf
        served = np.array([weight.get(a, 0.0) for a in x])
        out = max(out, float(np.max(best[:len(x)] - served) / best[0]))
    return out

