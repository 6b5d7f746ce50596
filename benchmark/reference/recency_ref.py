"""The serving route for long sessions, in NumPy: the aid-weight model.

Each event weighs ``2^(lo + (hi - lo) * p / (n - 1)) - 1`` at its position
``p`` of the session's ``n`` events (``2^lo - 1`` when n is 1), times its
type's coefficient (click 1, cart 6, order 3); an aid scores the sum over
its events; the list is the aids by score descending, ties to the aid seen
first.  (The reference repo's ``src/baseline/aid_weight.py:34-46``, as the
port's docstrings quote it.)

``precision="f64"`` is the truth the served lists are judged by;
``"bf16"`` is the control: every weight rounded to bfloat16 and every
partial sum rounded to bfloat16, in event order.
"""

from __future__ import annotations

import numpy as np

TYPE_COEF = np.array([1.0, 6.0, 3.0])
LO, HI = 0.1, 1.0


def round_bf16(x) -> np.ndarray:
    """float -> the nearest bfloat16 value (ties to even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def aid_scores(aids: np.ndarray, types: np.ndarray, precision: str = "f64"):
    """(distinct aids in first-seen order, their summed weights)."""
    n = len(aids)
    frac = np.arange(n) / (n - 1) if n > 1 else np.zeros(1)
    w = (np.exp2(LO + (HI - LO) * frac) - 1.0) * TYPE_COEF[types.astype(np.int64)]
    uniq, first, inv = np.unique(aids, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")  # first-seen order
    rank_of = np.empty_like(order)
    rank_of[order] = np.arange(len(order))
    slot = rank_of[inv]
    if precision == "f64":
        sums = np.zeros(len(uniq))
        np.add.at(sums, slot, w)
    elif precision == "bf16":
        wb = round_bf16(w)
        sums = np.zeros(len(uniq), np.float32)
        for s, x in zip(slot, wb):
            sums[s] = round_bf16(sums[s] + x)
        sums = sums.astype(np.float64)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return uniq[order], sums


def top_aids(aids, types, k: int, precision: str = "f64") -> np.ndarray:
    """The session's k best aids (descending score, first-seen on ties)."""
    ids, sums = aid_scores(aids, types, precision)
    order = np.argsort(-sums, kind="stable")
    return ids[order[:k]]
