"""Covisitation helpers used by the embedding-kNN slice.

Port of ``otto_tpu/models/covisitation.py:296`` (``session_unique_counts``,
numpy, copied).  The covisitation build and heuristic serving are ported
with the two-stage path.
"""

from __future__ import annotations

import numpy as np

from otto_tpu_torch.data.events import EventStore


def session_unique_counts(store: EventStore) -> np.ndarray:
    """Exact distinct-aid count per session (vectorized host-side)."""
    order = np.lexsort((store.aid, store.session_idx))
    s = store.session_idx[order]
    a = store.aid[order]
    head = np.concatenate([[True], (s[1:] != s[:-1]) | (a[1:] != a[:-1])])
    return np.bincount(s[head], minlength=store.n_sessions).astype(np.int32)
