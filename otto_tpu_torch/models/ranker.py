"""The ranker's training data, protocol helpers and top-k selection.

Port of the numpy parts of ``otto_tpu/models/ranker.py``, copied:
:class:`RankerData` (:135), :func:`group_kfold` (:39),
:func:`negative_sample_mask` (:283) and :func:`top_k_predictions` (:399).
The reference's protocol: 5-fold GroupKFold by session
(lgb_trainer.py:81-86), negative sampling restricted to sessions with >= 1
positive (:117-133).  The listwise tower
(``RankerModel``, ``train_ranker``) is not ported yet (ROADMAP M12).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class RankerData:
    """Listwise candidate features for ranking.

    features: float32 [S, C, F]; labels: int8 [S, C]; mask: bool [S, C];
    session_ids: [S]; candidates: int32 [S, C] (for emitting predictions).
    """

    features: np.ndarray
    labels: np.ndarray
    mask: np.ndarray
    session_ids: np.ndarray
    candidates: np.ndarray
    feature_names: list[str] = field(default_factory=list)


def group_kfold(session_sizes: np.ndarray, n_folds: int) -> np.ndarray:
    """sklearn-style GroupKFold: groups sorted by size descending, greedily
    assigned to the currently smallest fold.  Returns fold id per group."""
    order = np.argsort(-session_sizes, kind="stable")
    fold_sizes = np.zeros(n_folds, np.int64)
    fold_of = np.empty(len(session_sizes), np.int32)
    for g in order:
        f = int(np.argmin(fold_sizes))
        fold_of[g] = f
        fold_sizes[f] += session_sizes[g]
    return fold_of


def negative_sample_mask(
    labels: np.ndarray, mask: np.ndarray, ratio: float, rng: np.random.Generator
) -> np.ndarray:
    """Training-candidate keep mask: all positives, plus ``ratio`` of the
    negatives in sessions that have at least one positive
    (lgb_trainer.py:117-133).  Sessions without positives are dropped."""
    has_pos = (labels * mask).sum(axis=1) > 0
    keep = mask & (labels > 0)
    negs = mask & (labels == 0) & has_pos[:, None]
    sampled = negs & (rng.random(labels.shape) < ratio)
    return keep | sampled


def top_k_predictions(candidates: np.ndarray, scores: np.ndarray, k: int = 20) -> np.ndarray:
    """Per-session top-k candidates by score: [S, C] -> [S, k] padded -1
    (a stable argsort of ``-scores``: ties keep candidate order)."""
    S, C = candidates.shape
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    rows = np.arange(S)[:, None]
    out = candidates[rows, order]
    picked_scores = scores[rows, order]
    return np.where(np.isfinite(picked_scores), out, -1).astype(np.int32)
