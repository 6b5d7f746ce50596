"""Classification / regression scores for the embedding trainers.

Port of ``otto_tpu/eval/model_metrics.py`` (numpy, copied).  Replaces
src/matrix_factorization/metrics.py (accuracy + ROC-AUC for the CF model,
MAE + MSE for the MF model) without sklearn: AUC is the normalized
Mann-Whitney U statistic computed from ranks.
"""

from __future__ import annotations

import numpy as np


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Rank-based AUC (ties get average ranks), NaN when one class absent."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="stable")
    ranks = np.empty(len(y_score), np.float64)
    sorted_scores = y_score[order]
    # average ranks for ties
    idx = np.arange(1, len(y_score) + 1, dtype=np.float64)
    head = np.concatenate([[True], sorted_scores[1:] != sorted_scores[:-1]])
    group = np.cumsum(head) - 1
    group_sum = np.bincount(group, weights=idx)
    group_cnt = np.bincount(group)
    ranks[order] = (group_sum / group_cnt)[group]
    u = ranks[y_true].sum() - n_pos * (n_pos + 1) / 2
    return float(u / (n_pos * n_neg))


def classification_scores(y_true: np.ndarray, y_logits: np.ndarray) -> dict[str, float]:
    """Accuracy (at logit 0) + ROC-AUC (reference: metrics.py:5-55)."""
    y_pred = (np.asarray(y_logits) >= 0).astype(np.float32)
    return {
        "accuracy": float(np.mean(y_pred == np.asarray(y_true))),
        "roc_auc": roc_auc(y_true, y_logits),
    }


def regression_scores(y_true: np.ndarray, y_pred: np.ndarray) -> dict[str, float]:
    """MAE + MSE (reference: metrics.py:58-85)."""
    err = np.asarray(y_pred, np.float64) - np.asarray(y_true, np.float64)
    return {"mean_absolute_error": float(np.mean(np.abs(err))), "mean_squared_error": float(np.mean(err**2))}
