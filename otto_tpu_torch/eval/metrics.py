"""Recall@20 metrics on torch tensors.

Port of ``otto_tpu/eval/metrics.py``.  Semantics reproduced from the
reference (src/metrics.py:4-61):

- **click recall**: membership of the single ground-truth click in the <=20
  predictions; sessions without a click label are excluded (NaN there).
- **cart/order recall**: ``tp / min(20, tp + fn)`` per session; sessions with
  no labels are excluded.
- **weighted recall@20** = 0.1*click + 0.3*cart + 0.6*order.
- **corpus-level recall**: ``sum(hits) / sum(clip(|labels|, 0, 20))``.

Inputs are padded tensors — predictions ``[S, K]`` and labels ``[S, M]``
padded with ``-1`` — and the work runs on their device.  Ratios are taken in
float32, as in the reference.
"""

from __future__ import annotations

import torch

from otto_tpu_torch import TYPE_WEIGHTS


def hits_at_k(predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-session count of distinct label aids present in the predictions.

    predictions: int [S, K], padded with -1 (entries assumed distinct)
    labels:      int [S, M], padded with -1 (entries assumed distinct)
    returns:     int32 [S]
    """
    label_valid = labels >= 0
    pred_valid = predictions >= 0
    eq = ((labels[:, :, None] == predictions[:, None, :])
          & label_valid[:, :, None] & pred_valid[:, None, :])
    return eq.any(dim=2).sum(dim=1).to(torch.int32)


def click_recall_at_k(predictions: torch.Tensor, click_label: torch.Tensor):
    """Mean click recall (float32 scalar, NaN when no session is scored) and
    the count of scored sessions."""
    valid = click_label >= 0
    hit = (predictions == click_label[:, None]).any(dim=1) & valid
    n = valid.sum()
    recall = hit.sum().to(torch.float32) / n.clamp(min=1).to(torch.float32)
    return torch.where(n > 0, recall, torch.nan), n


def cart_order_recall_at_k(predictions: torch.Tensor, labels: torch.Tensor, k: int = 20):
    """Mean per-session ``tp / min(k, n_labels)`` recall and scored-session count."""
    n_labels = (labels >= 0).sum(dim=1)
    hits = hits_at_k(predictions, labels)
    valid = n_labels > 0
    denom = n_labels.clamp(max=k).clamp(min=1)
    per_session = torch.where(valid, hits.to(torch.float32) / denom.to(torch.float32), 0.0)
    n = valid.sum()
    recall = per_session.sum() / n.clamp(min=1).to(torch.float32)
    return torch.where(n > 0, recall, torch.nan), n


def corpus_recall_at_k(predictions: torch.Tensor, labels: torch.Tensor, k: int = 20) -> torch.Tensor:
    """Corpus-level recall: total hits over total clipped label counts."""
    n_labels = (labels >= 0).sum(dim=1)
    hits = hits_at_k(predictions, labels)
    denom = n_labels.clamp(0, k).sum()
    recall = hits.sum().to(torch.float32) / denom.clamp(min=1).to(torch.float32)
    return torch.where(denom > 0, recall, torch.nan)


def weighted_recall(click: float, cart: float, order: float) -> float:
    w_click, w_cart, w_order = TYPE_WEIGHTS
    return w_click * click + w_cart * cart + w_order * order
