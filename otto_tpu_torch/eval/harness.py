"""Validation harness: score [S, 20] prediction matrices against SessionLabels.

Port of ``otto_tpu/eval/harness.py:25-88`` (``RecallReport`` and
``evaluate_predictions``).  Replaces the per-model validation loops the
reference repeats in every script (src/baseline/aid_frequency.py:44-74,
src/covisitation/inference.py:251-267, src/ranker/lgb_trainer.py:191-198)
with one entry point that reports both the per-session-mean recalls and the
corpus-level variant.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from otto_tpu_torch.data.labels import SessionLabels
from otto_tpu_torch.eval.metrics import (
    cart_order_recall_at_k,
    click_recall_at_k,
    corpus_recall_at_k,
    weighted_recall,
)


@dataclass
class RecallReport:
    clicks: float
    carts: float
    orders: float
    weighted: float
    clicks_n: int
    carts_n: int
    orders_n: int
    corpus_clicks: float
    corpus_carts: float
    corpus_orders: float
    corpus_weighted: float

    def __str__(self) -> str:
        return (
            f"clicks  - n: {self.clicks_n} recall@20: {self.clicks:.4f} (corpus {self.corpus_clicks:.4f})\n"
            f"carts   - n: {self.carts_n} recall@20: {self.carts:.4f} (corpus {self.corpus_carts:.4f})\n"
            f"orders  - n: {self.orders_n} recall@20: {self.orders:.4f} (corpus {self.corpus_orders:.4f})\n"
            f"weighted recall@20: {self.weighted:.4f} (corpus {self.corpus_weighted:.4f})"
        )


def evaluate_predictions(
    labels: SessionLabels,
    click_preds: np.ndarray,
    cart_preds: np.ndarray | None = None,
    order_preds: np.ndarray | None = None,
    k: int = 20,
    *,
    device: str | torch.device,
) -> RecallReport:
    """Score per-type [S, <=k] prediction matrices (padded with -1) on ``device``.

    When cart/order predictions are omitted the click predictions are reused,
    matching baselines that predict one list for all types
    (src/baseline/aid_weight.py:48-50).
    """
    cart_preds = click_preds if cart_preds is None else cart_preds
    order_preds = click_preds if order_preds is None else order_preds

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    click_p, cart_p, order_p = dev(click_preds), dev(cart_preds), dev(order_preds)
    click_r, click_n = click_recall_at_k(click_p, dev(labels.click))
    cart_padded = dev(labels.padded("carts"))
    order_padded = dev(labels.padded("orders"))
    cart_r, cart_n = cart_order_recall_at_k(cart_p, cart_padded, k=k)
    order_r, order_n = cart_order_recall_at_k(order_p, order_padded, k=k)

    c_click = corpus_recall_at_k(click_p, dev(labels.padded("clicks")), k=k)
    c_cart = corpus_recall_at_k(cart_p, cart_padded, k=k)
    c_order = corpus_recall_at_k(order_p, order_padded, k=k)

    click_r, cart_r, order_r = float(click_r), float(cart_r), float(order_r)
    c_click, c_cart, c_order = float(c_click), float(c_cart), float(c_order)
    return RecallReport(
        clicks=click_r,
        carts=cart_r,
        orders=order_r,
        weighted=weighted_recall(click_r, cart_r, order_r),
        clicks_n=int(click_n),
        carts_n=int(cart_n),
        orders_n=int(order_n),
        corpus_clicks=c_click,
        corpus_carts=c_cart,
        corpus_orders=c_order,
        corpus_weighted=weighted_recall(c_click, c_cart, c_order),
    )
