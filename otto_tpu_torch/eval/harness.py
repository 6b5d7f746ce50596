"""Validation harness: score [S, 20] prediction matrices against SessionLabels.

Port of ``otto_tpu/eval/harness.py``: ``RecallReport``,
``evaluate_predictions``, and the per-session recalls with the paired
bootstrap of a lift (host numpy, as in the reference).  Replaces the
per-model validation loops the reference repeats in every script
(src/baseline/aid_frequency.py:44-74, src/covisitation/inference.py:251-267,
src/ranker/lgb_trainer.py:191-198) with one entry point that reports both
the per-session-mean recalls and the corpus-level variant.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from otto_tpu_torch import TYPE_WEIGHTS
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


def per_session_recalls(
    labels: SessionLabels,
    click_preds: np.ndarray,
    cart_preds: np.ndarray,
    order_preds: np.ndarray,
    k: int = 20,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Per-session recall contributions for each event type, on the host.

    Returns ``{etype: (per_session float64 [S], valid bool [S])}`` where the
    mean of ``per_session[valid]`` equals the corresponding ``RecallReport``
    field — the per-session decomposition the reference's vectorized recall
    sums over (src/covisitation/inference.py:251-257) and the input to the
    paired bootstrap below.  Hits are counted in numpy (integers, so the
    counts are those of :func:`otto_tpu_torch.eval.metrics.hits_at_k`).
    """
    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    click = np.asarray(labels.click)
    valid_c = click >= 0
    hit = (np.asarray(click_preds) == click[:, None]).any(axis=1) & valid_c
    out["clicks"] = (hit.astype(np.float64), valid_c)
    for etype, preds in (("carts", cart_preds), ("orders", order_preds)):
        padded = labels.padded(etype)
        preds = np.asarray(preds)
        n_labels = (padded >= 0).sum(axis=1)
        eq = ((padded[:, :, None] == preds[:, None, :]) & (padded >= 0)[:, :, None]
              & (preds >= 0)[:, None, :])
        hits = eq.any(axis=2).sum(axis=1)
        valid = n_labels > 0
        per = np.where(valid, hits / np.maximum(np.minimum(k, n_labels), 1), 0.0)
        out[etype] = (per.astype(np.float64), valid)
    return out


def paired_bootstrap_lift(
    labels: SessionLabels,
    preds_a: dict[str, np.ndarray],
    preds_b: dict[str, np.ndarray],
    n_boot: int = 1000,
    seed: int = 0,
    k: int = 20,
) -> dict:
    """Paired per-session bootstrap CI of the weighted recall@20 lift A - B.

    Each resample draws sessions with replacement ONCE and scores both
    systems on that same draw, so the interval is on the paired difference.
    Draws come from ``np.random.default_rng(seed)`` as in ``otto_tpu``, so
    the same seed gives the same interval.  Returns the observed lift, the
    percentile 95% CI, and ``p_le_0`` (the bootstrap fraction with
    lift <= 0).
    """
    ra = per_session_recalls(labels, preds_a["clicks"], preds_a["carts"],
                             preds_a["orders"], k=k)
    rb = per_session_recalls(labels, preds_b["clicks"], preds_b["carts"],
                             preds_b["orders"], k=k)
    S = len(ra["clicks"][0])
    types = ("clicks", "carts", "orders")
    # [S, 9]: per-type (valid, per_a, per_b); valid masks are label-only and
    # therefore shared between the two systems
    cols = []
    for t in types:
        pa, va = ra[t]
        pb, _ = rb[t]
        cols += [va.astype(np.float64), pa, pb]
    M = np.stack(cols, axis=1)

    def _weighted(sums: np.ndarray) -> tuple[float, float]:
        wa = wb = 0.0
        for i, w in enumerate(TYPE_WEIGHTS):
            n = max(sums[3 * i], 1.0)
            wa += w * sums[3 * i + 1] / n
            wb += w * sums[3 * i + 2] / n
        return wa, wb

    obs_a, obs_b = _weighted(M.sum(axis=0))
    rng = np.random.default_rng(seed)
    lifts = np.empty(n_boot, np.float64)
    for b in range(n_boot):
        idx = rng.integers(0, S, size=S)
        sa, sb = _weighted(M[idx].sum(axis=0))
        lifts[b] = sa - sb
    lo, hi = np.percentile(lifts, [2.5, 97.5])
    return {
        "lift": round(obs_a - obs_b, 6),
        "weighted_a": round(obs_a, 6),
        "weighted_b": round(obs_b, 6),
        "ci95": [round(float(lo), 6), round(float(hi), 6)],
        "p_le_0": round(float((lifts <= 0.0).mean()), 4),
        "boot_mean": round(float(lifts.mean()), 6),
        "boot_std": round(float(lifts.std()), 6),
        "n_sessions": int(S),
        "n_boot": int(n_boot),
        "significant": bool(lo > 0.0),
    }
