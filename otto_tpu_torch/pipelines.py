"""End-to-end pipeline entry points: the baselines and the covisitation
heuristic.

Port of ``otto_tpu/pipelines.py:31-100`` (``run_aid_frequency``,
``run_aid_weight``, ``run_covisit_heuristic``).  Each reference model script
is an argparse ``__main__`` with a ``mode in {validation, submission}``
contract; here the equivalents are plain functions over in-memory stores on
an explicit ``device``.  The other model runners and the file-based CLI are
ported with their models (ROADMAP M2, M10).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.labels import SessionLabels
from otto_tpu_torch.eval.harness import RecallReport, evaluate_predictions
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.models.covisitation import build_covisitation, covisit_heuristic_predictions
from otto_tpu_torch.models.frequency import FrequencyStatistics, aid_frequency_predictions
from otto_tpu_torch.models.recency import (
    SUBMISSION_COEFFICIENTS,
    VALIDATION_COEFFICIENTS,
    aid_weight_predictions,
)

log = get_logger(__name__)

# Device-friendly packing width: sessions longer than this keep their most
# recent MAX_SESSION_LEN events (recency weights still use true positions).
MAX_SESSION_LEN = 256


def _packed(store: EventStore, max_len: int = MAX_SESSION_LEN):
    return store.pack(max_len=min(max_len, max(int(store.lengths.max(initial=1)), 1)), keep="last")


@dataclass
class BaselineResult:
    predictions: dict[str, np.ndarray]
    report: RecallReport | None


def _report(name: str, labels: SessionLabels | None, preds, device) -> RecallReport | None:
    if labels is None:
        return None
    report = evaluate_predictions(labels, preds["clicks"], preds["carts"], preds["orders"],
                                  device=device)
    log.info("%s validation scores\n%s", name, report)
    return report


def run_aid_frequency(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    *,
    device: str | torch.device,
) -> BaselineResult:
    """aid-frequency baseline (reference: src/baseline/aid_frequency.py)."""
    stats = FrequencyStatistics.compute(train, n_aids=n_aids, k=k, device=device)
    preds = aid_frequency_predictions(_packed(target), stats, k=k, device=device)
    return BaselineResult(preds, _report("aid frequency", labels, preds, device))


def run_aid_weight(
    target: EventStore,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    *,
    device: str | torch.device,
) -> BaselineResult:
    """aid-weight recency baseline (reference: src/baseline/aid_weight.py).
    Validation mode uses type coefficients {1,6,3}; submission {1,3,6}."""
    coeffs = VALIDATION_COEFFICIENTS if labels is not None else SUBMISSION_COEFFICIENTS
    preds = aid_weight_predictions(_packed(target), coefficients=coeffs, k=k, device=device)
    return BaselineResult(preds, _report("aid weight", labels, preds, device))


def run_covisit_heuristic(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    *,
    device: str | torch.device,
) -> BaselineResult:
    """Covisitation heuristic recommender end to end (reference:
    src/covisitation/inference.py)."""
    mats = build_covisitation(train, n_aids, device=device)
    stats = FrequencyStatistics.compute(train, n_aids=n_aids, k=k, device=device)
    stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
    preds = covisit_heuristic_predictions(target, mats, stats_top, k=k, device=device)
    return BaselineResult(preds, _report("covisitation heuristic", labels, preds, device))


MODEL_RUNNERS = {
    "aid_frequency": run_aid_frequency,
    "aid_weight": run_aid_weight,
    "covisitation": run_covisit_heuristic,
}
