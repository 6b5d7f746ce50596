"""The aid-weight (recency) baseline.

Port of ``otto_tpu/models/recency.py``.  Replaces src/baseline/aid_weight.py:
per-session aid scores are the sum of log-recency weights
``logspace(0.1, 1, n, base=2) - 1`` times a per-event-type coefficient
({click:1, cart:6, order:3} in validation mode, {1,3,6} in submission mode —
aid_weight.py:34 vs :88), ranked descending; one top-20 list is used for all
three prediction types.  The per-aid sums run through the vote kernel on the
card (:func:`otto_tpu_torch.ops.sessions.recency_weighted_top_aids`).
"""

from __future__ import annotations

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.data.events import PackedSessions
from otto_tpu_torch.ops.sessions import recency_weighted_top_aids
from otto_tpu_torch.utils.runtime import resolve_device

VALIDATION_COEFFICIENTS = (1.0, 6.0, 3.0)
SUBMISSION_COEFFICIENTS = (1.0, 3.0, 6.0)


def aid_weight_predictions(
    packed: PackedSessions,
    coefficients=VALIDATION_COEFFICIENTS,
    k: int = TOP_K,
    *,
    device: str | torch.device,
) -> dict[str, np.ndarray]:
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(a, device=dev)

    aids, _ = recency_weighted_top_aids(
        t(packed.aids), t(packed.types), t(packed.mask), t(packed.lengths),
        torch.tensor(coefficients, dtype=torch.float32, device=dev), k=k, lo=0.1, hi=1.0)
    preds = aids.cpu().numpy()
    return {name: preds for name in EVENT_TYPES}
