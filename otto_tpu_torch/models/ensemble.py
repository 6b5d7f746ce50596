"""Score blending across ranker models.

Port of ``otto_tpu/models/ensemble.py``, so far only :func:`robust_scale`,
which the two-stage prior blend uses.  The file blend (``blend``,
``candidate_set_predictions`` and the parquet I/O) comes with the file CLI.
The scaling stays in numpy float64: ``np.median`` and ``np.percentile`` are
what the reference computes (``torch.quantile`` interpolates differently).
"""

from __future__ import annotations

import numpy as np


def robust_scale(scores: np.ndarray) -> np.ndarray:
    """(x - median) / IQR (sklearn RobustScaler on a single column)."""
    med = np.median(scores)
    q1, q3 = np.percentile(scores, [25, 75])
    iqr = q3 - q1
    if iqr == 0:
        return scores - med
    return (scores - med) / iqr
