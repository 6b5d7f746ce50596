"""Per-aid (item) feature family.

Copied from ``otto_tpu/features/aid_features.py`` (numpy).  Reproduces
src/ranker/aid_feature_engineering.py:44-231: global aggregates,
per-event-type aggregates, last-week and last-1..7-day windows, weekly
occurrence ratios and pct-change trends, and percentile ranks — all as
segment reductions keyed by aid.

Each aggregate block (the repeated agg dict at
src/ranker/aid_feature_engineering.py:57-72) is ONE fused pass over the
event arrays via :func:`otto_tpu_torch.features.base.block_stats` (the
native C++ engine unless ``force_numpy``), with the block's event subset
expressed as a mask — no column slicing, no per-statistic re-scan.

Returned as a dict of [n_aids] float32 arrays named exactly like the
reference's columns, so the ranker's feature list
(models/lightgbm/config.yaml:5-26) resolves directly.
"""

from __future__ import annotations

import numpy as np

from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.features.base import (
    block_stats,
    calendar,
    mean_from_sums,
    rank_pct,
    std_from_sums,
)

EVENT_NAMES = ("click", "cart", "order")

# value-column order inside the fused block pass
_C_TYPE, _C_HOUR, _C_DOW, _C_CUMNORM, _C_START, _C_END, _C_TCS = range(7)


def _block(prefix: str, aid, n, sess, day, ts, cols, mask,
           with_type: bool = True, force_numpy: bool = False) -> dict[str, np.ndarray]:
    """One aggregate block = one fused pass (aid_feature_engineering.py:57-72)."""
    count, sess_nu, day_nu, ts_min, ts_max, sums, sumsqs = block_stats(
        aid, sess, day, ts, cols, n, mask=mask, force_numpy=force_numpy
    )
    present = count > 0
    f = {}
    f[f"{prefix}count"] = count
    f[f"{prefix}session_nunique"] = np.where(present, sess_nu, np.nan)
    if with_type:
        f[f"{prefix}type_mean"] = mean_from_sums(sums[_C_TYPE], count)
    with np.errstate(invalid="ignore", divide="ignore"):
        f[f"{prefix}ts_ratio"] = ts_max / ts_min
    f[f"{prefix}hour_mean"] = mean_from_sums(sums[_C_HOUR], count)
    f[f"{prefix}hour_std"] = std_from_sums(sums[_C_HOUR], sumsqs[_C_HOUR], count)
    f[f"{prefix}day_of_week_mean"] = mean_from_sums(sums[_C_DOW], count)
    f[f"{prefix}day_of_week_std"] = std_from_sums(sums[_C_DOW], sumsqs[_C_DOW], count)
    f[f"{prefix}day_of_year_nunique"] = np.where(present, day_nu, np.nan)
    f[f"{prefix}session_cumcount_normalized_mean"] = mean_from_sums(sums[_C_CUMNORM], count)
    f[f"{prefix}is_session_start_mean"] = mean_from_sums(sums[_C_START], count)
    f[f"{prefix}is_session_start_count"] = np.where(present, count, np.nan)
    f[f"{prefix}is_session_end_mean"] = mean_from_sums(sums[_C_END], count)
    f[f"{prefix}is_session_end_count"] = np.where(present, count, np.nan)
    if with_type:
        f[f"{prefix}session_type+1_cumsum_mean"] = mean_from_sums(sums[_C_TCS], count)

    for col in ("count", "session_nunique", "day_of_year_nunique",
                "is_session_start_count", "is_session_end_count"):
        f[f"{prefix}{col}_rank_pct"] = rank_pct(
            np.where(present, f[f"{prefix}{col}"], np.nan)
        )
    # counts for absent aids are 0 in the global block but NaN-equivalents in
    # merged sub-blocks; rank_pct above excludes NaN like pandas
    return f


def compute_aid_features(store: EventStore, n_aids: int,
                         force_numpy: bool = False) -> dict[str, np.ndarray]:
    aid = store.aid.astype(np.int64)
    sess = store.session_idx.astype(np.int64)
    typ = store.type.astype(np.float64)
    ts = store.ts.astype(np.float64)
    cal = calendar(store.ts)

    lengths = store.lengths
    pos = store.position_in_session
    cumcount = (pos + 1).astype(np.float64)
    total = lengths[store.session_idx].astype(np.float64)
    cumnorm = cumcount / total
    is_start = (cumcount == 1).astype(np.float64)
    is_end = (cumnorm == 1.0).astype(np.float64)
    # running per-session cumulative sum of (type + 1)
    tp1 = typ + 1.0
    cs = np.cumsum(tp1)
    sess_first = store.offsets[:-1]
    type_cumsum = cs - np.repeat(cs[sess_first] - tp1[sess_first], lengths)

    # the fused block pass reads this [7, n_events] matrix (order = _C_*)
    cols = np.ascontiguousarray(np.stack([
        typ, cal["hour"].astype(np.float64), cal["day_of_week"].astype(np.float64),
        cumnorm, is_start, is_end, type_cumsum,
    ]))
    day = cal["day_of_year"]

    def run(prefix, mask, with_type=True):
        return _block(prefix, aid, n_aids, sess, day, ts, cols, mask,
                      with_type=with_type, force_numpy=force_numpy)

    out = run("aid_", None)
    # the reference's global block keeps absent-aid count at 0 via merge
    # semantics; sub-blocks below are left-joined (NaN where absent)

    def leftjoin(sub, key):
        cnt = sub[key]
        sub[key] = np.where(cnt > 0, cnt, np.nan)
        return sub

    for t, name in enumerate(EVENT_NAMES):
        sub = run(f"aid_{name}_", store.type == t, with_type=False)
        out.update(leftjoin(sub, f"aid_{name}_count"))

    with np.errstate(invalid="ignore", divide="ignore"):
        out["aid_click_ratio"] = out["aid_click_count"] / out["aid_count"]
        out["aid_cart_ratio"] = out["aid_cart_count"] / out["aid_count"]
        out["aid_order_ratio"] = out["aid_order_count"] / out["aid_count"]

    # ---- last week window (aid_feature_engineering.py:141-170) ------------
    week = cal["week_of_year"]
    sub = run("aid_last_week_", week == week.max())
    out.update(leftjoin(sub, "aid_last_week_count"))

    # ---- last 1..7 day windows (:172-206) ---------------------------------
    days = np.sort(np.unique(day))[-7:]
    for nth, d in enumerate(days):
        label = 7 - nth
        sub = run(f"aid_last_{label}_day_", day == d)
        out.update(leftjoin(sub, f"aid_last_{label}_day_count"))

    # ---- weekly occurrence ratio + pct change (:208-222) ------------------
    weeks = np.sort(np.unique(week))
    n_weeks = len(weeks)
    week_idx = np.searchsorted(weeks, week)
    for t, name in enumerate(EVENT_NAMES):
        m = store.type == t
        key = (aid[m] * n_weeks + week_idx[m]).astype(np.int64)
        counts = np.bincount(key, minlength=n_aids * n_weeks).reshape(n_aids, n_weeks)
        totals = counts.sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = np.where(totals > 0, counts[:, -1] / totals, 0.0)
            prev = counts[:, -2] if n_weeks > 1 else np.zeros(n_aids)
            pct = np.where(prev > 0, (counts[:, -1] - prev) / prev, np.nan)
        out[f"aid_{name}_last_week_occurrence_ratio"] = ratio
        out[f"aid_{name}_last_week_occurrence_pct_change"] = pct

    return {k: v.astype(np.float32) for k, v in out.items()}
