"""Per-session feature family.

Copied from ``otto_tpu/features/session_features.py`` (numpy).  Reproduces
src/ranker/session_feature_engineering.py:40-149: event-level aid features
are first broadcast onto events (the reference's merge at :47), then
aggregated per session, with per-event-type sub-blocks and ratio features.
Returns a dict of [n_sessions] float32 arrays with the reference's column
names.
"""

from __future__ import annotations

import numpy as np

from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.features.base import (
    calendar,
    rank_pct,
    seg_count,
    seg_last,
    seg_max,
    seg_mean,
    seg_min,
    seg_nanlast,
    seg_nanmean,
    seg_nunique,
)

EVENT_NAMES = ("click", "cart", "order")

# aid features broadcast onto events (session_feature_engineering.py:40-46)
MERGED_AID_COLUMNS = (
    "aid_count",
    "aid_type_mean",
    "aid_hour_mean",
    "aid_session_nunique_rank_pct",
    "aid_last_week_count",
    "aid_last_week_session_nunique",
    "aid_last_week_count_rank_pct",
    "aid_last_week_session_nunique_rank_pct",
)


def compute_session_features(
    store: EventStore, aid_features: dict[str, np.ndarray]
) -> dict[str, np.ndarray]:
    S = store.n_sessions
    sess = store.session_idx.astype(np.int64)
    aid = store.aid.astype(np.int64)
    typ = store.type.astype(np.float64)
    ts = store.ts.astype(np.float64)
    cal = calendar(store.ts)

    ev = {c: aid_features[c].astype(np.float64)[aid] for c in MERGED_AID_COLUMNS if c in aid_features}

    out: dict[str, np.ndarray] = {}
    count = seg_count(sess, S)
    out["session_count"] = count
    out["session_aid_nunique"] = seg_nunique(sess, aid, S)
    out["session_aid_last"] = seg_last(sess, aid.astype(np.float64), S)
    out["session_type_mean"] = seg_mean(sess, typ, S)
    out["session_type_last"] = seg_last(sess, typ, S)
    ts_max = seg_max(sess, ts, S)
    ts_min = seg_min(sess, ts, S)
    out["session_ts_ratio"] = ts_max / ts_min
    out["session_hour_mean"] = seg_mean(sess, cal["hour"], S)
    out["session_hour_last"] = seg_last(sess, cal["hour"].astype(np.float64), S)
    out["session_day_of_week_mean"] = seg_mean(sess, cal["day_of_week"], S)
    out["session_day_of_week_last"] = seg_last(sess, cal["day_of_week"].astype(np.float64), S)
    out["session_day_of_year_nunique"] = seg_nunique(sess, cal["day_of_year"], S)

    if "aid_count" in ev:
        out["session_aid_count_mean"] = seg_mean(sess, ev["aid_count"], S)
        out["session_aid_count_min"] = seg_min(sess, ev["aid_count"], S)
        out["session_aid_count_max"] = seg_max(sess, ev["aid_count"], S)
        out["session_aid_count_last"] = seg_last(sess, ev["aid_count"], S)
    for col, agg_last in (
        ("aid_type_mean", False),
        ("aid_hour_mean", False),
        ("aid_session_nunique_rank_pct", True),
        ("aid_last_week_session_nunique", True),
        ("aid_last_week_count_rank_pct", True),
        ("aid_last_week_session_nunique_rank_pct", True),
    ):
        if col not in ev:
            continue
        # pandas mean/last skip NaN (the left-joined aid_last_week_* columns
        # are NaN for aids absent from the window) — measured divergence
        # until the NaN-skipping variants were used (tools/feature_parity.py)
        out[f"session_{col}_mean"] = seg_nanmean(sess, ev[col], S)
        if agg_last:
            out[f"session_{col}_last"] = seg_nanlast(sess, ev[col], S)

    out["session_count_rank_pct"] = rank_pct(out["session_count"])
    out["session_aid_nunique_rank_pct"] = rank_pct(out["session_aid_nunique"])
    out["session_day_of_year_nunique_rank_pct"] = rank_pct(out["session_day_of_year_nunique"])
    out["session_unique_ratio"] = out["session_aid_nunique"] / out["session_count"]

    # per-event-type sub-blocks (session_feature_engineering.py:107-135)
    for t, name in enumerate(EVENT_NAMES):
        m = store.type == t
        sm, am, tm = sess[m], aid[m], ts[m]
        cnt = seg_count(sm, S)
        present = cnt > 0
        out[f"session_{name}_count"] = cnt  # fillna(0) in reference :133
        out[f"session_{name}_aid_nunique"] = np.where(present, seg_nunique(sm, am, S), np.nan)
        out[f"session_{name}_aid_last"] = seg_last(sm, am.astype(np.float64), S)
        out[f"session_{name}_ts_ratio"] = seg_max(sm, tm, S) / seg_min(sm, tm, S)
        out[f"session_{name}_hour_mean"] = seg_mean(sm, cal["hour"][m], S)
        out[f"session_{name}_hour_last"] = seg_last(sm, cal["hour"][m].astype(np.float64), S)
        out[f"session_{name}_day_of_week_mean"] = seg_mean(sm, cal["day_of_week"][m], S)
        out[f"session_{name}_day_of_week_last"] = seg_last(
            sm, cal["day_of_week"][m].astype(np.float64), S
        )
        if "aid_count" in ev:
            evc = ev["aid_count"][m]
            out[f"session_{name}_aid_count_mean"] = seg_mean(sm, evc, S)
            out[f"session_{name}_aid_count_min"] = seg_min(sm, evc, S)
            out[f"session_{name}_aid_count_max"] = seg_max(sm, evc, S)
            out[f"session_{name}_aid_count_last"] = seg_last(sm, evc, S)
        out[f"session_{name}_count_rank_pct"] = rank_pct(np.where(present, cnt, np.nan))
        out[f"session_{name}_aid_nunique_rank_pct"] = rank_pct(out[f"session_{name}_aid_nunique"])
        with np.errstate(invalid="ignore", divide="ignore"):
            out[f"session_{name}_unique_ratio"] = out[f"session_{name}_aid_nunique"] / np.where(
                present, cnt, np.nan
            )

    with np.errstate(invalid="ignore", divide="ignore"):
        out["session_click_ratio"] = out["session_click_count"] / out["session_count"]
        out["session_cart_ratio"] = out["session_cart_count"] / out["session_count"]
        out["session_order_ratio"] = out["session_order_count"] / out["session_count"]

    return {k: np.asarray(v, np.float32) for k, v in out.items()}
