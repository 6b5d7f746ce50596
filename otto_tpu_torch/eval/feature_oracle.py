"""Pandas reference-semantics oracle for the ranker feature plane.

Independent restatements (pandas groupby/agg, float64) of the three feature
families the two-stage ranker consumes, for measured parity against the
port's feature functions (``otto_tpu_torch/features/*``) on shared
inputs:

- :func:`oracle_aid_features` — src/ranker/aid_feature_engineering.py:44-231
  (the column subset RANKER_FEATURES + session FE's merge list need)
- :func:`oracle_session_features` — src/ranker/session_feature_engineering.py:40-149
- :func:`oracle_interaction_features` — src/ranker/interaction_feature_engineering.py:21-123
- :func:`oracle_fold_and_sampling` — the GroupKFold + positive-bearing-session
  0.30 negative-sampling protocol, src/ranker/lgb_trainer.py:81-133

Like ``eval/oracle.py`` these deliberately restate the reference's
*semantics* (pandas agg dicts, rank(pct=True), NaN-skipping means, left-join
NaN patterns) over the framework's data structures; they are the measurement
instrument, not production code.  Compare with
``tools/feature_parity_torch.py``.  pandas is imported here and sklearn in
:func:`oracle_fold_and_sampling`; nothing on the served or trained path
imports this module (``otto_tpu_torch.eval`` does not).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from otto_tpu_torch.data.events import EventStore

EVENT_NAMES = ("click", "cart", "order")


def events_to_frame(store: EventStore) -> pd.DataFrame:
    """Events as the reference's dataframe (sorted by session, ts) with the
    datetime columns of aid_feature_engineering.py:43-55."""
    df = pd.DataFrame(
        {
            "session": store.session_idx.astype(np.int64),
            "aid": store.aid.astype(np.int64),
            "ts": store.ts.astype(np.int64),
            "type": store.type.astype(np.int64),
        }
    )
    df = df.sort_values(["session", "ts"], kind="stable").reset_index(drop=True)
    dt = pd.to_datetime(df["ts"] + 2 * 60 * 60, unit="s")
    df["hour"] = dt.dt.hour
    df["day_of_week"] = dt.dt.dayofweek
    df["day_of_year"] = dt.dt.dayofyear
    df["week_of_year"] = dt.dt.isocalendar().week.astype(np.int64)
    df["session_cumcount"] = df.groupby("session")["aid"].cumcount() + 1
    df["session_cumcount_normalized"] = df["session_cumcount"] / df.groupby(
        "session"
    )["session"].transform("count")
    df["is_session_start"] = (df["session_cumcount"] == 1).astype(np.int64)
    df["is_session_end"] = (df["session_cumcount_normalized"] == 1).astype(np.int64)
    df["type+1"] = df["type"] + 1
    df["session_type+1_cumsum"] = df.groupby("session")["type+1"].cumsum()
    return df


def _agg_block(sub: pd.DataFrame, prefix: str, with_type: bool) -> pd.DataFrame:
    """The repeated agg dict of aid_feature_engineering.py:57-72, with the
    derived rank_pct / ts_ratio columns (:76-85)."""
    spec = {
        "aid": "count",
        "session": "nunique",
        "ts": ["max", "min"],
        "hour": ["mean", "std"],
        "day_of_week": ["mean", "std"],
        "day_of_year": "nunique",
        "session_cumcount_normalized": "mean",
        "is_session_start": ["mean", "count"],
        "is_session_end": ["mean", "count"],
    }
    if with_type:
        spec["type"] = "mean"
        spec["session_type+1_cumsum"] = "mean"
    g = sub.groupby("aid").agg(spec)
    g.columns = [prefix + "_".join(c).strip("_") for c in g.columns]
    g = g.rename(columns={f"{prefix}aid_count": f"{prefix}count"})
    for col in ("count", "session_nunique", "day_of_year_nunique",
                "is_session_start_count", "is_session_end_count"):
        g[f"{prefix}{col}_rank_pct"] = g[f"{prefix}{col}"].rank(pct=True)
    g[f"{prefix}ts_ratio"] = g[f"{prefix}ts_max"] / g[f"{prefix}ts_min"]
    return g


def oracle_aid_features(df: pd.DataFrame) -> pd.DataFrame:
    """Per-aid features, indexed by aid (left-join NaN where a sub-block has
    no rows for the aid — the reference's merge(how='left'))."""
    out = _agg_block(df, "aid_", with_type=True)

    for t, name in enumerate(EVENT_NAMES):
        sub = _agg_block(df.loc[df["type"] == t], f"aid_{name}_", with_type=False)
        out = out.join(sub, how="left")

    out["aid_click_ratio"] = out["aid_click_count"] / out["aid_count"]
    out["aid_cart_ratio"] = out["aid_cart_count"] / out["aid_count"]
    out["aid_order_ratio"] = out["aid_order_count"] / out["aid_count"]

    # last-week window (:141-170)
    lw = df.loc[df["week_of_year"] == df["week_of_year"].max()]
    out = out.join(_agg_block(lw, "aid_last_week_", with_type=True), how="left")

    # last 1..7 day windows (:172-206)
    last_days = sorted(df["day_of_year"].unique())[-7:]
    for nth, d in enumerate(last_days):
        label = 7 - nth
        out = out.join(
            _agg_block(df.loc[df["day_of_year"] == d], f"aid_last_{label}_day_",
                       with_type=True),
            how="left",
        )

    # weekly occurrence ratio + pct change (:208-222); the reference's week
    # axis follows df['week_of_year'].unique() APPEARANCE order — restated
    # here verbatim, divergences vs a sorted-week axis are a finding
    group_ids = pd.MultiIndex.from_product(
        [df["aid"].unique(), df["week_of_year"].unique(), [0, 1, 2]],
        names=["aid", "week_of_year", "type"],
    )
    counts = (
        df.groupby(["aid", "week_of_year", "type"])["session"].count().rename("count")
    )
    counts = counts.reindex(group_ids, fill_value=0).reset_index()
    ratio = (
        counts.groupby(["aid", "type"])["count"].last()
        / counts.groupby(["aid", "type"])["count"].sum()
    ).fillna(0.0).unstack("type")
    ratio.columns = [f"aid_{n}_last_week_occurrence_ratio" for n in EVENT_NAMES]
    out = out.join(ratio, how="left")
    counts["pct_change"] = counts.groupby(["aid", "type"])["count"].pct_change()
    pct = (
        counts.groupby(["aid", "type"])["pct_change"].last()
        .replace([np.inf, -np.inf], np.nan).unstack("type")
    )
    pct.columns = [f"aid_{n}_last_week_occurrence_pct_change" for n in EVENT_NAMES]
    out = out.join(pct, how="left")
    return out


# columns of the aid table merged onto events before session aggregation
# (session_feature_engineering.py:40-47)
SESSION_MERGE_COLUMNS = (
    "aid_count",
    "aid_type_mean",
    "aid_hour_mean",
    "aid_session_nunique_rank_pct",
    "aid_last_week_count",
    "aid_last_week_session_nunique",
    "aid_last_week_count_rank_pct",
    "aid_last_week_session_nunique_rank_pct",
)


def oracle_session_features(df: pd.DataFrame, aid_df: pd.DataFrame) -> pd.DataFrame:
    """Per-session features, indexed by session
    (session_feature_engineering.py:57-149)."""
    d = df.merge(
        aid_df[list(SESSION_MERGE_COLUMNS)].reset_index().rename(columns={"index": "aid"}),
        on="aid", how="left",
    )
    d = d.sort_values(["session", "ts"], kind="stable").reset_index(drop=True)

    g = d.groupby("session").agg({
        "session": "count",
        "aid": ["nunique", "last"],
        "type": ["mean", "last"],
        "ts": ["max", "min"],
        "hour": ["mean", "last"],
        "day_of_week": ["mean", "last"],
        "day_of_year": "nunique",
        "aid_count": ["mean", "min", "max", "last"],
        "aid_type_mean": "mean",
        "aid_hour_mean": "mean",
        "aid_session_nunique_rank_pct": ["mean", "last"],
        "aid_last_week_session_nunique": ["mean", "last"],
        "aid_last_week_count_rank_pct": ["mean", "last"],
        "aid_last_week_session_nunique_rank_pct": ["mean", "last"],
    })
    g.columns = ["session_" + "_".join(c).strip("_") for c in g.columns]
    g = g.rename(columns={"session_session_count": "session_count"})
    g["session_count_rank_pct"] = g["session_count"].rank(pct=True)
    g["session_aid_nunique_rank_pct"] = g["session_aid_nunique"].rank(pct=True)
    g["session_day_of_year_nunique_rank_pct"] = g["session_day_of_year_nunique"].rank(pct=True)
    g["session_ts_ratio"] = g["session_ts_max"] / g["session_ts_min"]
    g["session_unique_ratio"] = g["session_aid_nunique"] / g["session_count"]

    for t, name in enumerate(EVENT_NAMES):
        sub = d.loc[d["type"] == t].groupby("session").agg({
            "session": "count",
            "aid": ["nunique", "last"],
            "ts": ["max", "min"],
            "hour": ["mean", "last"],
            "day_of_week": ["mean", "last"],
            "aid_count": ["mean", "min", "max", "last"],
        })
        sub.columns = [f"session_{name}_" + "_".join(c).strip("_") for c in sub.columns]
        sub = sub.rename(columns={f"session_{name}_session_count": f"session_{name}_count"})
        sub[f"session_{name}_count_rank_pct"] = sub[f"session_{name}_count"].rank(pct=True)
        sub[f"session_{name}_aid_nunique_rank_pct"] = sub[f"session_{name}_aid_nunique"].rank(pct=True)
        sub[f"session_{name}_ts_ratio"] = sub[f"session_{name}_ts_max"] / sub[f"session_{name}_ts_min"]
        sub[f"session_{name}_unique_ratio"] = (
            sub[f"session_{name}_aid_nunique"] / sub[f"session_{name}_count"]
        )
        g = g.join(sub, how="left")
        g[f"session_{name}_count"] = g[f"session_{name}_count"].fillna(0)

    g["session_click_ratio"] = g["session_click_count"] / g["session_count"]
    g["session_cart_ratio"] = g["session_cart_count"] / g["session_count"]
    g["session_order_ratio"] = g["session_order_count"] / g["session_count"]
    return g


def oracle_interaction_features(
    df: pd.DataFrame, candidates: np.ndarray, scores: np.ndarray
) -> pd.DataFrame:
    """Per (session, candidate) features as a flat frame with ``session`` and
    ``candidates`` columns (interaction_feature_engineering.py:56-113)."""
    S, C = candidates.shape
    sess = np.repeat(np.arange(S, dtype=np.int64), C)
    cand = candidates.reshape(-1).astype(np.int64)
    sc = scores.reshape(-1).astype(np.float64)
    ok = cand >= 0
    cd = pd.DataFrame({"session": sess[ok], "candidates": cand[ok],
                       "candidate_scores": sc[ok]})

    ev = df.sort_values(["session", "ts"], kind="stable").reset_index(drop=True)
    ev["session_aid_cumcount"] = ev.groupby("session")["aid"].cumcount() + 1
    pair = ev.groupby(["session", "aid"]).agg(
        session_candidate_occurrence_count=("aid", "count"),
        session_candidate_cumcount_last=("session_aid_cumcount", "last"),
    ).reset_index().rename(columns={"aid": "candidates"})
    cd = cd.merge(pair, on=["session", "candidates"], how="left")
    cd["session_candidate_occurrence_count"] = (
        cd["session_candidate_occurrence_count"].fillna(0)
    )
    for t, name in enumerate(EVENT_NAMES):
        tp = ev.loc[ev["type"] == t].groupby(["session", "aid"]).size().rename(
            f"session_candidate_{name}_occurrence_count"
        ).reset_index().rename(columns={"aid": "candidates"})
        cd = cd.merge(tp, on=["session", "candidates"], how="left")
        cd[f"session_candidate_{name}_occurrence_count"] = (
            cd[f"session_candidate_{name}_occurrence_count"].fillna(0)
        )

    ses = cd.groupby("session").agg(
        session_candidate_score_mean=("candidate_scores", "mean"),
        session_candidate_score_std=("candidate_scores", "std"),
        session_candidate_score_min=("candidate_scores", "min"),
        session_candidate_score_max=("candidate_scores", "max"),
        session_candidate_occurrence_count_mean=("session_candidate_occurrence_count", "mean"),
        session_candidate_occurrence_count_sum=("session_candidate_occurrence_count", "sum"),
        session_candidate_occurrence_count_max=("session_candidate_occurrence_count", "max"),
        session_candidate_cumcount_last_mean=("session_candidate_cumcount_last", "mean"),
        session_candidate_cumcount_last_sum=("session_candidate_cumcount_last", "sum"),
        session_candidate_cumcount_last_max=("session_candidate_cumcount_last", "max"),
    )
    cd = cd.merge(ses, on="session", how="left")
    aidg = cd.groupby("candidates").agg(
        aid_candidate_score_mean=("candidate_scores", "mean"),
        aid_candidate_score_std=("candidate_scores", "std"),
        aid_candidate_score_max=("candidate_scores", "max"),
        aid_session_candidate_occurrence_count_mean=("session_candidate_occurrence_count", "mean"),
        aid_session_candidate_occurrence_count_sum=("session_candidate_occurrence_count", "sum"),
        aid_session_candidate_occurrence_count_max=("session_candidate_occurrence_count", "max"),
        aid_session_candidate_cumcount_last_mean=("session_candidate_cumcount_last", "mean"),
        aid_session_candidate_cumcount_last_sum=("session_candidate_cumcount_last", "sum"),
        aid_session_candidate_cumcount_last_max=("session_candidate_cumcount_last", "max"),
    )
    cd = cd.merge(aidg, on="candidates", how="left")
    return cd


def oracle_fold_and_sampling(
    sessions: np.ndarray, labels: np.ndarray, n_folds: int = 5,
    ratio: float = 0.30, random_state: int = 42,
):
    """Per-fold sorted train row indices under the reference protocol
    (lgb_trainer.py:81-133): sklearn GroupKFold by session; train rows = all
    positives + ``ratio``-frac pandas sample of the negatives whose session
    has >= 1 positive; indices sorted to retain session order."""
    from sklearn.model_selection import GroupKFold

    lab = pd.Series(labels)
    sess = pd.Series(sessions)
    target_sum = lab.groupby(sess).transform("sum")
    out = []
    gkf = GroupKFold(n_splits=n_folds)
    for train_idx, val_idx in gkf.split(X=np.zeros(len(sessions)), groups=sessions):
        is_train = np.zeros(len(sessions), bool)
        is_train[train_idx] = True
        eligible = is_train & (lab == 0) & (target_sum > 0)
        negs = lab.loc[eligible]
        neg_idx = negs.sample(frac=ratio, random_state=random_state).index.to_numpy()
        rows = np.hstack([np.flatnonzero(is_train & (lab == 1)), neg_idx])
        rows.sort()
        out.append({
            "train_rows": rows,
            "val_rows": np.sort(val_idx),
            "neg_sampled": int(len(neg_idx)),
            "neg_eligible": int(eligible.sum()),
        })
    return out
