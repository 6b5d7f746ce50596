"""Per (session, candidate) interaction feature family.

Copied from ``otto_tpu/features/interaction_features.py`` (numpy).
Reproduces src/ranker/interaction_feature_engineering.py:21-123:

- occurrence counts of the candidate aid in its session (total and per event
  type), and the 1-based position of its last occurrence
- per-session aggregates over the candidate list (score mean/std/min/max,
  occurrence and cumcount-last mean/sum/max)
- per-candidate-aid aggregates across sessions (score mean/std/max,
  occurrence and cumcount-last mean/sum/max)

Counting joins on exact (session, aid) keys via sorted-key binary search —
the vectorized equivalent of the reference's polars joins.
Outputs are [S, C] float32 matrices aligned with the candidate set.
"""

from __future__ import annotations

import numpy as np

from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.features.base import (
    seg_max,
    seg_mean,
    seg_min,
    seg_nanmax,
    seg_nanmean,
    seg_std,
    seg_sum,
)

EVENT_NAMES = ("click", "cart", "order")


def _pair_counts(store: EventStore, n_aids: int):
    """Sorted unique (session, aid) keys with total/per-type counts and the
    last cumcount (1-based event position of the final occurrence)."""
    key = store.session_idx.astype(np.int64) * n_aids + store.aid.astype(np.int64)
    pos = (store.position_in_session + 1).astype(np.int64)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    st = store.type[order]
    sp = pos[order]
    head = np.concatenate([[True], sk[1:] != sk[:-1]])
    gid = np.cumsum(head) - 1
    n_groups = gid[-1] + 1 if len(gid) else 0
    counts = np.bincount(gid, minlength=n_groups)
    type_counts = [
        np.bincount(gid[st == t], minlength=n_groups) for t in range(3)
    ]
    last_pos = np.zeros(n_groups, np.int64)
    np.maximum.at(last_pos, gid, sp)
    return sk[head], counts, type_counts, last_pos


def compute_interaction_features(
    store: EventStore,
    candidates: np.ndarray,  # int32 [S, C] padded -1 (sessions aligned with store)
    scores: np.ndarray,  # float32 [S, C]
    n_aids: int,
) -> dict[str, np.ndarray]:
    S, C = candidates.shape
    keys, counts, type_counts, last_pos = _pair_counts(store, n_aids)

    sess_rows = np.repeat(np.arange(S, dtype=np.int64), C)
    cand = candidates.reshape(-1).astype(np.int64)
    valid = cand >= 0
    qkey = sess_rows * n_aids + np.where(valid, cand, 0)

    idx = np.searchsorted(keys, qkey)
    idx_c = np.clip(idx, 0, max(len(keys) - 1, 0))
    found = valid & (idx < len(keys)) & (keys[idx_c] == qkey) if len(keys) else np.zeros_like(valid)

    def fetch(arr, fill=0.0):
        out = np.full(S * C, fill, np.float64)
        out[found] = arr[idx_c[found]]
        return out.reshape(S, C)

    out: dict[str, np.ndarray] = {}
    occ = fetch(counts)
    out["session_candidate_occurrence_count"] = occ  # fill_null(0) in reference
    for t, name in enumerate(EVENT_NAMES):
        out[f"session_candidate_{name}_occurrence_count"] = fetch(type_counts[t])
    cum_last = fetch(last_pos, fill=np.nan)
    out["session_candidate_cumcount_last"] = cum_last

    # per-session aggregates over the candidate list (:86-97)
    vm = valid.reshape(S, C)
    flat_sess = sess_rows[valid]
    sc = scores.reshape(-1)[valid].astype(np.float64)
    occ_f = occ.reshape(-1)[valid]
    # cumcount_last stays NaN for never-occurring candidates: polars
    # mean/max skip nulls (measured divergence vs the oracle otherwise —
    # tools/feature_parity.py); sum treats nulls as 0
    cum_f = cum_last.reshape(-1)[valid]
    cum_f0 = np.nan_to_num(cum_f, nan=0.0)

    def broadcast(per_session):
        return np.where(vm, per_session[:, None], np.nan).astype(np.float64)

    out["session_candidate_score_mean"] = broadcast(seg_mean(flat_sess, sc, S))
    out["session_candidate_score_std"] = broadcast(seg_std(flat_sess, sc, S))
    out["session_candidate_score_min"] = broadcast(seg_min(flat_sess, sc, S))
    out["session_candidate_score_max"] = broadcast(seg_max(flat_sess, sc, S))
    out["session_candidate_occurrence_count_mean"] = broadcast(seg_mean(flat_sess, occ_f, S))
    out["session_candidate_occurrence_count_sum"] = broadcast(seg_sum(flat_sess, occ_f, S))
    out["session_candidate_occurrence_count_max"] = broadcast(seg_max(flat_sess, occ_f, S))
    out["session_candidate_cumcount_last_mean"] = broadcast(seg_nanmean(flat_sess, cum_f, S))
    out["session_candidate_cumcount_last_sum"] = broadcast(seg_sum(flat_sess, cum_f0, S))
    out["session_candidate_cumcount_last_max"] = broadcast(seg_nanmax(flat_sess, cum_f, S))

    # per-candidate-aid aggregates across sessions (:99-113)
    flat_aid = cand[valid]
    def aid_broadcast(per_aid):
        out_f = np.full(S * C, np.nan)
        out_f[valid] = per_aid[flat_aid]
        return out_f.reshape(S, C)

    out["aid_candidate_score_mean"] = aid_broadcast(seg_mean(flat_aid, sc, n_aids))
    out["aid_candidate_score_std"] = aid_broadcast(seg_std(flat_aid, sc, n_aids))
    out["aid_candidate_score_max"] = aid_broadcast(seg_max(flat_aid, sc, n_aids))
    out["aid_session_candidate_occurrence_count_mean"] = aid_broadcast(seg_mean(flat_aid, occ_f, n_aids))
    out["aid_session_candidate_occurrence_count_sum"] = aid_broadcast(seg_sum(flat_aid, occ_f, n_aids))
    out["aid_session_candidate_occurrence_count_max"] = aid_broadcast(seg_max(flat_aid, occ_f, n_aids))
    out["aid_session_candidate_cumcount_last_mean"] = aid_broadcast(seg_nanmean(flat_aid, cum_f, n_aids))
    out["aid_session_candidate_cumcount_last_sum"] = aid_broadcast(seg_sum(flat_aid, cum_f0, n_aids))
    out["aid_session_candidate_cumcount_last_max"] = aid_broadcast(seg_nanmax(flat_aid, cum_f, n_aids))

    out["candidate_scores"] = scores.astype(np.float64)
    # explicit list position (not in the reference's 54 features; GBDTs can
    # reconstruct rank from monotone splits of candidate_scores, MLPs cannot)
    out["candidate_rank"] = np.where(
        valid.reshape(S, C), np.arange(C, dtype=np.float64)[None, :], np.nan
    )
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def assemble_features(
    feature_list: list[str],
    interaction: dict[str, np.ndarray],  # [S, C] matrices
    aid_features: dict[str, np.ndarray],  # [n_aids] vectors
    session_features: dict[str, np.ndarray],  # [S] vectors
    candidates: np.ndarray,  # [S, C] padded -1
) -> np.ndarray:
    """Build the [S, C, F] ranker feature tensor in feature-list order,
    joining aid features by candidate id and session features by row —
    the reference's feature merge (lgb_trainer.py:25-48)."""
    S, C = candidates.shape
    valid = candidates >= 0
    safe = np.where(valid, candidates, 0)
    cols = []
    for name in feature_list:
        if name in interaction:
            col = interaction[name]
        elif name in aid_features:
            col = np.where(valid, aid_features[name][safe], np.nan)
        elif name in session_features:
            col = np.broadcast_to(session_features[name][:, None], (S, C))
        else:
            raise KeyError(f"unknown feature {name!r}")
        cols.append(np.asarray(col, np.float32))
    return np.stack(cols, axis=-1)
