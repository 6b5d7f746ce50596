"""Score blending across ranker models.

Copied from ``otto_tpu/models/ensemble.py`` (numpy, pyarrow).  It
reproduces src/ranker/inference.py:14-55 + :64-85: per-model prediction
tables are robust-scaled (median/IQR — sklearn RobustScaler semantics),
outer-joined on (session, aid) with missing scores as 0, combined with fixed
convex weights, and cut to the per-session top-20.  The scaling stays in
numpy float64: ``np.median`` and ``np.percentile`` are what the reference
computes (``torch.quantile`` interpolates differently).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from otto_tpu_torch.logging_utils import get_logger

log = get_logger(__name__)


def robust_scale(scores: np.ndarray) -> np.ndarray:
    """(x - median) / IQR (sklearn RobustScaler on a single column)."""
    med = np.median(scores)
    q1, q3 = np.percentile(scores, [25, 75])
    iqr = q3 - q1
    if iqr == 0:
        return scores - med
    return (scores - med) / iqr


@dataclass
class ModelPredictions:
    """Flat (session, aid, score) predictions of one model for one event type."""

    session: np.ndarray  # int64 [n]
    aid: np.ndarray  # int32 [n]
    score: np.ndarray  # float32 [n]

    def scaled(self) -> "ModelPredictions":
        return ModelPredictions(self.session, self.aid, robust_scale(self.score.astype(np.float64)).astype(np.float32))


def blend(
    predictions: dict[str, ModelPredictions],
    weights: dict[str, float],
    k: int = 20,
    scale: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Outer-join per-model scores on (session, aid), weight, and take the
    per-session top-k.

    Returns (session_ids [S], top_aids int32 [S, k] padded -1), sessions
    sorted ascending.
    """
    # global key space
    all_sessions = np.unique(np.concatenate([p.session for p in predictions.values()]))
    sess_index = {s: i for i, s in enumerate(all_sessions)}

    keys_list, scores_list = [], []
    for name, pred in predictions.items():
        p = pred.scaled() if scale else pred
        w = weights[name]
        sidx = np.searchsorted(all_sessions, p.session)
        key = sidx.astype(np.int64) << 32 | p.aid.astype(np.int64)
        keys_list.append(key)
        scores_list.append(w * p.score.astype(np.float64))

    keys = np.concatenate(keys_list)
    scores = np.concatenate(scores_list)
    order = np.argsort(keys, kind="stable")
    keys, scores = keys[order], scores[order]
    head = np.concatenate([[True], keys[1:] != keys[:-1]])
    starts = np.flatnonzero(head)
    blended = np.add.reduceat(scores, starts)
    ukeys = keys[starts]
    sidx = (ukeys >> 32).astype(np.int64)
    aids = (ukeys & 0xFFFFFFFF).astype(np.int32)

    # per-session top-k by blended score (desc), stable
    order2 = np.lexsort((-blended, sidx))
    sidx, aids, blended = sidx[order2], aids[order2], blended[order2]
    group_start = np.concatenate([[True], sidx[1:] != sidx[:-1]])
    start_idx = np.maximum.accumulate(np.where(group_start, np.arange(len(sidx)), 0))
    rank = np.arange(len(sidx)) - start_idx
    keep = rank < k
    out = np.full((len(all_sessions), k), -1, np.int32)
    out[sidx[keep], rank[keep]] = aids[keep]
    return all_sessions, out


# --------------------------------------------------------------------- files
# The reference's multi-model ensemble is file-coupled: each ranker (own or
# teammate) persists flat per-candidate scores, and the final inference stage
# loads N such files per event type, robust-scales, outer-joins and blends
# (src/ranker/inference.py:14-55,123-140,345-366).  Formats here: .npz with
# arrays (session, aid, score) or .parquet with those columns.


def save_predictions(path, session: np.ndarray, aid: np.ndarray, score: np.ndarray) -> None:
    """Persist one model's flat per-candidate scores for later blending."""
    from pathlib import Path

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".npz":
        np.savez_compressed(path, session=session.astype(np.int64),
                            aid=aid.astype(np.int32), score=score.astype(np.float32))
    elif path.suffix in (".parquet", ".pqt"):
        import pyarrow as pa
        import pyarrow.parquet as pq

        pq.write_table(
            pa.table({"session": session.astype(np.int64), "aid": aid.astype(np.int32),
                      "score": score.astype(np.float32)}), path)
    else:
        raise ValueError(f"unsupported prediction file format: {path.suffix}")


def read_predictions(path) -> ModelPredictions:
    """Load one model's prediction file (the reference's ``read_predictions``
    contract, src/ranker/inference.py:14-55; scaling happens in
    :func:`blend`)."""
    from pathlib import Path

    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return ModelPredictions(z["session"], z["aid"], z["score"])
    if path.suffix in (".parquet", ".pqt"):
        import pyarrow.parquet as pq

        t = pq.read_table(path, columns=["session", "aid", "score"])
        return ModelPredictions(
            t["session"].to_numpy().astype(np.int64),
            t["aid"].to_numpy().astype(np.int32),
            t["score"].to_numpy().astype(np.float32),
        )
    raise ValueError(f"unsupported prediction file format: {path.suffix}")


def candidate_set_predictions(candidates: np.ndarray, scores: np.ndarray,
                              session_ids: np.ndarray) -> ModelPredictions:
    """Flatten a [S, C] candidate grid into the flat prediction layout."""
    valid = candidates >= 0
    return ModelPredictions(
        np.repeat(session_ids, valid.sum(axis=1)),
        candidates[valid].astype(np.int32),
        scores[valid].astype(np.float32),
    )


def blend_files(
    manifest: dict[str, dict[str, dict]],
    k: int = 20,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Blend per-event-type prediction files.

    ``manifest[etype][model_name] = {"path": ..., "weight": w}`` — the
    reference's fixed convex weight dicts (src/ranker/inference.py:64-85).
    Returns ``etype -> (session_ids [S], top_aids [S, k])``.
    """
    out = {}
    for etype, models in manifest.items():
        preds = {name: read_predictions(spec["path"]) for name, spec in models.items()}
        weights = {name: float(spec.get("weight", 1.0 / len(models)))
                   for name, spec in models.items()}
        log.info("%s: blending %d models with weights %s", etype, len(preds), weights)
        out[etype] = blend(preds, weights, k=k)
    return out


def align_to_sessions(session_ids: np.ndarray, blended: tuple[np.ndarray, np.ndarray],
                      k: int = 20) -> np.ndarray:
    """Re-index blended (sessions, top_aids) onto a caller-supplied session
    order; sessions with no predictions get all -1 rows."""
    b_sessions, b_top = blended
    out = np.full((len(session_ids), k), -1, np.int32)
    pos = np.searchsorted(b_sessions, session_ids)
    pos_c = np.minimum(pos, len(b_sessions) - 1)
    hit = (len(b_sessions) > 0) & (b_sessions[pos_c] == session_ids)
    out[hit] = b_top[pos_c[hit], :k]
    return out
