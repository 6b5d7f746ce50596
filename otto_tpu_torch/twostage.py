"""The two-stage production pipeline: prediction with trained artifacts.

Port of the prediction half of ``otto_tpu/twostage.py``.  The reference's
four chained CLI processes (SURVEY §3.4) become one call that passes arrays
in memory:

1. the regular candidate generator emits [S, C] candidates and scores, and
   the covisitation heuristic's top-20 is unioned into the grid;
2. the three feature families assemble the [S, C, 55] tensor;
3. per event type, the fold-averaged GBDT scores it (on the card one
   forest-kernel launch a model, which bins the float32 rows itself);
4. the prior blend and the per-session top-20.

:func:`predict_two_stage` takes a required ``device``: candidates, the
heuristic (when not given) and the forest pass run there.  A failed device
pass raises; nothing falls back to the CPU.  Training (``run_two_stage``)
waits for GBDT training (ROADMAP M9) and raises.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.config import CovisitConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.eval.harness import RecallReport
from otto_tpu_torch.features import (
    RANKER_FEATURES,
    assemble_features,
    compute_aid_features,
    compute_interaction_features,
    compute_session_features,
)
from otto_tpu_torch.models.candidates import CandidateSet, regular_candidates
from otto_tpu_torch.models.covisitation import CovisitationMatrices
from otto_tpu_torch.models.embeddings import SGNSModel
from otto_tpu_torch.models.ensemble import robust_scale
from otto_tpu_torch.models.gbdt import GBDTRankerModel, load_ranker_model
from otto_tpu_torch.models.ranker import top_k_predictions
from otto_tpu_torch.utils.runtime import resolve_device


def _blend_scores(candidates: np.ndarray, score_mats: list[np.ndarray],
                  weights: list[float]) -> np.ndarray:
    """Robust-scaled weighted blend of [S, C] score matrices over the same
    candidate grid (the in-grid specialization of models/ensemble.blend)."""
    valid = candidates >= 0
    out = np.zeros_like(score_mats[0], dtype=np.float64)
    for w, s in zip(weights, score_mats):
        scaled = np.zeros_like(out)
        finite = valid & np.isfinite(s)
        scaled[finite] = robust_scale(s[finite].astype(np.float64))
        out += w * scaled
    return np.where(valid, out, -np.inf).astype(np.float32)


def _heuristic_rank_matrix(candidates: np.ndarray, heur: np.ndarray, chunk: int = 8192):
    """Per-candidate rank in the session's heuristic top-k list.

    Returns ``rank`` int32 [S, C] (0-based position in ``heur``, -1 if the
    candidate is not in the heuristic list) and ``present`` bool [S, K]
    (heuristic entry already covered by the candidate grid).  Chunked
    broadcast keeps the [chunk, C, K] equality tensor small.
    """
    S, C = candidates.shape
    K = heur.shape[1]
    rank = np.full((S, C), -1, np.int32)
    present = np.zeros((S, K), bool)
    for s0 in range(0, S, chunk):
        s1 = min(s0 + chunk, S)
        c = candidates[s0:s1]
        h = heur[s0:s1]
        eq = (c[:, :, None] == h[:, None, :]) & (c >= 0)[:, :, None] & (h >= 0)[:, None, :]
        any_c = eq.any(axis=2)
        rank[s0:s1] = np.where(any_c, eq.argmax(axis=2).astype(np.int32), -1)
        present[s0:s1] = eq.any(axis=1)
    return rank, present


def _union_heuristic(cands: CandidateSet,
                     heur_preds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Union each session's heuristic top-k into the candidate grid.

    Appends K extra columns holding heuristic picks missing from the grid
    (candgen score 0 — the ``heuristic_rank_score`` feature and prior carry
    their ordering) and returns the per-type [S, C+K] heuristic-rank
    matrices.  Guarantees the heuristic's exact top-20 is reachable by the
    reranker, so the prior blend at alpha = 0 reproduces the L4 heuristic.
    (The reference also relabels the widened grid for its training caller;
    that comes with training, ROADMAP M10.)
    """
    heur_rank: dict[str, np.ndarray] = {}
    for etype in EVENT_TYPES:
        c = cands.candidates[etype]
        sc = cands.scores[etype]
        h = heur_preds[etype]
        S, _ = c.shape
        K = h.shape[1]
        _, present = _heuristic_rank_matrix(c, h)
        missing = (~present) & (h >= 0)  # [S, K]
        ext = np.full((S, K), -1, np.int32)
        pos = np.cumsum(missing, axis=1) - 1
        r, kk = np.nonzero(missing)
        ext[r, pos[r, kk]] = h[r, kk]
        cands.candidates[etype] = np.concatenate([c, ext], axis=1)
        cands.scores[etype] = np.concatenate([sc, np.zeros((S, K), sc.dtype)], axis=1)
        rank, _ = _heuristic_rank_matrix(cands.candidates[etype], h)
        heur_rank[etype] = rank
    return heur_rank


def _prior_matrix(candidates: np.ndarray, heur_rank: np.ndarray | None):
    """Rank-prior score matrix: candgen order, with heuristic-list members
    lifted strictly above it in heuristic order (top-20 by this prior is then
    exactly the heuristic's list)."""
    S, C = candidates.shape
    valid = candidates >= 0
    prior = np.where(valid, -np.arange(C, dtype=np.float32)[None, :], -np.inf)
    if heur_rank is not None:
        # K pinned to the heuristic list width (ranks are positions in a
        # top-TOP_K list) so training and prediction share the same scale
        K = TOP_K
        prior = np.where(
            (heur_rank >= 0) & valid,
            (C + K - heur_rank).astype(np.float32),
            prior,
        )
    return prior


@dataclass
class TwoStageArtifacts:
    """What prediction needs from training: covisitation matrices, the
    optional SGNS model, the per-type GBDT rankers, and the training-time
    settings prediction must reproduce (whether the heuristic top-k was
    unioned into the grid, the feature list the rankers were fit on).
    ``save``/``load`` use the JAX package's directory layout."""

    matrices: CovisitationMatrices
    sgns: SGNSModel | None
    candidates: CandidateSet | None
    rankers: dict[str, GBDTRankerModel]
    predictions: dict[str, np.ndarray]  # etype -> [S, 20]
    report: RecallReport | None
    max_recall: dict[str, float] = field(default_factory=dict)
    selection_mask: np.ndarray | None = None
    report_disjoint: RecallReport | None = None
    heuristic_union: bool = True
    feature_list: list[str] | None = None

    def save(self, directory) -> None:
        """Persist everything needed to re-score new sessions (the
        reference's per-stage artifact files, SURVEY §5.3-5.4)."""
        d = Path(directory)
        (d / "covisitation").mkdir(parents=True, exist_ok=True)
        self.matrices.save(d / "covisitation")
        if self.sgns is not None:
            self.sgns.save(d / "sgns.npz")
        for name, model in self.rankers.items():
            model.save(d / f"ranker_{name}.npz")
        np.savez_compressed(d / "predictions.npz", **self.predictions)
        meta = {
            "ranker_names": sorted(self.rankers),
            "has_sgns": self.sgns is not None,
            "max_recall": self.max_recall,
            "heuristic_union": bool(self.heuristic_union),
            "feature_list": self.feature_list,
        }
        (d / "meta.json").write_text(json.dumps(meta, indent=1))

    @classmethod
    def load(cls, directory, *, device: str | torch.device) -> "TwoStageArtifacts":
        """Read a directory written by either package's ``save``; the SGNS
        model (if any) is placed on ``device``.  Only GBDT rankers load."""
        d = Path(directory)
        meta = json.loads((d / "meta.json").read_text())
        matrices = CovisitationMatrices.load(d / "covisitation")
        sgns = SGNSModel.load(d / "sgns.npz", device=device) if meta["has_sgns"] else None
        rankers = {name: load_ranker_model(d / f"ranker_{name}.npz")
                   for name in meta["ranker_names"]}
        with np.load(d / "predictions.npz") as z:
            preds = {k: z[k] for k in z.files}
        return cls(matrices, sgns, None, rankers, preds, None,
                   max_recall=meta["max_recall"],
                   heuristic_union=meta.get("heuristic_union", True),
                   feature_list=meta.get("feature_list"))


def run_two_stage(*args, **kwargs):
    """Train and evaluate the two-stage pipeline: not ported yet."""
    raise NotImplementedError("run_two_stage (training) needs GBDT training, which is not "
                              "ported yet (ROADMAP M9); use predict_two_stage with trained "
                              "artifacts")


def _union_stats_store(train: EventStore, target: EventStore) -> EventStore:
    """train ∪ target events, the store the aid features are computed over
    (the reference computes them over the full split union,
    aid_feature_engineering.py:29-38)."""
    return EventStore.from_flat(
        np.concatenate([train.session_ids[train.session_idx],
                        target.session_ids[target.session_idx]]),
        np.concatenate([train.aid, target.aid]),
        np.concatenate([train.ts, target.ts]),
        np.concatenate([train.type, target.type]),
    )


def predict_two_stage(
    artifacts: TwoStageArtifacts,
    train: EventStore,
    target: EventStore,
    n_aids: int,
    feature_list: list[str] | None = None,
    uniq_cap: int = 64,
    k_covisit: int = 100,
    heuristic_union: bool | None = None,
    aid_feats: dict[str, np.ndarray] | None = None,
    heuristic_preds: dict[str, np.ndarray] | None = None,
    chunk_sessions: int = 2048,
    wide_k: int | None = None,
    stats_out: dict | None = None,
    *,
    device: str | torch.device,
) -> dict[str, np.ndarray]:
    """Score new sessions with already-trained artifacts (submission mode):
    per event type a [S, 20] list, padded -1.

    ``heuristic_union`` and ``feature_list`` default to the training-time
    settings recorded in the artifacts (meta.json); pass them only to
    override.  ``heuristic_preds`` (per type [S, 20]) skips computing the
    heuristic; otherwise it runs on ``device`` (on the CPU through the host
    routes, as the JAX package does on a CPU backend).  ``stats_out``
    receives ``rows_<type>`` (ranker rows scored) and the seconds of each
    stage: ``candidates_s``, ``heuristic_s``, ``union_s``, ``features_s``
    (aid, session, interaction features and assembly), ``binning_s``,
    ``forest_s`` and ``blend_s`` (prior blend and top-20).  On the card the
    forest kernel bins the float32 rows itself: ``binning_s`` is 0 and
    ``forest_s`` holds the rows' upload (once a type), the launches and the
    scores' download.  On the CPU ``binning_s`` is the twin's binning and
    ``forest_s`` the twin's routing.
    """
    dev = resolve_device(device)
    times = dict.fromkeys(("candidates_s", "heuristic_s", "union_s", "features_s",
                           "binning_s", "forest_s", "blend_s"), 0.0)
    clock = time.perf_counter
    if heuristic_union is None:
        heuristic_union = artifacts.heuristic_union
    if feature_list is None:
        if artifacts.feature_list is not None:
            # strip the union-added column; it is re-appended below iff union
            feature_list = [f for f in artifacts.feature_list
                            if f != "heuristic_rank_score"]
        else:
            feature_list = RANKER_FEATURES
    t0 = clock()
    ft_neighbors = artifacts.sgns.neighbor_table(k=20) if artifacts.sgns is not None else None
    if wide_k is None:
        # mirror the training-time candgen width
        wide_k = min(CovisitConfig().top_k_wide,
                     artifacts.matrices.tables["time_weighted"][0].shape[1])
    cands = regular_candidates(
        target, artifacts.matrices, ft_neighbors=ft_neighbors,
        uniq_cap=uniq_cap, k_covisit=k_covisit,
        chunk_sessions=chunk_sessions, wide_k=wide_k, device=dev,
    )
    times["candidates_s"] = clock() - t0
    heur_rank = None
    if heuristic_union:
        if heuristic_preds is None:
            from otto_tpu_torch.models.covisitation import covisit_heuristic_predictions
            from otto_tpu_torch.models.frequency import FrequencyStatistics

            t0 = clock()
            stats = FrequencyStatistics.compute(train, n_aids=n_aids, device=dev)
            stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
            on_cpu = dev.type == "cpu"
            heuristic_preds = covisit_heuristic_predictions(
                target, artifacts.matrices, stats_top, ft_neighbors=ft_neighbors,
                chunk_sessions=chunk_sessions,
                recency_host_f64=on_cpu, covisit_host=on_cpu, device=dev,
            )
            times["heuristic_s"] = clock() - t0
        t0 = clock()
        heur_rank = _union_heuristic(cands, heuristic_preds)
        feature_list = list(feature_list) + ["heuristic_rank_score"]
        times["union_s"] = clock() - t0
    t0 = clock()
    if aid_feats is None:
        aid_feats = compute_aid_features(_union_stats_store(train, target), n_aids)
    sess_feats = compute_session_features(target, aid_feats)
    times["features_s"] += clock() - t0
    out = {}
    for etype in EVENT_TYPES:
        c = cands.candidates[etype]
        t0 = clock()
        inter = compute_interaction_features(target, c, cands.scores[etype], n_aids)
        if heur_rank is not None:
            hr = heur_rank[etype]
            K = TOP_K  # list width, not observed max rank
            inter["heuristic_rank_score"] = np.where(
                hr >= 0, (K - hr).astype(np.float32) / K, 0.0
            ).astype(np.float32)
        X = assemble_features(feature_list, inter, aid_feats, sess_feats, c)
        mask = c >= 0
        times["features_s"] += clock() - t0
        # the type's ranker, and a second one to blend with where training
        # fit one (the reference's LightGBM + XGBoost pair)
        model = artifacts.rankers[etype]
        second = artifacts.rankers.get(f"{etype}_b")
        t0 = clock()
        x = torch.as_tensor(X.reshape(-1, X.shape[-1]), device=dev)  # one upload, both rankers
        times["forest_s"] += clock() - t0
        per_model = []
        for m in (model,) if second is None else (model, second):
            t0, binning = clock(), times["binning_s"]
            # on the card one kernel launch bins and routes the rows; on the
            # CPU the twins, with the binning timed apart
            scores = m.predict_rows(x, times).cpu().numpy().reshape(c.shape)
            times["forest_s"] += clock() - t0 - (times["binning_s"] - binning)
            per_model.append(np.where(mask, scores, -np.inf))
        del X, x, inter
        t0 = clock()
        scores = (per_model[0] if second is None
                  else _blend_scores(c, per_model, [0.5, 0.5]))
        if stats_out is not None:
            stats_out[f"rows_{etype}"] = int(np.prod(c.shape))
        alpha = getattr(model, "prior_alpha", float("nan"))
        if np.isfinite(alpha):
            prior = _prior_matrix(c, None if heur_rank is None else heur_rank[etype])
            prior_n = _blend_scores(c, [prior], [1.0])
            tower_n = _blend_scores(c, [scores], [1.0])
            tower_z = np.where(mask, tower_n, 0.0)  # avoid 0 * -inf = nan
            scores = np.where(mask, prior_n + alpha * tower_z, -np.inf)
        out[etype] = top_k_predictions(c, scores, k=TOP_K)
        times["blend_s"] += clock() - t0
    if stats_out is not None:
        stats_out.update(times)
    return out
