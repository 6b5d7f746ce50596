"""The two-stage production pipeline: ranker training and evaluation, and
prediction with trained artifacts.

Port of ``otto_tpu/twostage.py``.  The reference's four chained CLI
processes (SURVEY §3.4) become one call that passes arrays in memory:

1. the regular candidate generator emits [S, C] candidates and scores, and
   the covisitation heuristic's top-20 is unioned into the grid;
2. the three feature families assemble the [S, C, 55] tensor;
3. per event type, fold GBDT rankers are fit on it (histograms by the
   kernel K5; out-of-fold scores), or the fold-averaged trained ones score
   it (on the card one forest-kernel launch a model, which bins the float32
   rows itself);
4. the prior blend and the per-session top-20.

:func:`predict_two_stage` scores new sessions with trained artifacts.
:func:`run_two_stage` is the reference's train-and-evaluate call: per event
type it fits the fold GBDT rankers on the labeled target's candidate grid
(or reloads those an artifact directory holds), selects or reuses the
prior-blend alpha, reports and saves.  Both take a required ``device``:
candidates, the heuristic (when not given), the GBDT fits and the forest
pass run there.  A failed device pass raises; nothing falls back to the
CPU.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.config import CovisitConfig, GBDTConfig, SGNSConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.labels import SessionLabels
from otto_tpu_torch.eval.harness import RecallReport, evaluate_predictions
from otto_tpu_torch.eval.metrics import corpus_recall_at_k
from otto_tpu_torch.features import (
    RANKER_FEATURES,
    assemble_features,
    compute_aid_features,
    compute_interaction_features,
    compute_session_features,
)
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.models.candidates import CandidateSet, _label_dict, regular_candidates
from otto_tpu_torch.models.covisitation import (
    CovisitationMatrices,
    build_covisitation,
    covisit_heuristic_predictions,
)
from otto_tpu_torch.models.frequency import FrequencyStatistics
from otto_tpu_torch.models.embeddings import SGNSModel
from otto_tpu_torch.models.ensemble import robust_scale
from otto_tpu_torch.models.gbdt import GBDTRankerModel, load_ranker_model, train_gbdt_ranker
from otto_tpu_torch.models.ranker import RankerData, top_k_predictions
from otto_tpu_torch.utils.runtime import resolve_device

log = get_logger(__name__)


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


PRIOR_ALPHAS = (0.0, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0)


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


def _union_heuristic(cands: CandidateSet, heur_preds: dict[str, np.ndarray],
                     labels: SessionLabels | None, device: torch.device) -> dict[str, np.ndarray]:
    """Union each session's heuristic top-k into the candidate grid.

    Appends K extra columns holding heuristic picks missing from the grid
    (candgen score 0 — the ``heuristic_rank_score`` feature and prior carry
    their ordering), relabels the widened grid on ``device`` when ``labels``
    is given, and returns the per-type [S, C+K] heuristic-rank matrices.
    Guarantees the heuristic's exact top-20 is reachable by the reranker, so
    the prior blend at alpha = 0 reproduces the L4 heuristic and any
    selected alpha > 0 is measured lift over it.
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
    if labels is not None:
        cands.labels = _label_dict(cands.candidates, labels, device=device)
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


def _prior_scores(candidates: np.ndarray, scores: np.ndarray,
                  heur_rank: np.ndarray | None, alpha: float) -> np.ndarray:
    """The prior blend at a given ``alpha``: ``prior + alpha * tower`` over
    the robust-scaled prior and ranker scores, or at ``alpha = inf`` the
    scaled ranker scores alone."""
    tower_n = _blend_scores(candidates, [scores], [1.0])
    if not np.isfinite(alpha):
        return tower_n
    valid = candidates >= 0
    prior_n = _blend_scores(candidates, [_prior_matrix(candidates, heur_rank)], [1.0])
    tower_z = np.where(valid, tower_n, 0.0)  # avoid 0 * -inf = nan
    return np.where(valid, prior_n + alpha * tower_z, -np.inf)


def _prior_blend(candidates: np.ndarray, tower_scores: np.ndarray, eval_fn,
                 heur_rank: np.ndarray | None = None):
    """Blend the tower score with the candidate-ordering prior.

    The prior is the candidate-generator's ordering (session recency +
    covisitation votes) — or, when ``heur_rank`` is given, that ordering with
    the covisit heuristic's top-20 lifted above it, so alpha = 0 reproduces
    the L4 heuristic exactly.  ``score = prior + alpha * tower`` lets the
    learned model only refine it; ``alpha`` is selected per event type by
    recall over ``PRIOR_ALPHAS`` (alpha -> infinity recovers the pure
    tower).  Returns the chosen scores and alpha.
    """
    S, C = candidates.shape
    valid = candidates >= 0
    prior = _prior_matrix(candidates, heur_rank)
    prior_n = _blend_scores(candidates, [prior], [1.0])
    tower_n = _blend_scores(candidates, [tower_scores], [1.0])
    best_alpha, best_r, best_scores = 0.0, -1.0, prior_n
    idx = np.arange(S)
    tower_z = np.where(valid, tower_n, 0.0)  # avoid 0 * -inf = nan at alpha 0
    for alpha in PRIOR_ALPHAS:
        blended = np.where(valid, prior_n + alpha * tower_z, -np.inf)
        r = eval_fn(idx, blended)
        if r > best_r:
            best_alpha, best_r, best_scores = alpha, r, blended
    # also consider the pure tower (alpha = inf)
    r_tower = eval_fn(idx, tower_n)
    if r_tower > best_r:
        return tower_n, float("inf")
    return best_scores, best_alpha


def _recall_eval_fn(labels: SessionLabels, candidates: np.ndarray, etype: str, *,
                    device: torch.device):
    """The prior blend's selection metric: corpus recall@20 (on ``device``)
    of the top-20 reranked candidates on a subset of sessions."""
    padded = labels.padded(etype)

    def eval_recall(session_indices, scores):
        top = top_k_predictions(candidates[session_indices], scores, k=TOP_K)
        return float(corpus_recall_at_k(torch.as_tensor(top, device=device),
                                        torch.as_tensor(padded[session_indices], device=device),
                                        k=TOP_K))

    return eval_recall


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

    def save(self, directory, matrices: bool = True) -> None:
        """Persist everything needed to re-score new sessions (the
        reference's per-stage artifact files, SURVEY §5.3-5.4).
        ``matrices=False`` leaves ``covisitation/`` as it is (a run that
        resumed its tables from there)."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        if matrices:
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


def _heuristic_lists(train: EventStore, target: EventStore, matrices: CovisitationMatrices,
                     ft_neighbors: np.ndarray | None, n_aids: int, chunk_sessions: int,
                     dev: torch.device) -> dict[str, np.ndarray]:
    """The covisitation heuristic's top-20 of ``target`` on ``dev``; on the
    CPU through the host routes, as the JAX package does on a CPU backend."""
    stats = FrequencyStatistics.compute(train, n_aids=n_aids, device=dev)
    stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
    on_cpu = dev.type == "cpu"
    return covisit_heuristic_predictions(
        target, matrices, stats_top, ft_neighbors=ft_neighbors,
        chunk_sessions=chunk_sessions,
        recency_host_f64=on_cpu, covisit_host=on_cpu, device=dev,
    )


def _type_features(target: EventStore, cands: CandidateSet, etype: str,
                   heur_rank: dict[str, np.ndarray] | None, feature_list: list[str],
                   aid_feats: dict[str, np.ndarray], sess_feats: dict[str, np.ndarray],
                   n_aids: int) -> np.ndarray:
    """The ranker rows [S, C, F] of one event type's candidate grid."""
    c = cands.candidates[etype]
    inter = compute_interaction_features(target, c, cands.scores[etype], n_aids)
    if heur_rank is not None:
        hr = heur_rank[etype]
        K = TOP_K  # list width, not observed max rank
        inter["heuristic_rank_score"] = np.where(
            hr >= 0, (K - hr).astype(np.float32) / K, 0.0
        ).astype(np.float32)
    return assemble_features(feature_list, inter, aid_feats, sess_feats, c)


def _train_engine(data: RankerData, cfg, eval_recall, *, device: torch.device):
    """Fit one ranker of ``cfg``'s engine (``otto_tpu/twostage.py:45-53``):
    a ``GBDTConfig`` trains the fold GBDT on ``device``.  The listwise tower
    (the reference's ``RankerConfig``) is not ported and raises."""
    if not isinstance(cfg, GBDTConfig):
        raise NotImplementedError(f"{type(cfg).__name__}: only GBDTConfig trains here; the "
                                  "listwise tower is not ported yet (ROADMAP M12)")
    return train_gbdt_ranker(data, cfg, eval_recall=eval_recall, device=device)


def run_two_stage(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    covisit_config: CovisitConfig = CovisitConfig(),
    ranker_config: GBDTConfig = GBDTConfig(),
    second_ranker_config: GBDTConfig | None = None,
    blend_weights: tuple[float, float] = (0.5, 0.5),
    sgns_config: SGNSConfig | None = None,
    feature_list: list[str] = RANKER_FEATURES,
    uniq_cap: int = 64,
    k_covisit: int = 100,
    matrices: CovisitationMatrices | None = None,
    artifact_dir=None,
    selection_fraction: float = 0.5,
    selection_seed: int = 17,
    heuristic_union: bool = True,
    heuristic_preds: dict[str, np.ndarray] | None = None,
    chunk_sessions: int = 2048,
    aid_feats: dict[str, np.ndarray] | None = None,
    stats_out: dict | None = None,
    *,
    device: str | torch.device,
) -> TwoStageArtifacts:
    """Train and evaluate the two-stage pipeline on labeled ``target``
    sessions, on ``device`` (``otto_tpu/twostage.py:272-545``).

    ``train`` supplies statistics (covisitation, aid features); ``target``
    sessions receive candidates and predictions.  Per event type the ranker
    of ``ranker_config`` is fit on the type's candidate grid (folds,
    negative sampling, MAP@20 early stopping: :func:`train_gbdt_ranker`),
    and with ``second_ranker_config`` a second one, blended with the first
    by ``blend_weights`` (robust-scaled).  The prior blend's alpha is then
    selected over ``PRIOR_ALPHAS`` by recall on the *selection* sessions and
    stored in the ranker.  ``selection_fraction`` splits the target into
    those and a disjoint *report* subset scored by ``report_disjoint`` (the
    reference's OOF-vs-holdout split, src/ranker/inference.py:321-337);
    ``report`` covers all sessions, and fold recalls and early stopping see
    only the selection sessions.

    ``artifact_dir`` enables per-stage persistence and resume: what the
    directory holds is reloaded (``covisitation/``, ``sgns.npz`` when
    ``sgns_config`` is given, and each type's ``ranker_<type>.npz``, which
    then scores the target with one forest pass instead of training; its
    stored ``prior_alpha`` is reused, finite as ``prior + alpha * ranker``,
    ``inf`` as the ranker alone, NaN selected anew).  What is built or
    trained is saved there as it completes, rankers as
    ``ranker_<type>.npz`` and ``ranker_<type>_b.npz``, and the artifacts at
    the end (the covisitation tables only when they were passed in, since
    tables read from or built into the directory are there already).

    A tower config raises (ROADMAP M12), as does ``sgns_config`` without
    ``sgns.npz`` (SGNS training, S1); ``labels=None`` raises ``ValueError``,
    as in the reference (prediction is :func:`predict_two_stage`).
    ``stats_out`` receives the seconds of each stage, ``train_s`` the
    rankers' fits.
    """
    if labels is None:
        raise ValueError("run_two_stage evaluates labeled sessions; prediction-only mode "
                         "is predict_two_stage")
    adir = Path(artifact_dir) if artifact_dir is not None else None
    to_train = [t for t in EVENT_TYPES if adir is None or not (adir / f"ranker_{t}.npz").exists()]
    for cfg in (ranker_config, second_ranker_config):
        if to_train and cfg is not None and not isinstance(cfg, GBDTConfig):
            raise NotImplementedError(f"run_two_stage: {to_train} would train a "
                                      f"{type(cfg).__name__}; only GBDTConfig trains here, the "
                                      "listwise tower is not ported yet (ROADMAP M12)")
    if sgns_config is not None and (adir is None or not (adir / "sgns.npz").exists()):
        raise NotImplementedError("run_two_stage: sgns_config without sgns.npz in "
                                  "artifact_dir trains SGNS, which is not ported yet "
                                  "(ROADMAP S1)")
    if adir is not None:
        adir.mkdir(parents=True, exist_ok=True)
    dev = resolve_device(device)
    times = dict.fromkeys(("covisit_s", "candidates_s", "heuristic_s", "union_s",
                           "features_s", "forest_s", "train_s", "blend_s", "report_s",
                           "save_s"), 0.0)
    clock = time.perf_counter

    # ---- stage 0: representation models ----------------------------------
    t0 = clock()
    matrices_on_disk = matrices is None and adir is not None and (adir / "covisitation").is_dir()
    if matrices_on_disk:
        log.info("resuming covisitation matrices from %s", adir)
        matrices = CovisitationMatrices.load(adir / "covisitation")
    if matrices is None:
        log.info("building covisitation matrices over %d events", train.n_events)
        matrices = build_covisitation(train, n_aids, covisit_config, device=dev)
        if adir is not None:
            matrices.save(adir / "covisitation")
            matrices_on_disk = True
    sgns = None
    if sgns_config is not None:
        log.info("resuming SGNS embeddings from %s", adir)
        sgns = SGNSModel.load(adir / "sgns.npz", sgns_config, device=dev)
    ft_neighbors = sgns.neighbor_table(k=20) if sgns is not None else None
    times["covisit_s"] = clock() - t0

    # ---- stage 1: candidates ---------------------------------------------
    t0 = clock()
    cands = regular_candidates(
        target, matrices, ft_neighbors=ft_neighbors, labels=labels, uniq_cap=uniq_cap,
        wide_k=min(covisit_config.top_k_wide, matrices.tables["time_weighted"][0].shape[1]),
        k_covisit=k_covisit, chunk_sessions=chunk_sessions, device=dev,
    )
    times["candidates_s"] = clock() - t0
    heur_rank = None
    if heuristic_union:
        # union the L4 heuristic's top-20 into the grid and expose its
        # ordering as a feature + the blend prior: alpha = 0 recovers it
        # exactly, and any selected alpha > 0 is measured lift over it
        if heuristic_preds is None:
            t0 = clock()
            heuristic_preds = _heuristic_lists(train, target, matrices, ft_neighbors, n_aids,
                                               chunk_sessions, dev)
            times["heuristic_s"] = clock() - t0
        t0 = clock()
        heur_rank = _union_heuristic(cands, heuristic_preds, labels, dev)
        feature_list = list(feature_list) + ["heuristic_rank_score"]
        times["union_s"] = clock() - t0
    max_recall = cands.max_recall_report(labels, device=dev)

    # ---- stage 2: features ------------------------------------------------
    t0 = clock()
    if aid_feats is None:
        aid_feats = compute_aid_features(_union_stats_store(train, target), n_aids)
    sess_feats = compute_session_features(target, aid_feats)
    times["features_s"] += clock() - t0

    # ---- stage 3: per-type ranker training or resume, and the prior blend -
    sel_mask = None
    if 0.0 < selection_fraction < 1.0:
        sel_mask = (np.random.default_rng(selection_seed).random(target.n_sessions)
                    < selection_fraction)
        if sel_mask.all() or not sel_mask.any():  # degenerate tiny inputs
            sel_mask = None
    rankers: dict[str, GBDTRankerModel] = {}
    predictions: dict[str, np.ndarray] = {}
    for etype in EVENT_TYPES:
        c = cands.candidates[etype]
        t0 = clock()
        X = _type_features(target, cands, etype, heur_rank, feature_list, aid_feats,
                           sess_feats, n_aids)
        times["features_s"] += clock() - t0
        eval_fn = _recall_eval_fn(labels, c, etype, device=dev)
        if sel_mask is not None:
            # restrict alpha / early-stop selection to the selection half
            raw_eval = eval_fn

            def eval_fn(session_indices, s, _raw=raw_eval):
                keep = sel_mask[session_indices]
                if not keep.any():
                    return _raw(session_indices, s)
                return _raw(session_indices[keep], s[keep])

        rk_path = adir / f"ranker_{etype}.npz" if adir is not None else None
        resumed = rk_path is not None and rk_path.exists()
        if resumed:
            # crash resume: reload the finished fold models and score with
            # them (fold-averaged rather than OOF)
            log.info("resuming %s ranker from %s", etype, rk_path)
            t0 = clock()
            model = load_ranker_model(rk_path)
            scores = model.predict(X, c >= 0, device=dev)
            times["forest_s"] += clock() - t0
        else:
            data = RankerData(features=X, labels=cands.labels[etype], mask=c >= 0,
                              session_ids=target.session_ids, candidates=c,
                              feature_names=list(feature_list))
            t0 = clock()
            model, scores = _train_engine(data, ranker_config, eval_fn, device=dev)
            if second_ranker_config is not None:
                # the reference blends a LightGBM and an XGBoost reranker
                # (ranker/inference.py:64-85): a second model, robust-scaled
                # weighted blend
                rankers[f"{etype}_b"], scores_b = _train_engine(data, second_ranker_config,
                                                                eval_fn, device=dev)
                scores = _blend_scores(c, [scores, scores_b], list(blend_weights))
            times["train_s"] += clock() - t0
            del data
        del X
        rankers[etype] = model
        t0 = clock()
        hr = None if heur_rank is None else heur_rank[etype]
        if resumed and not np.isnan(model.prior_alpha):  # the alpha selected before
            scores = _prior_scores(c, scores, hr, model.prior_alpha)
        else:
            scores, model.prior_alpha = _prior_blend(c, scores, eval_fn, heur_rank=hr)
            log.info("%s: prior-blend alpha %.2f", etype, model.prior_alpha)
        predictions[etype] = top_k_predictions(c, scores, k=TOP_K)
        times["blend_s"] += clock() - t0
        if adir is not None and not resumed:
            t0 = clock()
            model.save(rk_path)
            if f"{etype}_b" in rankers:
                rankers[f"{etype}_b"].save(adir / f"ranker_{etype}_b.npz")
            times["save_s"] += clock() - t0

    t0 = clock()
    report = evaluate_predictions(labels, predictions["clicks"], predictions["carts"],
                                  predictions["orders"], device=dev)
    log.info("two-stage validation scores\n%s", report)
    report_disjoint = None
    if sel_mask is not None:
        holdout = np.flatnonzero(~sel_mask)
        report_disjoint = evaluate_predictions(
            labels.take(holdout), predictions["clicks"][holdout],
            predictions["carts"][holdout], predictions["orders"][holdout], device=dev)
        log.info("two-stage scores on the %d selection-disjoint sessions\n%s",
                 len(holdout), report_disjoint)
    times["report_s"] = clock() - t0

    artifacts = TwoStageArtifacts(
        matrices=matrices, sgns=sgns, candidates=cands, rankers=rankers,
        predictions=predictions, report=report, max_recall=max_recall,
        selection_mask=sel_mask, report_disjoint=report_disjoint,
        heuristic_union=heuristic_union, feature_list=list(feature_list),
    )
    if adir is not None:
        t0 = clock()
        artifacts.save(adir, matrices=not matrices_on_disk)
        times["save_s"] += clock() - t0
    if stats_out is not None:
        stats_out.update(times)
    return artifacts


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
            t0 = clock()
            heuristic_preds = _heuristic_lists(train, target, artifacts.matrices, ft_neighbors,
                                               n_aids, chunk_sessions, dev)
            times["heuristic_s"] = clock() - t0
        t0 = clock()
        heur_rank = _union_heuristic(cands, heuristic_preds, None, dev)
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
        X = _type_features(target, cands, etype, heur_rank, feature_list, aid_feats,
                           sess_feats, n_aids)
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
        del X, x
        t0 = clock()
        scores = (per_model[0] if second is None
                  else _blend_scores(c, per_model, [0.5, 0.5]))
        if stats_out is not None:
            stats_out[f"rows_{etype}"] = int(np.prod(c.shape))
        if np.isfinite(model.prior_alpha):
            scores = _prior_scores(c, scores, None if heur_rank is None else heur_rank[etype],
                                   model.prior_alpha)
        out[etype] = top_k_predictions(c, scores, k=TOP_K)
        times["blend_s"] += clock() - t0
    if stats_out is not None:
        stats_out.update(times)
    return out
