"""Streamed two-stage serving: the production path at reference scale.

Port of ``otto_tpu/streaming.py``.  The reference serves its two-stage
pipeline over millions of sessions by manual file-sharding
(src/ranker/regular_candidate_generation.py:226-257,
src/ranker/lgb_trainer.py:248-263), because the exploded [sessions x
candidates x features] plane does not fit in memory at once.
:func:`run_two_stage_streamed` is one call that

1. trains the per-type rankers on a labeled *subsample* of the target
   sessions through :func:`otto_tpu_torch.twostage.run_two_stage` (folds,
   negative sampling, selection-half alpha, heuristic union), unless
   trained ``artifacts`` are given, and
2. streams candidate generation -> feature assembly -> fold-averaged ranker
   prediction -> prior blend -> top-20 over the other sessions in bounded
   session shards, so peak memory is one shard's feature plane.

The global aid feature table is computed ONCE over the full train+target
union and shared by the training call and every shard.  Because training
never sees the streamed sessions, every streamed session is
training-disjoint, and the evaluation over them is an unbiased lift
measurement; with given ``artifacts``, ``exclude_train_subset`` leaves out
the training subsample drawn earlier (the same ``train_subset_indices``
draw) to the same end.  The interaction features aggregate over the
sessions scored together, so a session's list can depend on its shard
(ROADMAP §3).
"""

from __future__ import annotations

import resource
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.config import CovisitConfig, GBDTConfig, SGNSConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.labels import SessionLabels
from otto_tpu_torch.eval.harness import RecallReport, evaluate_predictions, paired_bootstrap_lift
from otto_tpu_torch.features import RANKER_FEATURES, compute_aid_features
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.models.covisitation import (
    CovisitationMatrices,
    build_covisitation,
    covisit_heuristic_predictions,
)
from otto_tpu_torch.models.frequency import FrequencyStatistics
from otto_tpu_torch.twostage import (
    TwoStageArtifacts,
    _union_stats_store,
    predict_two_stage,
    run_two_stage,
)
from otto_tpu_torch.utils.runtime import resolve_device

log = get_logger(__name__)


def _rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


@dataclass
class StreamedResult:
    """Everything the streamed run produced, plus per-stage accounting."""

    artifacts: TwoStageArtifacts
    predictions: dict[str, np.ndarray]  # etype -> [S_streamed, 20]
    heuristic_predictions: dict[str, np.ndarray]
    streamed_idx: np.ndarray  # target session indices that were streamed
    report: RecallReport | None
    heuristic_report: RecallReport | None
    bootstrap_vs_heuristic: dict | None
    timings: dict = field(default_factory=dict)
    shard_times: list = field(default_factory=list)

    @property
    def lift_vs_heuristic(self) -> float:
        if self.report is None or self.heuristic_report is None:
            return float("nan")
        return self.report.weighted - self.heuristic_report.weighted


def train_subset_indices(n_sessions: int, train_sessions: int, seed: int) -> np.ndarray:
    """The deterministic training-subsample draw.  Factored out so consumers
    that must EXCLUDE the fit subsample later (bench artifact mode,
    prediction-only reruns) reproduce the identical index set."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n_sessions, size=min(train_sessions, n_sessions),
                              replace=False))


def run_two_stage_streamed(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    ranker_config: GBDTConfig = GBDTConfig(),
    covisit_config: CovisitConfig = CovisitConfig(),
    sgns_config: SGNSConfig | None = None,
    train_sessions: int = 50_000,
    shard_sessions: int = 100_000,
    selection_fraction: float = 0.5,
    selection_seed: int = 17,
    train_subset_seed: int = 23,
    heuristic_union: bool = True,
    chunk_sessions: int = 2048,
    k_covisit: int = 100,
    uniq_cap: int = 64,
    matrices: CovisitationMatrices | None = None,
    artifacts: TwoStageArtifacts | None = None,
    artifact_dir=None,
    n_boot: int = 1000,
    feature_list: list[str] = RANKER_FEATURES,
    progress_cb=None,
    exclude_train_subset: bool = False,
    max_stream_sessions: int = 0,
    *,
    device: str | torch.device,
) -> StreamedResult:
    """Train on a subsample, stream-predict the rest of ``target``, on
    ``device``.

    ``train_sessions`` target sessions (drawn with ``train_subset_seed``;
    requires ``labels``) fit the rankers through :func:`run_two_stage`
    (``ranker_config``, ``sgns_config``, ``selection_fraction``,
    ``feature_list``; resumed from ``artifact_dir`` where it holds them),
    and every OTHER target session is scored in ``shard_sessions``-sized
    shards.  With ``artifacts`` given, training is skipped and every target
    session streams (less the training subsample with
    ``exclude_train_subset``): prediction-only mode, the reference's
    submission path.  ``max_stream_sessions`` caps the streamed sessions.

    Each shard runs the covisitation heuristic, then
    :func:`predict_two_stage` with it unioned in.  With ``labels`` both are
    evaluated over the streamed sessions, with a paired bootstrap of the
    lift (``n_boot`` draws seeded by ``selection_seed``).  The covisitation
    tables are ``matrices``, the artifacts', or built on ``device``.  An
    ``artifact_dir`` holding ``aid_feats.npz`` supplies the global aid
    features; otherwise they are computed and saved there.  Returns per-stage
    timings (``train_s`` and ``train_sessions`` for the fit) including
    per-shard (heuristic, predict) wall seconds, rows predicted, and peak
    RSS.
    """
    dev = resolve_device(device)
    timings: dict = {"rss_start_gb": round(_rss_gb(), 2)}
    t_all = time.time()

    # ---- stage 0: shared statistics --------------------------------------
    t0 = time.time()
    if matrices is None and artifacts is not None:
        matrices = artifacts.matrices
    if matrices is None:
        log.info("streamed: building covisitation over %d events", train.n_events)
        matrices = build_covisitation(train, n_aids, covisit_config, device=dev)
    timings["covisit_build_s"] = round(time.time() - t0, 1)

    t0 = time.time()
    stats = FrequencyStatistics.compute(train, n_aids=n_aids, device=dev)
    stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
    aid_feats = None
    if artifact_dir is not None:
        af_path = Path(artifact_dir) / "aid_feats.npz"
        if af_path.exists():
            with np.load(af_path) as z:
                aid_feats = {k: z[k] for k in z.files}
            log.info("streamed: aid features resumed from %s", af_path)
    if aid_feats is None:
        aid_feats = compute_aid_features(_union_stats_store(train, target), n_aids)
        if artifact_dir is not None:
            Path(artifact_dir).mkdir(parents=True, exist_ok=True)
            np.savez(Path(artifact_dir) / "aid_feats.npz", **aid_feats)
    timings["global_features_s"] = round(time.time() - t0, 1)
    timings["rss_after_features_gb"] = round(_rss_gb(), 2)

    # ---- stage 1: train rankers on the subsample -------------------------
    S = target.n_sessions
    train_mask = np.zeros(S, bool)
    timings["train_s"] = 0.0
    timings["train_sessions"] = 0
    if artifacts is None:
        if labels is None:
            raise ValueError("training mode requires labels; pass artifacts "
                             "for prediction-only streaming")
        train_idx = train_subset_indices(S, train_sessions, train_subset_seed)
        train_mask[train_idx] = True
        t0 = time.time()
        log.info("streamed: training rankers on %d of %d target sessions", len(train_idx), S)
        artifacts = run_two_stage(
            train, target.select_sessions(train_mask), n_aids, labels=labels.take(train_idx),
            covisit_config=covisit_config, ranker_config=ranker_config,
            sgns_config=sgns_config, matrices=matrices,
            selection_fraction=selection_fraction, selection_seed=selection_seed,
            heuristic_union=heuristic_union, chunk_sessions=chunk_sessions,
            k_covisit=k_covisit, uniq_cap=uniq_cap, aid_feats=aid_feats,
            artifact_dir=artifact_dir, feature_list=feature_list, device=dev,
        )
        timings["train_s"] = round(time.time() - t0, 1)
        timings["train_sessions"] = int(len(train_idx))
    elif exclude_train_subset:
        train_mask[train_subset_indices(S, train_sessions, train_subset_seed)] = True

    # ---- stage 2: stream the other sessions ------------------------------
    streamed_idx = np.flatnonzero(~train_mask)
    if max_stream_sessions and len(streamed_idx) > max_stream_sessions:
        # cap the streamed set (still training-disjoint; the cap is a wall-
        # clock bound, recorded so a capped run cannot read as full)
        streamed_idx = streamed_idx[:max_stream_sessions]
        timings["stream_capped_at"] = int(max_stream_sessions)
    n_stream = len(streamed_idx)
    ft_neighbors = (artifacts.sgns.neighbor_table(k=20)
                    if artifacts.sgns is not None else None)
    wide_k = min(covisit_config.top_k_wide, matrices.tables["time_weighted"][0].shape[1])

    preds = {t: np.full((n_stream, TOP_K), -1, np.int32) for t in EVENT_TYPES}
    heur_all = {t: np.full((n_stream, TOP_K), -1, np.int32) for t in EVENT_TYPES}
    shard_times: list[dict] = []
    rows_predicted = 0
    t_stream = time.time()
    on_cpu = dev.type == "cpu"
    for lo in range(0, n_stream, shard_sessions):
        hi = min(lo + shard_sessions, n_stream)
        mask = np.zeros(S, bool)
        mask[streamed_idx[lo:hi]] = True
        shard = target.select_sessions(mask)
        row: dict = {"sessions": int(hi - lo)}

        t0 = time.time()
        heur = covisit_heuristic_predictions(
            shard, matrices, stats_top, ft_neighbors=ft_neighbors,
            chunk_sessions=chunk_sessions,
            recency_host_f64=on_cpu, covisit_host=on_cpu, device=dev,
        )
        for t in EVENT_TYPES:
            heur_all[t][lo:hi] = heur[t][:, :TOP_K]
        row["heuristic_s"] = round(time.time() - t0, 1)

        t0 = time.time()
        pstats: dict = {}
        out = predict_two_stage(
            artifacts, train, shard, n_aids,
            uniq_cap=uniq_cap, k_covisit=k_covisit,
            heuristic_union=heuristic_union,
            aid_feats=aid_feats,
            heuristic_preds=heur if heuristic_union else None,
            chunk_sessions=chunk_sessions,
            wide_k=wide_k,
            stats_out=pstats,
            device=dev,
        )
        for t in EVENT_TYPES:
            preds[t][lo:hi] = out[t][:, :TOP_K]
        row["predict_s"] = round(time.time() - t0, 1)
        row["rss_gb"] = round(_rss_gb(), 2)
        shard_rows = sum(v for k, v in pstats.items() if k.startswith("rows_"))
        row["ranker_rows"] = int(shard_rows)
        rows_predicted += int(shard_rows)
        shard_times.append(row)
        log.info("streamed shard %d-%d/%d: heuristic %.1fs predict %.1fs rss %.1f GB",
                 lo, hi, n_stream, row["heuristic_s"], row["predict_s"], row["rss_gb"])
        if progress_cb is not None:
            progress_cb(dict(timings, streamed_so_far=int(hi)), shard_times, {
                "labels": labels,
                "streamed_idx": streamed_idx,
                "hi": int(hi),
                "predictions": preds,
                "heuristic_predictions": heur_all,
            })
    timings["stream_s"] = round(time.time() - t_stream, 1)
    timings["streamed_sessions"] = int(n_stream)
    timings["ranker_rows_predicted"] = int(rows_predicted)
    if timings["stream_s"] > 0:
        timings["stream_sessions_per_s"] = round(n_stream / timings["stream_s"], 1)
        timings["ranker_rows_per_s"] = round(rows_predicted / timings["stream_s"], 0)
    timings["peak_rss_gb"] = round(_rss_gb(), 2)

    # ---- stage 3: evaluation over the streamed sessions ------------------
    report = heur_report = boot = None
    if labels is not None and n_stream:
        lab_s = labels.take(streamed_idx)
        report = evaluate_predictions(lab_s, preds["clicks"], preds["carts"], preds["orders"],
                                      device=dev)
        heur_report = evaluate_predictions(lab_s, heur_all["clicks"], heur_all["carts"],
                                           heur_all["orders"], device=dev)
        log.info("streamed two-stage on %d sessions\n%s", n_stream, report)
        log.info("heuristic on the same sessions\n%s", heur_report)
        if n_boot:
            t0 = time.time()
            boot = paired_bootstrap_lift(lab_s, preds, heur_all, n_boot=n_boot,
                                         seed=selection_seed)
            timings["bootstrap_s"] = round(time.time() - t0, 1)
            log.info("paired bootstrap lift %+.6f ci95 %s p<=0 %.4f",
                     boot["lift"], boot["ci95"], boot["p_le_0"])

    timings["total_s"] = round(time.time() - t_all, 1)
    return StreamedResult(
        artifacts=artifacts,
        predictions=preds,
        heuristic_predictions=heur_all,
        streamed_idx=streamed_idx,
        report=report,
        heuristic_report=heur_report,
        bootstrap_vs_heuristic=boot,
        timings=timings,
        shard_times=shard_times,
    )
