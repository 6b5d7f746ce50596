"""End-to-end pipeline entry points (validation / submission modes).

Port of ``otto_tpu/pipelines.py``.  Each reference model script is an
argparse ``__main__`` with a ``mode in {validation, submission}`` contract
writing files under hardcoded paths.  Here the equivalents are plain
functions over in-memory stores on an explicit ``device``
(``run_aid_frequency``, ``run_aid_weight``, ``run_covisit_heuristic``, the
TF-IDF recommender ``run_tfidf``, the SGNS recommenders
``run_embedding_knn`` and ``run_doc2vec``, the sequence recommenders
``run_sequence``, the file ensemble ``run_ensemble``), plus the file CLI::

    python -m otto_tpu_torch.pipelines <model> <validation|submission> \
        --events <file.parquet|file.jsonl> [--device cuda|cpu]

``--device`` defaults to ``cuda``; without a card that raises, it never
runs quietly on the CPU.  ``embedding_knn`` and ``doc2vec`` train SGNS
with ``--config`` (an ``SGNSConfig`` YAML; default ``SGNSConfig()``);
``sequence`` trains the encoder of ``--config`` (a ``SequenceModelConfig``
YAML, e.g. ``configs/sequence_gru.yaml``; default
``SequenceModelConfig()``).  ``two_stage`` and ``two_stage_streamed`` (both
modes) train the fold rankers of ``--ranker``, the listwise tower by default
(``--config``: a ``RankerConfig`` YAML) or ``gbdt`` (a ``GBDTConfig``
YAML), where ``--artifact-dir`` holds none, or resume those it holds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.config import (
    DataConfig,
    GBDTConfig,
    RankerConfig,
    SequenceModelConfig,
    SGNSConfig,
)
from otto_tpu_torch.data import splits, submission
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.labels import SessionLabels
from otto_tpu_torch.eval.harness import RecallReport, evaluate_predictions
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.models.covisitation import build_covisitation, covisit_heuristic_predictions
from otto_tpu_torch.models.ensemble import align_to_sessions, blend_files
from otto_tpu_torch.models.frequency import FrequencyStatistics, aid_frequency_predictions
from otto_tpu_torch.models.recency import (
    SUBMISSION_COEFFICIENTS,
    VALIDATION_COEFFICIENTS,
    aid_weight_predictions,
)
from otto_tpu_torch.utils.runtime import resolve_device

log = get_logger(__name__)

# Device-friendly packing width: sessions longer than this keep their most
# recent MAX_SESSION_LEN events (recency weights still use true positions).
MAX_SESSION_LEN = 256


def _packed(store: EventStore, max_len: int = MAX_SESSION_LEN):
    return store.pack(max_len=min(max_len, max(int(store.lengths.max(initial=1)), 1)), keep="last")


@dataclass
class BaselineResult:
    predictions: dict[str, np.ndarray]
    report: RecallReport | None


def _report(name: str, labels: SessionLabels | None, preds, device) -> RecallReport | None:
    if labels is None:
        return None
    report = evaluate_predictions(labels, preds["clicks"], preds["carts"], preds["orders"],
                                  device=device)
    log.info("%s validation scores\n%s", name, report)
    return report


def run_aid_frequency(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    *,
    device: str | torch.device,
) -> BaselineResult:
    """aid-frequency baseline (reference: src/baseline/aid_frequency.py)."""
    stats = FrequencyStatistics.compute(train, n_aids=n_aids, k=k, device=device)
    preds = aid_frequency_predictions(_packed(target), stats, k=k, device=device)
    return BaselineResult(preds, _report("aid frequency", labels, preds, device))


def run_aid_weight(
    target: EventStore,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    *,
    device: str | torch.device,
) -> BaselineResult:
    """aid-weight recency baseline (reference: src/baseline/aid_weight.py).
    Validation mode uses type coefficients {1,6,3}; submission {1,3,6}."""
    coeffs = VALIDATION_COEFFICIENTS if labels is not None else SUBMISSION_COEFFICIENTS
    preds = aid_weight_predictions(_packed(target), coefficients=coeffs, k=k, device=device)
    return BaselineResult(preds, _report("aid weight", labels, preds, device))


def run_covisit_heuristic(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    *,
    device: str | torch.device,
) -> BaselineResult:
    """Covisitation heuristic recommender end to end (reference:
    src/covisitation/inference.py)."""
    mats = build_covisitation(train, n_aids, device=device)
    stats = FrequencyStatistics.compute(train, n_aids=n_aids, k=k, device=device)
    stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
    preds = covisit_heuristic_predictions(target, mats, stats_top, k=k, device=device)
    return BaselineResult(preds, _report("covisitation heuristic", labels, preds, device))


def run_tfidf(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    *,
    device: str | torch.device,
) -> BaselineResult:
    """TF-IDF similar-session recommender (reference: src/tfidf/inference.py):
    session vectors on the host, the similar-session scan on ``device``."""
    from otto_tpu_torch.models.tfidf import TfIdfModel

    model = TfIdfModel.fit(train, n_aids=n_aids)
    preds = model.similar_session_predictions(target, k=k, device=device)
    return BaselineResult(preds, _report("tfidf", labels, preds, device))


def run_embedding_knn(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    config_path: str | None = None,
    *,
    device: str | torch.device,
) -> BaselineResult:
    """SGNS embeddings + kNN serving (reference: src/gensim_fasttext/
    {trainer,inference}.py; n_nns 21 in validation, 101 in submission)."""
    from otto_tpu_torch.models.embeddings import embedding_knn_predictions, train_sgns

    cfg = SGNSConfig.from_yaml(config_path) if config_path else SGNSConfig()
    sgns = train_sgns(train, n_aids, cfg, device=device)
    table = sgns.neighbor_table(k=21 if labels is not None else 101)
    preds = embedding_knn_predictions(target, table, k=k, device=device)
    return BaselineResult(preds, _report("embedding-knn", labels, preds, device))


def run_doc2vec(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    config_path: str | None = None,
    *,
    device: str | torch.device,
) -> BaselineResult:
    """Doc2Vec analog: pooled session embeddings + similar-session retrieval
    (reference: gensim Doc2Vec mode of src/gensim_fasttext/trainer.py:41-59)."""
    from otto_tpu_torch.models.embeddings import SessionEmbeddingModel, train_sgns

    cfg = SGNSConfig.from_yaml(config_path) if config_path else SGNSConfig()
    sgns = train_sgns(train, n_aids, cfg, device=device)
    model = SessionEmbeddingModel.fit(train, sgns.embeddings, device=device)
    preds = model.similar_session_predictions(target, k=k)
    return BaselineResult(preds, _report("doc2vec-analog", labels, preds, device))


def run_sequence(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    config_path: str | None = None,
    *,
    device: str | torch.device,
) -> BaselineResult:
    """Sequential recommender with 3-way serving routing (reference:
    src/recbole/{trainer,inference}.py): trains the encoder of
    ``config_path`` (a ``SequenceModelConfig`` YAML; default
    ``SequenceModelConfig()``) on ``device`` and serves the target there;
    sessions whose last aid was not seen in training get no list (no kNN
    table is passed, as in the reference)."""
    from otto_tpu_torch.models.covisitation import sessions_with_distinct_at_least
    from otto_tpu_torch.models.sequence import (
        sequence_serving_predictions,
        train_sequence_model,
    )

    cfg = (SequenceModelConfig.from_yaml(config_path) if config_path
           else SequenceModelConfig()).replace(n_aids=n_aids)
    model = train_sequence_model(train, cfg, device=device)
    seen = np.zeros(n_aids, bool)
    seen[train.aid] = True
    counters = (sequence_serving_predictions.sessions, sessions_with_distinct_at_least.sessions)
    before = [dict(c) for c in counters]
    preds = sequence_serving_predictions(target, model, trained_aid_mask=seen, k=k)
    routed, decided = ({r: n - b[r] for r, n in c.items()} for c, b in zip(counters, before))
    log.info("sequence (%s) routes: %d sessions recency, %d model, %d fallback (no list); "
             "%d decided by length, %d counted", cfg.architecture, routed["recency"],
             routed["model"], routed["fallback"], decided["by_length"], decided["counted"])
    return BaselineResult(preds, _report(f"sequence ({cfg.architecture})", labels, preds,
                                         device))


MODEL_RUNNERS = {
    "aid_frequency": run_aid_frequency,
    "aid_weight": run_aid_weight,
    "covisitation": run_covisit_heuristic,
    "tfidf": run_tfidf,
    "sequence": run_sequence,
    "embedding_knn": run_embedding_knn,
    "doc2vec": run_doc2vec,
}


def run_ensemble(
    manifest: dict,
    labels: SessionLabels | None = None,
    holdout_fraction: float = 0.25,
    seed: int = 42,
    k: int = TOP_K,
    *,
    device: str | torch.device,
) -> BaselineResult:
    """File-based multi-model ensemble (the reference's final inference stage,
    src/ranker/inference.py:14-85,123-140,321-337): load N per-model
    prediction files per event type, robust-scale, outer-join on
    (session, aid), blend with the manifest's fixed weights, cut to top-20
    (numpy on the host).

    With ``labels``, reports recall (on ``device``) on all labeled sessions
    (the OOF view) and on a held-out ``holdout_fraction`` subset (the
    reference's teammate-defined holdout sessions, inference.py:139,321-337).
    Without, the predictions carry the blended sessions under
    ``"__sessions"``.
    """
    blended = blend_files(manifest, k=k)
    report = None
    if labels is not None:
        preds = {t: align_to_sessions(labels.session_ids, blended[t], k=k)
                 for t in EVENT_TYPES}
        report = _report("ensemble blend (all labeled sessions)", labels, preds, device)
        hold = np.flatnonzero(np.random.default_rng(seed).random(labels.n_sessions)
                              < holdout_fraction)
        _report(f"ensemble blend (holdout {100 * holdout_fraction:.0f}%)", labels.take(hold),
                {t: p[hold] for t, p in preds.items()}, device)
        preds_out = preds
    else:
        sessions = blended["clicks"][0]
        preds_out = {t: align_to_sessions(sessions, blended[t], k=k) for t in EVENT_TYPES}
        preds_out["__sessions"] = sessions
    return BaselineResult(preds_out, report)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(prog="otto_tpu_torch.pipelines")
    parser.add_argument(
        "model",
        choices=["aid_frequency", "aid_weight", "covisitation", "two_stage",
                 "two_stage_streamed", "tfidf", "sequence", "embedding_knn",
                 "doc2vec", "ensemble"],
    )
    parser.add_argument("mode", choices=["validation", "submission"])
    parser.add_argument("--events", default=None,
                        help="parquet of (session, aid, ts, type) or .jsonl raw file "
                             "(optional for 'ensemble submission', required otherwise)")
    parser.add_argument("--manifest", default=None,
                        help="ensemble: JSON manifest {etype: {model: {path, weight}}} "
                             "of per-model prediction files (npz/parquet with "
                             "session/aid/score) — the reference's read_predictions "
                             "contract (src/ranker/inference.py:14-85)")
    parser.add_argument("--holdout-fraction", type=float, default=0.25,
                        help="ensemble validation: extra recall report on this "
                             "fraction of sessions (inference.py:321-337)")
    parser.add_argument("--output", default=None, help="submission csv.gz path")
    parser.add_argument("--n-aids", type=int, default=DataConfig().n_aids)
    parser.add_argument("--val-fraction", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--config", default=None,
                        help="embedding_knn / doc2vec: the SGNSConfig YAML (default "
                             "SGNSConfig()); two_stage / two_stage_streamed: the rankers' "
                             "RankerConfig YAML with --ranker tower (default RankerConfig(), "
                             "e.g. configs/ranker.yaml), GBDTConfig YAML with --ranker gbdt "
                             "(default GBDTConfig()); sequence: the SequenceModelConfig YAML "
                             "(default SequenceModelConfig(), e.g. "
                             "configs/sequence_gru.yaml)")
    parser.add_argument("--ranker", choices=["tower", "gbdt"], default="tower",
                        help="two_stage reranking engine: listwise MLP tower (default) or "
                             "the histogram GBDT (the reference's LightGBM stage)")
    parser.add_argument("--test-events", default=None,
                        help="submission mode: separate test events file to predict "
                             "(the reference's train.jsonl/test.jsonl split); defaults "
                             "to predicting --events sessions themselves")
    parser.add_argument("--artifact-dir", default=None,
                        help="two_stage per-stage persistence / crash-resume directory: "
                             "what it holds (covisitation tables, ranker_<type>.npz) is "
                             "reloaded, what is built or trained is saved there")
    parser.add_argument("--train-sessions", type=int, default=50_000,
                        help="two_stage_streamed: labeled target sessions used "
                             "to fit the rankers; the rest stream")
    parser.add_argument("--shard-sessions", type=int, default=100_000,
                        help="two_stage_streamed: prediction shard size "
                             "(bounds peak memory — the reference's 15-shard "
                             "explode / 20-chunk prediction analog)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the models run on (default cuda; without a "
                             "card it raises: pass cpu to run on the CPU)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    def _read(path):
        if str(path).endswith(".jsonl"):
            from otto_tpu_torch.data.ingest import read_jsonl

            return read_jsonl(path)
        return EventStore.from_parquet(path)

    if args.model == "ensemble":
        import json

        if not args.manifest:
            parser.error("ensemble requires --manifest")
        manifest = json.loads(open(args.manifest).read())
        if args.mode == "validation":
            if not args.events:
                parser.error("ensemble validation requires --events (for labels)")
            sp = splits.split_by_fraction(
                _read(args.events), val_fraction=args.val_fraction, seed=args.seed
            )
            result = run_ensemble(manifest, sp.val_labels, holdout_fraction=args.holdout_fraction,
                                  seed=args.seed, device=dev)
            print(result.report)
        else:
            result = run_ensemble(manifest, None, device=dev)
            sessions = result.predictions.pop("__sessions")
            out = args.output or "ensemble_submission.csv.gz"
            submission.write_submission(out, sessions, result.predictions)
            print(f"wrote {out}")
        return result

    if not args.events:
        parser.error("--events is required")
    store = _read(args.events)
    cfg_cls = GBDTConfig if args.ranker == "gbdt" else RankerConfig
    rcfg = (cfg_cls.from_yaml(args.config) if args.config and args.model.startswith("two_stage")
            else cfg_cls())

    def fit_two_stage(train):
        # submission: the rankers are fit on a labeled split of the train
        # events (the reference trains on the labeled validation week,
        # src/ranker/lgb_trainer.py:51-57), or resumed from --artifact-dir
        from otto_tpu_torch.twostage import run_two_stage

        sp = splits.split_by_fraction(train, val_fraction=args.val_fraction, seed=args.seed)
        return run_two_stage(sp.train, sp.val_input, args.n_aids, labels=sp.val_labels,
                             ranker_config=rcfg, artifact_dir=args.artifact_dir, device=dev)

    def dispatch(train, target, labels):
        if args.model == "two_stage_streamed":
            from otto_tpu_torch.streaming import run_two_stage_streamed

            # validation: fit on --train-sessions of the target, stream the
            # rest; submission: fit on a split of the train events, stream
            # every target session
            res = run_two_stage_streamed(
                train, target, args.n_aids, labels=labels, ranker_config=rcfg,
                artifacts=None if labels is not None else fit_two_stage(train),
                train_sessions=args.train_sessions, shard_sessions=args.shard_sessions,
                artifact_dir=args.artifact_dir, n_boot=0 if labels is None else 1000,
                device=dev,
            )
            if res.bootstrap_vs_heuristic is not None:
                b = res.bootstrap_vs_heuristic
                print(f"lift vs heuristic {b['lift']:+.6f} ci95 {b['ci95']} "
                      f"(streamed, training-disjoint)")
            return BaselineResult(res.predictions, res.report)
        if args.model == "two_stage":
            from otto_tpu_torch.twostage import predict_two_stage, run_two_stage

            if labels is None:  # submission: fit, then score the target sessions
                art = fit_two_stage(train)
                return BaselineResult(predict_two_stage(art, train, target, args.n_aids,
                                                        device=dev), None)
            art = run_two_stage(train, target, args.n_aids, labels=labels, ranker_config=rcfg,
                                artifact_dir=args.artifact_dir, device=dev)
            return BaselineResult(art.predictions, art.report)
        runner = MODEL_RUNNERS[args.model]
        if args.model == "aid_weight":
            return runner(target, labels, device=dev)
        kw = ({"config_path": args.config}
              if args.model in ("embedding_knn", "doc2vec", "sequence") else {})
        return runner(train, target, args.n_aids, labels, device=dev, **kw)

    if args.mode == "validation":
        sp = splits.split_by_fraction(store, val_fraction=args.val_fraction, seed=args.seed)
        result = dispatch(sp.train, sp.val_input, sp.val_labels)
        print(result.report)
    else:
        target = _read(args.test_events) if args.test_events else store
        result = dispatch(store, target, None)
        out = args.output or f"{args.model}_submission.csv.gz"
        submission.write_submission(out, target.session_ids, result.predictions)
        print(f"wrote {out}")
    return result


if __name__ == "__main__":
    main()
