"""Baseline-analysis example on the PyTorch port (the counterpart of
``examples/03_model_comparison.py``, which replaces the reference's
frequency-baseline notebook): run every model family on one synthetic split
and compare weighted recall@20.

On a card the rows run through the hand kernels: the session vote (K3) for
aid_weight and the kNN predict; stage 1 and the peel (K1, K2) for the kNN
table of embedding_knn and two_stage (+sgns) and for the sequence models'
full sort, from 65,537 aids (smaller catalogs take the exact dense route);
the GBDT engine's histograms (K5), binning (K4 bin) and forest (K4).

Run: python examples/torch/03_model_comparison.py [--device cpu]
     [--sessions 6000 --aids 2000 --epochs N --gbdt-trees N --models a,b]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from otto_tpu_torch.config import (
    CovisitConfig,
    GBDTConfig,
    RankerConfig,
    SequenceModelConfig,
    SGNSConfig,
)
from otto_tpu_torch.data import splits
from otto_tpu_torch.data.synthetic import synthetic_events
from otto_tpu_torch.logging_utils import configure_logging
from otto_tpu_torch.pipelines import (
    run_aid_frequency,
    run_aid_weight,
    run_covisit_heuristic,
    run_doc2vec,
    run_embedding_knn,
    run_sequence,
    run_tfidf,
)
from otto_tpu_torch.twostage import run_two_stage
from otto_tpu_torch.utils.runtime import resolve_device

SEQUENCE_CONFIGS = {"transformer": "sequence_transformer.yaml",
                    "moe transformer": "sequence_moe.yaml", "narm": "sequence_narm.yaml",
                    "stamp": "sequence_stamp.yaml", "caser": "sequence_caser.yaml"}
ROWS = ("aid_frequency", "aid_weight", "covisitation", "tfidf", "doc2vec", "embedding_knn",
        "sequence (gru)", *(f"sequence ({k})" for k in SEQUENCE_CONFIGS),
        "two_stage (+sgns)", "two_stage (gbdt engine)")


def _cut(cls, path: str | None, epochs: int | None, workdir: Path, name: str) -> str | None:
    """The config file a runner reads: ``path`` (None: ``cls()``'s
    defaults) with its epochs cut to ``epochs``, or ``path`` itself when
    nothing is cut."""
    import yaml

    if epochs is None:
        return path
    config = cls.from_yaml(path) if path else cls()
    out = workdir / f"{name}.yaml"
    out.write_text(yaml.safe_dump(config.replace(epochs=epochs).to_dict()))
    return str(out)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=6_000)
    ap.add_argument("--aids", type=int, default=2_000)
    ap.add_argument("--mean-length", type=float, default=12.0)
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut every trainer's epochs to this (default: each config's own)")
    ap.add_argument("--gbdt-trees", type=int, default=300)
    ap.add_argument("--models", default=",".join(ROWS),
                    help="comma-separated rows to run (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    wanted = [m.strip() for m in args.models.split(",")]
    unknown = sorted(set(wanted) - set(ROWS))
    if unknown:
        raise SystemExit(f"unknown rows {unknown}; choose from {list(ROWS)}")
    configure_logging()

    es = synthetic_events(n_sessions=args.sessions, n_aids=args.aids,
                          mean_length=args.mean_length)
    sp = splits.split_by_fraction(es, val_fraction=0.25)
    N = args.aids
    cfg_dir = REPO / "configs"
    e = args.epochs
    reports, ceiling = {}, None
    with tempfile.TemporaryDirectory(prefix="otto_models_") as tmp:
        work = Path(tmp)
        sgns_path = _cut(SGNSConfig, None, e, work, "sgns")
        runners = {
            "aid_frequency": lambda: run_aid_frequency(sp.train, sp.val_input, N,
                                                       sp.val_labels, device=dev),
            "aid_weight": lambda: run_aid_weight(sp.val_input, sp.val_labels, device=dev),
            "covisitation": lambda: run_covisit_heuristic(sp.train, sp.val_input, N,
                                                          sp.val_labels, device=dev),
            "tfidf": lambda: run_tfidf(sp.train, sp.val_input, N, sp.val_labels, device=dev),
            "doc2vec": lambda: run_doc2vec(sp.train, sp.val_input, N, sp.val_labels,
                                           config_path=sgns_path, device=dev),
            "embedding_knn": lambda: run_embedding_knn(sp.train, sp.val_input, N,
                                                       sp.val_labels, config_path=sgns_path,
                                                       device=dev),
            "sequence (gru)": lambda: run_sequence(
                sp.train, sp.val_input, N, sp.val_labels,
                config_path=_cut(SequenceModelConfig, None, e, work, "gru"), device=dev),
        }
        for name, file in SEQUENCE_CONFIGS.items():
            runners[f"sequence ({name})"] = lambda file=file: run_sequence(
                sp.train, sp.val_input, N, sp.val_labels,
                config_path=_cut(SequenceModelConfig, str(cfg_dir / file), e, work, file[:-5]),
                device=dev)
        for name in ROWS[:-2]:
            if name in wanted:
                reports[name] = runners[name]().report
        art = None
        if "two_stage (+sgns)" in wanted or "two_stage (gbdt engine)" in wanted:
            art = run_two_stage(
                sp.train, sp.val_input, N, labels=sp.val_labels,
                covisit_config=CovisitConfig(top_k_wide=20, session_tail=30),
                ranker_config=RankerConfig(hidden_dims=(128, 64), n_folds=3,
                                           epochs=5 if e is None else e,
                                           batch_sessions=256, dropout=0.0),
                sgns_config=SGNSConfig(dim=16, window=5, negatives=10,
                                       epochs=3 if e is None else e),
                device=dev,
            )
            ceiling = {k: float(v) for k, v in art.max_recall.items()}
            if "two_stage (+sgns)" in wanted:
                reports["two_stage (+sgns)"] = art.report
        if "two_stage (gbdt engine)" in wanted:
            art_g = run_two_stage(
                sp.train, sp.val_input, N, labels=sp.val_labels,
                matrices=art.matrices, sgns=art.sgns,  # reuse stage-0 artifacts
                ranker_config=GBDTConfig(n_trees=args.gbdt_trees, early_stopping_rounds=60,
                                         eval_every=5, learning_rate=0.08, max_depth=6,
                                         n_bins=128, min_data_in_leaf=30, n_folds=3,
                                         chunk_sessions=512),
                device=dev,
            )
            reports["two_stage (gbdt engine)"] = art_g.report

    print(f"\n{'model':26s} weighted  clicks  carts  orders")
    for name, r in reports.items():
        print(f"{name:26s} {r.weighted:.4f}   {r.clicks:.4f}  {r.carts:.4f}  {r.orders:.4f}")
    if ceiling is not None:
        print("candidate ceiling:", {k: round(v, 4) for k, v in ceiling.items()})
    return {"rows": {name: {"weighted": float(r.weighted), "clicks": float(r.clicks),
                            "carts": float(r.carts), "orders": float(r.orders)}
                     for name, r in reports.items()},
            "candidate_ceiling": ceiling}


if __name__ == "__main__":
    main()
