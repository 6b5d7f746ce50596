"""Production-serving walkthrough on the PyTorch port (the counterpart of
``examples/06_serving.py``): train once, persist artifacts, score fresh
sessions from a separate process.

The artifact directory is the deployable unit: covisitation tables, the
SGNS embedding table and the per-event-type ranker folds, all reloadable
with ``TwoStageArtifacts.load`` (``otto_tpu_torch/twostage.py``).  The
serving process is started as a process of its own (this file with
``--serve``): it loads the directory, scores the fresh sessions and writes
its lists; they must equal the lists this process scores from the same
directory.

Run: python examples/torch/06_serving.py [artifact_dir] [--device cpu]
"""

from __future__ import annotations

import time

START = time.perf_counter()  # the serving process's start-up is timed from here

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import numpy as np

from otto_tpu_torch.config import CovisitConfig, RankerConfig, SGNSConfig
from otto_tpu_torch.data import splits
from otto_tpu_torch.data.synthetic import synthetic_events
from otto_tpu_torch.logging_utils import configure_logging
from otto_tpu_torch.twostage import TwoStageArtifacts, predict_two_stage, run_two_stage
from otto_tpu_torch.utils.runtime import resolve_device

TYPES = ("clicks", "carts", "orders")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("artifact_dir", nargs="?", default=None,
                    help="where the artifacts go (default: a new temporary directory)")
    ap.add_argument("--sessions", type=int, default=6_000)
    ap.add_argument("--aids", type=int, default=2_000)
    ap.add_argument("--fresh", type=int, default=512, help="sessions the server scores")
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut the tower's and SGNS's epochs (default: 5 and 3)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)  # the server
    return ap.parse_args(argv)


def data(args):
    es = synthetic_events(n_sessions=args.sessions, n_aids=args.aids, mean_length=12)
    sp = splits.split_by_fraction(es, val_fraction=0.25)
    fresh = es.select_sessions(np.arange(es.n_sessions - args.fresh, es.n_sessions))
    return sp, fresh


def serve(args, dev) -> tuple[dict, dict]:
    """Load the artifact directory and score the fresh sessions: the lists
    and the seconds of each step (the data, the load, the scoring)."""
    t0 = time.perf_counter()
    sp, fresh = data(args)
    t1 = time.perf_counter()
    serving = TwoStageArtifacts.load(args.artifact_dir, device=dev)
    t2 = time.perf_counter()
    preds = predict_two_stage(serving, sp.train, fresh, args.aids, device=dev)
    t3 = time.perf_counter()
    return preds, {"data_s": t1 - t0, "load_s": t2 - t1, "score_s": t3 - t2}


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    dev = resolve_device(args.device)
    configure_logging()
    if args.serve:  # the serving process
        ready = time.perf_counter() - START
        preds, secs = serve(args, dev)
        np.savez(Path(args.artifact_dir) / "served.npz", start_s=ready, **secs, **preds)
        return {"start_s": ready, **secs}

    artifact_dir = args.artifact_dir or tempfile.mkdtemp(prefix="otto_serve_")
    args.artifact_dir = artifact_dir
    # ---------------- offline: train + persist -----------------------------
    sp, _ = data(args)
    e = args.epochs
    art = run_two_stage(
        sp.train, sp.val_input, args.aids, labels=sp.val_labels,
        covisit_config=CovisitConfig(top_k_wide=20, session_tail=30),
        ranker_config=RankerConfig(hidden_dims=(128, 64), n_folds=3, epochs=5 if e is None else e,
                                   batch_sessions=256, dropout=0.0),
        sgns_config=SGNSConfig(dim=16, window=5, negatives=10, epochs=3 if e is None else e),
        artifact_dir=artifact_dir, device=dev,
    )
    print(f"trained; validation weighted recall@20 = {art.report.weighted:.4f}")
    print(f"artifacts persisted under {artifact_dir}")

    # ---------------- online: load + serve in a process of its own ---------
    server = [a for a in argv if a != artifact_dir]
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(Path(__file__).resolve()), artifact_dir, *server,
                    "--serve"], check=True, cwd=REPO)
    process_s = time.perf_counter() - t0
    served = np.load(Path(artifact_dir) / "served.npz")
    steps = {k: float(served[k]) for k in ("start_s", "data_s", "load_s", "score_s")}
    dt = steps["score_s"]
    print(f"the serving process scored {args.fresh} fresh sessions in {dt:.2f}s "
          f"({args.fresh / dt:,.0f} sessions/s, {dt / args.fresh * 1e3:.1f} ms/session "
          f"amortized); the process took {process_s:.1f}s: imports {steps['start_s']:.1f}s, "
          f"data {steps['data_s']:.1f}s, load {steps['load_s']:.1f}s")
    for etype in TYPES:
        row = served[etype][0]
        print(f"  sample {etype}: {row[row >= 0][:10].tolist()}")
    # the same directory scored here: the server's lists are the trainer's
    here, _ = serve(args, dev)
    equal = all(np.array_equal(served[t], here[t]) for t in TYPES)
    print(f"served lists equal to this process's: {equal}")
    if not equal:
        raise RuntimeError("the serving process's lists differ from the training process's")
    return {"artifact_dir": artifact_dir, "weighted": float(art.report.weighted),
            "serve_s": dt, "sessions_per_s": args.fresh / dt, "process_s": process_s,
            "process_steps": steps, "lists_equal": equal,
            "served": {t: served[t] for t in TYPES}}


if __name__ == "__main__":
    main()
