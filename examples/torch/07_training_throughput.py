"""Training-throughput measurement on the PyTorch port (the counterpart of
``examples/07_training_throughput.py``).

Times one warm epoch or segment of each trainable model family at a
moderate synthetic scale on ``--device`` and reports steps/s and
examples/s, with the card's name and power limit:

- the SGNS embedding trainer (the fastText/word2vec replacement)
- the CF pair trainer (shared-table dot product)
- the listwise ranker tower (LambdaRank loss)
- the histogram GBDT (lambdarank trees/s: the histogram and binning
  kernels, K5 and K4 bin, on a card)
- the sequence recommender (SASRec-style transformer)

Run: python examples/torch/07_training_throughput.py [--sessions 50000] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from otto_tpu_torch.config import CFConfig, GBDTConfig, SequenceModelConfig, SGNSConfig
from otto_tpu_torch.data.synthetic import synthetic_events
from otto_tpu_torch.logging_utils import configure_logging
from otto_tpu_torch.models.gbdt import train_gbdt_ranker
from otto_tpu_torch.models.matrix_factorization import train_cf
from otto_tpu_torch.models.embeddings import train_sgns
from otto_tpu_torch.models.ranker import RankerData, Tower, init_tower, train_step
from otto_tpu_torch.models.sequence import train_sequence_model
from otto_tpu_torch.utils.runtime import device_line, resolve_device


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev) -> float:
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=50_000)
    ap.add_argument("--aids", type=int, default=20_000)
    ap.add_argument("--tower-steps", type=int, default=20)
    ap.add_argument("--gbdt-sessions", type=int, default=2_000)
    ap.add_argument("--gbdt-trees", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    configure_logging()
    card = device_line(dev)
    N = args.aids
    es = synthetic_events(n_sessions=args.sessions, n_aids=N, mean_length=12, seed=7)
    print(f"dataset: {es.n_events} events, {es.n_sessions} sessions ({card})", flush=True)
    out = {"device": card, "n_events": int(es.n_events)}

    # ---- SGNS --------------------------------------------------------------
    cfg = SGNSConfig(dim=32, window=10, negatives=40, epochs=1)
    cold = timed(lambda: train_sgns(es, N, cfg, device=dev), dev)
    dt = timed(lambda: train_sgns(es, N, cfg, device=dev), dev)
    out["sgns"] = {"epoch_s": dt, "center_events_per_s": es.n_events / dt, "cold_s": cold}
    print(f"SGNS epoch (dim 32, 40 negs): {dt:.2f}s = {es.n_events / dt:,.0f} center-events/s "
          f"[cold {cold:.0f}s] ({card})", flush=True)

    # ---- CF pairs ----------------------------------------------------------
    ccfg = CFConfig(epochs=1)
    train_cf(es, N, ccfg, device=dev)
    dt = timed(lambda: train_cf(es, N, ccfg, device=dev), dev)
    out["cf"] = {"epoch_s": dt}
    print(f"CF epoch: {dt:.2f}s ({card})", flush=True)

    # ---- ranker tower --------------------------------------------------------
    B, C, F = 512, 128, 52
    gen = torch.Generator(device=dev).manual_seed(1)
    tower = Tower(init_tower(F, (256, 256, 128), torch.Generator().manual_seed(0))).to(dev)
    opt = torch.optim.AdamW(tower.parameters(), lr=1e-3, eps=1e-8, weight_decay=1e-4)
    feats = torch.randn((B, C, F), generator=gen, device=dev)
    labels = (torch.rand((B, C), generator=gen, device=dev) < 0.1).to(torch.int8)
    mask = torch.ones((B, C), dtype=torch.bool, device=dev)

    def tower_steps(n):
        loss = None
        for _ in range(n):
            loss = train_step(tower, opt, feats, labels, mask, 1e-3, loss="lambdarank",
                              dropout=0.1, generator=gen)
        float(loss)

    tower_steps(1)
    dt = timed(lambda: tower_steps(args.tower_steps), dev) / args.tower_steps
    out["tower"] = {"step_ms": dt * 1e3, "sessions_per_s": B / dt, "candidates_per_s": B * C / dt}
    print(f"tower step (B={B} sessions x {C} cands, lambdarank): {dt * 1e3:.1f} ms = "
          f"{B / dt:,.0f} sessions/s = {B * C / dt:,.0f} candidates/s ({card})", flush=True)

    # ---- GBDT ----------------------------------------------------------------
    rng = np.random.default_rng(0)
    Sg, Cg, Fg = args.gbdt_sessions, 100, 52
    gdata = RankerData(features=rng.normal(size=(Sg, Cg, Fg)).astype(np.float32),
                       labels=(rng.random((Sg, Cg)) < 0.05).astype(np.int8),
                       mask=np.ones((Sg, Cg), bool), session_ids=np.arange(Sg),
                       candidates=np.zeros((Sg, Cg), np.int32))
    gcfg = GBDTConfig(n_trees=args.gbdt_trees, early_stopping_rounds=1000, max_depth=7,
                      n_bins=255, min_data_in_leaf=100, n_folds=2)
    cold = timed(lambda: train_gbdt_ranker(gdata, gcfg, device=dev), dev)
    dt = timed(lambda: train_gbdt_ranker(gdata, gcfg, device=dev), dev)
    trees = gcfg.n_trees * gcfg.n_folds
    out["gbdt"] = {"s": dt, "trees": trees, "trees_per_s": trees / dt, "cold_s": cold}
    print(f"GBDT ({Sg * Cg:,} rows x {Fg} feats, depth 7): {dt:.2f}s for {trees} trees = "
          f"{trees / dt:.1f} trees/s [cold {cold:.0f}s] ({card})", flush=True)

    # ---- sequence transformer --------------------------------------------------
    scfg = SequenceModelConfig(n_aids=N, dim=64, hidden=64, architecture="transformer",
                               max_len=20, n_layers=2, n_heads=2, epochs=1)
    train_sequence_model(es, scfg, device=dev)
    dt = timed(lambda: train_sequence_model(es, scfg, device=dev), dev)
    out["sequence"] = {"epoch_s": dt, "examples_per_s": es.n_events / dt}
    print(f"SASRec epoch: {dt:.2f}s = {es.n_events / dt:,.0f} examples/s ({card})", flush=True)
    return out


if __name__ == "__main__":
    main()
