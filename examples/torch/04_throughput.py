"""Stage-throughput measurement on the PyTorch port (the counterpart of
``examples/04_throughput.py``).

Times the heavy pipeline stages at a moderate synthetic scale on
``--device``: covisitation construction (events/s), the heuristic
recommender (sessions/s) and candidate generation (sessions/s).  The
kernels are built before the clock starts; every rate is printed with the
card's name and power limit.

Run: python examples/torch/04_throughput.py [--sessions 50000] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from otto_tpu_torch.config import CovisitConfig
from otto_tpu_torch.data.synthetic import synthetic_events
from otto_tpu_torch.logging_utils import configure_logging
from otto_tpu_torch.models.candidates import regular_candidates
from otto_tpu_torch.models.covisitation import build_covisitation, covisit_heuristic_predictions
from otto_tpu_torch.models.frequency import FrequencyStatistics
from otto_tpu_torch.utils.runtime import device_line, resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=50_000)
    ap.add_argument("--aids", type=int, default=20_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    configure_logging()
    if dev.type == "cuda":
        from otto_tpu_torch.ops import _kernels

        _kernels.lib()
    card = device_line(dev)

    es = synthetic_events(n_sessions=args.sessions, n_aids=args.aids, mean_length=12, seed=7)
    print(f"dataset: {es.n_events} events, {es.n_sessions} sessions ({card})", flush=True)
    cov = CovisitConfig(top_k_wide=20, session_tail=30)

    t0 = time.perf_counter()
    mats = build_covisitation(es, args.aids, cov, chunk_sessions=4096, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    print(f"covisit build: {build_s:.2f}s = {es.n_events / build_s:,.0f} events/s ({card})",
          flush=True)

    stats = FrequencyStatistics.compute(es, n_aids=args.aids, k=20, device=dev)
    stats_top = {t: stats.top_by_type[t] for t in ("clicks", "carts", "orders")}

    t0 = time.perf_counter()
    covisit_heuristic_predictions(es, mats, stats_top, device=dev)
    heur_s = time.perf_counter() - t0
    print(f"heuristic recommender: {heur_s:.2f}s = {es.n_sessions / heur_s:,.0f} sessions/s "
          f"({card})", flush=True)

    t0 = time.perf_counter()
    cands = regular_candidates(es, mats, uniq_cap=64, wide_k=20, k_covisit=100, device=dev)
    cand_s = time.perf_counter() - t0
    n_cands = int(sum((cands.candidates[t] >= 0).sum() for t in cands.candidates))
    print(f"candidate generation: {cand_s:.2f}s = {es.n_sessions / cand_s:,.0f} sessions/s "
          f"({n_cands / cand_s:,.0f} candidates/s) ({card})", flush=True)
    return {"device": card, "n_events": int(es.n_events), "n_sessions": int(es.n_sessions),
            "covisit_build_s": build_s, "covisit_events_per_s": es.n_events / build_s,
            "heuristic_s": heur_s, "heuristic_sessions_per_s": es.n_sessions / heur_s,
            "candidates_s": cand_s, "candidate_sessions_per_s": es.n_sessions / cand_s,
            "candidates_per_s": n_cands / cand_s}


if __name__ == "__main__":
    main()
