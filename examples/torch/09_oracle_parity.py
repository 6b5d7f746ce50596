"""Oracle-parity demo on the PyTorch port (the counterpart of
``examples/09_oracle_parity.py``): the port's batched heuristic and
candidate generator against the reference-semantics oracle on one small
dataset, on ``--device``.

The oracle (``otto_tpu_torch.eval.oracle``) restates the reference's
per-session Counter/list algorithms exactly
(src/covisitation/inference.py:128-247,
src/ranker/regular_candidate_generation.py:138-197); this demo feeds both
sides identical covisitation tables and frequency statistics and prints the
agreement table, the heuristic's also by route (sessions with fewer than 20
distinct aids take the covisitation route).  The realistic-scale run
(1,000,000 sessions over 100,000 aids) is ``tools/parity_run_torch.py``.

Run: python examples/torch/09_oracle_parity.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

from otto_tpu_torch import EVENT_TYPES
from otto_tpu_torch.data.splits import split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.eval import oracle as orc
from otto_tpu_torch.models.candidates import regular_candidates
from otto_tpu_torch.models.covisitation import (
    build_covisitation,
    covisit_heuristic_predictions,
    session_unique_counts,
)
from otto_tpu_torch.models.frequency import FrequencyStatistics
from otto_tpu_torch.utils.runtime import resolve_device


def rows(arr) -> list[list[int]]:
    return [[int(x) for x in r if x >= 0] for r in arr]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=8_000)
    ap.add_argument("--aids", type=int, default=2_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    N = args.aids

    store = synthetic_events_v2(n_sessions=args.sessions, n_aids=N, n_clusters=60, seed=1)
    split = split_by_time(store, val_fraction=0.2)
    mats = build_covisitation(split.train, N, device=dev)
    stats = FrequencyStatistics.compute(split.train, n_aids=N, device=dev)
    stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}

    fw = covisit_heuristic_predictions(split.val_input, mats, stats_top, device=dev)
    cs = regular_candidates(split.val_input, mats, device=dev)

    aid_lists, type_lists = orc.store_to_lists(split.val_input)
    tables15 = {k: orc.table_to_dict(mats.tables[k][0], 15) for k in mats.tables}
    tables20 = {k: orc.table_to_dict(mats.tables[k][0], 20) for k in mats.tables}
    freq = {t: [int(a) for a in stats.top_by_type[t]] for t in EVENT_TYPES}
    orx = orc.oracle_heuristic(aid_lists, type_lists, tables15, freq, None)
    ocs = orc.oracle_regular_candidates(aid_lists, type_lists, tables20, None)

    lab = orc.labels_to_lists(split.val_labels)
    labmap = dict(zip(EVENT_TYPES, lab))
    covisit_route = np.flatnonzero(session_unique_counts(split.val_input) < 20)
    out = {"heuristic": {}, "candidates": {}, "covisit_route_sessions": int(len(covisit_route)),
           "sessions": len(aid_lists)}
    print("| path | type | exact | set | fw recall | oracle recall |")
    print("|---|---|---|---|---|---|")
    for t in EVENT_TYPES:
        f = rows(fw[t])
        same = [a == b for a, b in zip(f, orx[t])]
        r = {"exact": float(np.mean(same)),
             "set": float(np.mean([set(a) == set(b) for a, b in zip(f, orx[t])])),
             "exact_covisit_route": float(np.mean([same[i] for i in covisit_route]))
             if len(covisit_route) else None,
             "recall": orc.corpus_recall(f, labmap[t]),
             "oracle_recall": orc.corpus_recall(orx[t], labmap[t])}
        out["heuristic"][t] = r
        print(f"| heuristic | {t} | {r['exact']:.4f} | {r['set']:.4f} | "
              f"{r['recall']:.4f} | {r['oracle_recall']:.4f} |")
    for t in EVENT_TYPES:
        f = rows(cs.candidates[t])
        r = {"exact": float(np.mean([a == b for a, b in zip(f, ocs[t][0])])),
             "recall": orc.corpus_recall(f, labmap[t]),
             "oracle_recall": orc.corpus_recall(ocs[t][0], labmap[t])}
        out["candidates"][t] = r
        print(f"| candgen | {t} | {r['exact']:.4f} | - | "
              f"{r['recall']:.4f} | {r['oracle_recall']:.4f} |")
    print("heuristic exact on the covisitation route: " + ", ".join(
        f"{t} {out['heuristic'][t]['exact_covisit_route']:.4f}" for t in EVENT_TYPES))
    return out


if __name__ == "__main__":
    main()
