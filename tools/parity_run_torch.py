"""Realistic-scale oracle-vs-port parity run: ``tools/parity_run.py`` on
the PyTorch port.

Generates a power-law + temporal-drift synthetic dataset (default 1,000,000
sessions over 100,000 aids, OTTO-shaped), builds the covisitation matrices
with the port on ``--device``, then runs BOTH the port's batched paths and
the reference-semantics oracle (``otto_tpu_torch/eval/oracle.py``) over the
identical inputs:

- the covisitation heuristic recommender (both routes; ``--recency-host-f64``
  routes the >=20-distinct-aid sessions through the float64 host
  accumulator),
- the production regular candidate generator,

and reports per-route/per-type exact-list agreement, set agreement, recall@20
per side, and the candidate generator's agreement where its vote cap does not
bind.  Every time is printed beside the card's name and power limit.  Writes
JSON (``tools/parity_run.py``'s keys, plus ``device``) to ``--out`` and a
markdown summary to stdout.

Usage:  python tools/parity_run_torch.py [--sessions 1000000] [--aids 100000]
        [--device cuda|cpu] [--recency-host-f64] [--out parity.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES
from otto_tpu_torch.data.splits import split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.eval import oracle as orc
from otto_tpu_torch.models.candidates import regular_candidates
from otto_tpu_torch.models.covisitation import (
    CovisitationMatrices,
    build_covisitation,
    covisit_heuristic_predictions,
    session_unique_counts,
)
from otto_tpu_torch.models.frequency import FrequencyStatistics
from otto_tpu_torch.utils.runtime import device_line, resolve_device


def make_neighbor_table(n_aids: int, nn: int, seed: int) -> np.ndarray:
    """Deterministic distinct-non-self kNN stand-in (parity exercises the
    bonus/vote semantics, not neighbor quality)."""
    rng = np.random.default_rng(seed)
    draw = rng.integers(0, n_aids - 1, size=(n_aids, nn + 8), dtype=np.int64)
    out = np.empty((n_aids, nn), np.int32)
    for a in range(n_aids):
        row = np.unique(draw[a])
        row = row[row != a]
        if len(row) < nn:  # pad deterministically (vanishingly rare)
            extra = [(a + i) % n_aids for i in range(1, nn + 2)]
            row = np.unique(np.concatenate([row, extra]))
            row = row[row != a]
        sel = row[rng.permutation(len(row))[:nn]]
        out[a] = sel
    return out


def rows_to_lists(arr) -> list[list[int]]:
    return [[int(x) for x in row if x >= 0] for row in arr]


def agreement(framework_rows, oracle_rows):
    n = len(oracle_rows)
    exact = sum(f == o for f, o in zip(framework_rows, oracle_rows))
    setm = sum(set(f) == set(o) for f, o in zip(framework_rows, oracle_rows))
    return exact / n, setm / n


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prepare(sessions: int, aids: int, val_fraction: float, seed: int, device,
            load_matrices: str = "", save_matrices: str = "") -> dict:
    """The dataset, its split, the covisitation matrices (built on
    ``device`` unless loaded), the frequency statistics, the stand-in kNN
    tables and the oracle's inputs: everything both sides share."""
    dev = resolve_device(device)
    t0 = time.time()
    store = synthetic_events_v2(n_sessions=sessions, n_aids=aids, seed=seed)
    split = split_by_time(store, val_fraction=val_fraction, seed=seed)
    gen_s = time.time() - t0
    t0 = time.perf_counter()
    if load_matrices:
        mats = CovisitationMatrices.load(load_matrices)
        build_s = 0.0
    else:
        mats = build_covisitation(split.train, aids, device=dev)
        _sync(dev)
        build_s = time.perf_counter() - t0
        if save_matrices:
            mats.save(save_matrices)
    stats = FrequencyStatistics.compute(split.train, n_aids=aids, device=dev)
    val = split.val_input
    aid_lists, type_lists = orc.store_to_lists(val)
    uniq = session_unique_counts(val)
    return {"device": dev, "store": store, "split": split, "mats": mats, "stats": stats,
            "gen_s": gen_s, "build_s": build_s, "ft45": make_neighbor_table(aids, 45, seed=123),
            "aid_lists": aid_lists, "type_lists": type_lists,
            "labels": orc.labels_to_lists(split.val_labels),
            "routes": {"covisitation": np.flatnonzero(uniq < 20),
                       "recency_weight": np.flatnonzero(uniq >= 20)}}


def oracle_heuristic(prep: dict) -> tuple[dict, float]:
    """The oracle's heuristic lists (computed once, cached in ``prep``) and
    its seconds."""
    if "oracle_heuristic" not in prep:
        t0 = time.time()
        mats, stats = prep["mats"], prep["stats"]
        tables15 = {k: orc.table_to_dict(mats.tables[k][0], 15) for k in mats.tables}
        freq = {t: [int(a) for a in stats.top_by_type[t]] for t in EVENT_TYPES}
        prep["oracle_heuristic"] = (orc.oracle_heuristic(
            prep["aid_lists"], prep["type_lists"], tables15, freq,
            orc.neighbor_lists(prep["ft45"])), time.time() - t0)
    return prep["oracle_heuristic"]


def heuristic_parity(prep: dict, recency_host_f64: bool = False) -> dict:
    """The port's ``covisit_heuristic_predictions`` against the oracle:
    exact and set agreement per type, overall and by route, and the
    recalls of both sides."""
    dev, val = prep["device"], prep["split"].val_input
    stats_top = {t: prep["stats"].top_by_type[t] for t in EVENT_TYPES}
    t0 = time.perf_counter()
    fw = covisit_heuristic_predictions(val, prep["mats"], stats_top, ft_neighbors=prep["ft45"],
                                       recency_host_f64=recency_host_f64, device=dev)
    fw_s = time.perf_counter() - t0
    orx, or_s = oracle_heuristic(prep)
    heur = {"framework_s": round(fw_s, 3), "oracle_s": round(or_s, 1),
            "framework_sessions_per_s": round(val.n_sessions / fw_s, 0)}
    fw_lists = {t: rows_to_lists(fw[t]) for t in EVENT_TYPES}
    for t in EVENT_TYPES:
        per_route = {}
        for rname, ridx in prep["routes"].items():
            if not len(ridx):
                continue
            e, s = agreement([fw_lists[t][i] for i in ridx], [orx[t][i] for i in ridx])
            per_route[rname] = {"exact": round(e, 5), "set": round(s, 5)}
        e, s = agreement(fw_lists[t], orx[t])
        heur[t] = {"exact": round(e, 5), "set": round(s, 5), "routes": per_route}
    r_fw = orc.weighted_corpus_recall(fw_lists, prep["labels"])
    r_or = orc.weighted_corpus_recall(orx, prep["labels"])
    heur["recall_framework"] = {k: round(v, 6) for k, v in r_fw.items()}
    heur["recall_oracle"] = {k: round(v, 6) for k, v in r_or.items()}
    heur["recall_delta_weighted"] = round(r_fw["weighted"] - r_or["weighted"], 6)
    return heur


def candidate_parity(prep: dict) -> dict:
    """The port's ``regular_candidates`` against the oracle's: exact and
    set agreement per type, overall and where the vote cap does not bind
    (at most 32 distinct aids), and the candidate-set recall ceilings."""
    dev, val, mats = prep["device"], prep["split"].val_input, prep["mats"]
    ft20 = prep["ft45"][:, :20]
    t0 = time.perf_counter()
    cs = regular_candidates(val, mats, ft_neighbors=ft20, wide_k=20, device=dev)
    fw_s = time.perf_counter() - t0
    t0 = time.time()
    tables20 = {k: orc.table_to_dict(mats.tables[k][0], 20) for k in mats.tables}
    ocs = orc.oracle_regular_candidates(prep["aid_lists"], prep["type_lists"], tables20,
                                        orc.neighbor_lists(ft20))
    or_s = time.time() - t0
    n_uniq = np.array([len(set(a)) for a in prep["aid_lists"]])
    capped = n_uniq > 32  # the port's vote_cap/uniq_cap binding
    cand = {"framework_s": round(fw_s, 3), "oracle_s": round(or_s, 1),
            "framework_sessions_per_s": round(val.n_sessions / fw_s, 0),
            "cap_binding_fraction": round(float(capped.mean()), 5)}
    free = np.flatnonzero(~capped)
    lab = prep["labels"]
    for t in EVENT_TYPES:
        f_rows = rows_to_lists(cs.candidates[t])
        o_rows = ocs[t][0]
        e_all, s_all = agreement(f_rows, o_rows)
        e_free, s_free = agreement([f_rows[i] for i in free], [o_rows[i] for i in free])
        labmap = {"clicks": lab[0], "carts": lab[1], "orders": lab[2]}[t]
        cand[t] = {
            "exact": round(e_all, 5), "set": round(s_all, 5),
            "exact_uncapped": round(e_free, 5), "set_uncapped": round(s_free, 5),
            "ceiling_framework": round(orc.corpus_recall(f_rows, labmap), 6),
            "ceiling_oracle": round(orc.corpus_recall(o_rows, labmap), 6),
        }
    return cand


def summary(results: dict) -> None:
    """The markdown summary of ``tools/parity_run.py``, each time with the
    device it ran on."""
    cfg, card = results["config"], results["device"]
    heur, cand = results["heuristic"], results["regular_candidates"]
    print("\n## Oracle parity summary")
    print(f"dataset: {cfg['sessions']:,} sessions / {cfg['aids']:,} aids / "
          f"{results['n_events']:,} events; val {results['val_sessions']:,} sessions "
          f"(covisit route {results['route_sessions']['covisitation']:,}, "
          f"recency route {results['route_sessions']['recency_weight']:,})")
    print(f"times ({card}): covisit build {results['covisit_build_s']} s, heuristic "
          f"{heur['framework_s']} s (oracle {heur['oracle_s']} s on the host), candidates "
          f"{cand['framework_s']} s (oracle {cand['oracle_s']} s)")
    print("\n| path | type | exact | set | fw recall | oracle recall |")
    print("|---|---|---|---|---|---|")
    for t in EVENT_TYPES:
        print(f"| heuristic | {t} | {heur[t]['exact']:.4f} | {heur[t]['set']:.4f} | "
              f"{heur['recall_framework'][t]:.6f} | {heur['recall_oracle'][t]:.6f} |")
    for t in EVENT_TYPES:
        print(f"| candgen | {t} | {cand[t]['exact']:.4f} | {cand[t]['set']:.4f} | "
              f"{cand[t]['ceiling_framework']:.6f} | {cand[t]['ceiling_oracle']:.6f} |")
    print(f"\nweighted recall: framework {heur['recall_framework']['weighted']:.6f} vs oracle "
          f"{heur['recall_oracle']['weighted']:.6f} (delta {heur['recall_delta_weighted']:+.6f})")


def run(args) -> dict:
    """The whole parity run of ``args`` (this tool's options): the results
    dictionary written to ``--out``."""
    prep = prepare(args.sessions, args.aids, args.val_fraction, args.seed, args.device,
                   args.load_matrices, args.save_matrices)
    card = device_line(prep["device"])
    val = prep["split"].val_input
    print(f"# data: {prep['store']} (gen {prep['gen_s']:.0f}s); train "
          f"{prep['split'].train.n_events} ev / val {val.n_sessions} sessions", flush=True)
    print(f"# covisit build: {prep['build_s']:.2f}s ({card})", flush=True)
    results = {"config": dict(vars(args)), "device": card,
               "n_events": int(prep["store"].n_events), "val_sessions": int(val.n_sessions),
               "covisit_build_s": round(prep["build_s"], 3),
               "covisit_build_events_per_s": round(
                   prep["split"].train.n_events / max(prep["build_s"], 1e-9), 0),
               "route_sessions": {k: int(len(v)) for k, v in prep["routes"].items()}}
    results["heuristic"] = heuristic_parity(prep, recency_host_f64=args.recency_host_f64)
    print(f"# heuristic done: fw {results['heuristic']['framework_s']}s ({card}), oracle "
          f"{results['heuristic']['oracle_s']}s", flush=True)
    results["regular_candidates"] = candidate_parity(prep)
    print(f"# candidates done: fw {results['regular_candidates']['framework_s']}s ({card}), "
          f"oracle {results['regular_candidates']['oracle_s']}s", flush=True)
    return results


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=1_000_000)
    ap.add_argument("--aids", type=int, default=100_000)
    ap.add_argument("--val-fraction", type=float, default=0.12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="parity.json")
    ap.add_argument("--save-matrices", type=str, default="")
    ap.add_argument("--load-matrices", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--recency-host-f64", action="store_true",
                    help="route >=20-unique sessions through the float64 host accumulator "
                         "(exact reference tie-breaks)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    results = run(args)
    Path(args.out).write_text(json.dumps(results, indent=2))
    summary(results)
    print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
