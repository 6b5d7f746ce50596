"""Reranker lift with the heuristic-union protocol on the PyTorch port (the
counterpart of ``examples/10_reranker_lift.py``).

The reference's L6 exists because its lambdarank GBDT beats candidate
ordering (src/ranker/lgb_trainer.py:156-198).  This example shows the
guarantee-then-refine version of that contract:

1. the covisitation heuristic's top-20 is unioned into the candidate grid
   and used as the prior-blend prior, so the two-stage pipeline at alpha = 0
   reproduces the heuristic exactly: it can no longer lose to it;
2. alpha and early stopping are selected on a session half disjoint from
   the reported half, so the reported lift carries no selection optimism.

Run: python examples/torch/10_reranker_lift.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

from otto_tpu_torch import EVENT_TYPES
from otto_tpu_torch.config import RankerConfig
from otto_tpu_torch.data.splits import split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.eval.harness import evaluate_predictions
from otto_tpu_torch.models.covisitation import build_covisitation, covisit_heuristic_predictions
from otto_tpu_torch.models.frequency import FrequencyStatistics
from otto_tpu_torch.twostage import run_two_stage
from otto_tpu_torch.utils.runtime import resolve_device

MARGIN = 5e-3  # how far the disjoint half may fall below the heuristic


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=8_000)
    ap.add_argument("--aids", type=int, default=4_000)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    N = args.aids

    store = synthetic_events_v2(n_sessions=args.sessions, n_aids=N, seed=11)
    split = split_by_time(store, val_fraction=0.2, seed=11)
    mats = build_covisitation(split.train, N, device=dev)
    stats = FrequencyStatistics.compute(split.train, n_aids=N, device=dev)
    stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
    heur = covisit_heuristic_predictions(split.val_input, mats, stats_top,
                                         recency_host_f64=True, device=dev)

    art = run_two_stage(
        split.train, split.val_input, N, labels=split.val_labels,
        matrices=mats, heuristic_preds=heur,
        ranker_config=RankerConfig(hidden_dims=(128, 64), n_folds=2, epochs=args.epochs,
                                   batch_sessions=256, loss="lambdarank"),
        device=dev,
    )

    hold = np.flatnonzero(~art.selection_mask)
    lab_h = split.val_labels.take(hold)
    heur_rep = evaluate_predictions(lab_h, heur["clicks"][hold], heur["carts"][hold],
                                    heur["orders"][hold], device=dev)
    alphas = {t: art.rankers[t].prior_alpha for t in EVENT_TYPES}
    lift = art.report_disjoint.weighted - heur_rep.weighted
    print(f"alphas: {alphas}")
    print(f"heuristic (disjoint half): weighted {heur_rep.weighted:.4f}")
    print(f"two-stage (disjoint half): weighted {art.report_disjoint.weighted:.4f}")
    print(f"lift: {lift:+.4f}")
    # guaranteed on the selection half (alpha=0 reproduces the heuristic); on
    # the disjoint half a selected alpha>0 can drift by generalization noise
    if art.report_disjoint.weighted < heur_rep.weighted - MARGIN:
        raise RuntimeError("two-stage fell materially below the heuristic it unions")
    return {"alphas": {t: float(a) for t, a in alphas.items()},
            "heuristic_weighted": float(heur_rep.weighted),
            "two_stage_weighted": float(art.report_disjoint.weighted), "lift": float(lift),
            "holdout": hold}


if __name__ == "__main__":
    main()
