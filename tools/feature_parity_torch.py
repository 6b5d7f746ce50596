"""Measured parity of the PyTorch port's ranker feature plane against the
pandas oracle: ``tools/feature_parity.py`` on the port.

Runs the port's feature functions (``otto_tpu_torch/features/*``) and the
reference-semantics pandas oracle (``otto_tpu_torch/eval/feature_oracle.py``)
over the IDENTICAL event store and candidate grid (the covisitation build
and the candidate generator on ``--device``), then reports per column:

- max |delta| over entries where both sides are finite, and relative to
  the column's largest magnitude (at least 1)
- NaN-pattern agreement (fraction of entries whose null-ness matches)

plus a protocol-parity block for GroupKFold + negative sampling
(lgb_trainer.py:81-133): fold sizes, per-fold sampled negative fraction,
and the positive-bearing-session restriction, port vs sklearn + pandas.

The oracle needs pandas and scikit-learn: without them this stops with the
ImportError.  Writes ``tools/feature_parity.py``'s JSON layout (plus
``device``) to ``--out``.

Usage: python tools/feature_parity_torch.py [--sessions 50000] [--aids 8000]
       [--device cuda|cpu] [--out PARITY_FEATURES_torch.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from otto_tpu_torch.data.splits import split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.features import (
    compute_aid_features,
    compute_interaction_features,
    compute_session_features,
)
from otto_tpu_torch.models.candidates import regular_candidates
from otto_tpu_torch.models.covisitation import build_covisitation
from otto_tpu_torch.models.ranker import group_kfold, negative_sample_mask
from otto_tpu_torch.utils.runtime import device_line, resolve_device


def compare(fw: np.ndarray, orc: np.ndarray) -> dict:
    """(max_abs_diff over both-finite, relative to the column's scale,
    nan-pattern agreement, n)."""
    fw = np.asarray(fw, np.float64)
    orc = np.asarray(orc, np.float64)
    fnan, onan = np.isnan(fw), np.isnan(orc)
    both = ~fnan & ~onan
    mad = float(np.max(np.abs(fw[both] - orc[both]))) if both.any() else 0.0
    # relative for large-magnitude columns (ts sums etc.)
    scale = max(float(np.max(np.abs(orc[both]))) if both.any() else 1.0, 1.0)
    return {
        "max_abs_diff": round(mad, 9),
        "max_rel_diff": round(mad / scale, 12),
        "nan_pattern_agree": round(float((fnan == onan).mean()), 6),
        "n": int(fw.size),
    }


def feature_families(fo, target, n_aids: int, c: np.ndarray, s: np.ndarray) -> dict:
    """The three families, port against oracle: each family's seconds on
    both sides and every shared column's :func:`compare`; ``frames`` holds
    the oracle's frames and ``present`` the aids the oracle indexes."""
    out = {}
    t0 = time.time()
    fw_aid = compute_aid_features(target, n_aids)
    fw_s = time.time() - t0
    t0 = time.time()
    df = fo.events_to_frame(target)
    or_aid = fo.oracle_aid_features(df)
    or_s = time.time() - t0
    present = np.flatnonzero(fw_aid["aid_count"] > 0)
    # the oracle is indexed by present aids; align on the intersection order
    or_aid = or_aid.reindex(present)
    aid_cols = sorted(set(fw_aid) & set(or_aid.columns))
    out["aid_features"] = {
        "framework_s": round(fw_s, 1), "oracle_s": round(or_s, 1),
        "n_aids_present": int(len(present)),
        "columns": {col: compare(fw_aid[col][present], or_aid[col].to_numpy())
                    for col in aid_cols},
    }

    t0 = time.time()
    fw_sess = compute_session_features(target, fw_aid)
    fw_s = time.time() - t0
    t0 = time.time()
    or_sess = fo.oracle_session_features(df, or_aid.set_axis(present, axis=0))
    or_s = time.time() - t0
    or_sess = or_sess.reindex(np.arange(target.n_sessions))
    sess_cols = sorted(set(fw_sess) & set(or_sess.columns))
    out["session_features"] = {
        "framework_s": round(fw_s, 1), "oracle_s": round(or_s, 1),
        "columns": {col: compare(fw_sess[col], or_sess[col].to_numpy()) for col in sess_cols},
    }

    t0 = time.time()
    fw_int = compute_interaction_features(target, c, s, n_aids)
    fw_s = time.time() - t0
    t0 = time.time()
    or_int = fo.oracle_interaction_features(df, c, s)
    or_s = time.time() - t0
    ok = (c >= 0).reshape(-1)
    int_cols = sorted(set(fw_int) & set(or_int.columns) - {"session", "candidates"})
    out["interaction_features"] = {
        "framework_s": round(fw_s, 1), "oracle_s": round(or_s, 1), "n_pairs": int(ok.sum()),
        "columns": {col: compare(fw_int[col].reshape(-1)[ok], or_int[col].to_numpy())
                    for col in int_cols},
    }
    return out


def protocol(fo, c: np.ndarray, labels: np.ndarray) -> dict:
    """GroupKFold + negative sampling, port against sklearn + pandas."""
    mask = c >= 0
    S, C = c.shape
    sizes = mask.sum(axis=1)
    fw_folds = group_kfold(sizes, 5)
    sess_rows = np.repeat(np.arange(S), C)[mask.reshape(-1)]
    lab_rows = labels.reshape(-1)[mask.reshape(-1)].astype(np.int64)
    oracle_folds = fo.oracle_fold_and_sampling(sess_rows, lab_rows, n_folds=5, ratio=0.30)

    fw_fold_sizes = [int(sizes[fw_folds == f].sum()) for f in range(5)]
    or_fold_sizes = [int(len(f["val_rows"])) for f in oracle_folds]
    keep = negative_sample_mask(labels, mask, 0.30, np.random.default_rng(0))
    has_pos = (labels * mask).sum(axis=1) > 0
    negs_eligible = mask & (labels == 0) & has_pos[:, None]
    fw_neg_frac = float((keep & negs_eligible).sum() / max(negs_eligible.sum(), 1))
    fw_stray = int((keep & mask & (labels == 0) & ~has_pos[:, None]).sum())
    pos_sessions = np.unique(sess_rows[lab_rows == 1])
    or_stray = 0
    or_neg_fracs = []
    for f in oracle_folds:
        rows = f["train_rows"]
        r_lab = lab_rows[rows]
        r_sess = sess_rows[rows]
        or_stray += int((~np.isin(r_sess[r_lab == 0], pos_sessions)).sum())
        or_neg_fracs.append(round(f["neg_sampled"] / max(f["neg_eligible"], 1), 4))
    return {
        "framework_fold_row_sizes": fw_fold_sizes,
        "oracle_fold_val_sizes": or_fold_sizes,
        "fold_balance_framework": round(max(fw_fold_sizes) / max(min(fw_fold_sizes), 1), 4),
        "framework_sampled_negative_fraction": round(fw_neg_frac, 4),
        "oracle_sampled_negative_fractions": or_neg_fracs,
        "target_ratio": 0.30,
        "framework_strays_outside_positive_sessions": fw_stray,
        "oracle_strays_outside_positive_sessions": or_stray,
    }


def run(sessions: int, aids: int, seed: int, device) -> dict:
    """The whole parity measurement (without ``config``)."""
    from otto_tpu_torch.eval import feature_oracle as fo  # pandas; sklearn when folding

    import sklearn  # noqa: F401  (the fold oracle's; fail before the long part)

    dev = resolve_device(device)
    t0 = time.time()
    store = synthetic_events_v2(n_sessions=sessions, n_aids=aids, seed=seed)
    split = split_by_time(store, val_fraction=0.15, seed=seed)
    target = split.val_input
    print(f"# data: {store.n_events} events ({time.time() - t0:.0f}s)", flush=True)
    mats = build_covisitation(split.train, aids, device=dev)
    cands = regular_candidates(target, mats, labels=split.val_labels, device=dev)
    c, s = cands.candidates["orders"], cands.scores["orders"]
    results = {"device": device_line(dev)}
    results.update(feature_families(fo, target, aids, c, s))
    for fam in ("aid_features", "session_features", "interaction_features"):
        r = results[fam]
        print(f"# {fam}: fw {r['framework_s']}s oracle {r['oracle_s']}s "
              f"({len(r['columns'])} shared columns)", flush=True)
    results["protocol"] = protocol(fo, c, cands.labels["orders"])
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=50_000)
    ap.add_argument("--aids", type=int, default=8_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default="PARITY_FEATURES_torch.json")
    args = ap.parse_args(argv)
    results = {"config": vars(args), **run(args.sessions, args.aids, args.seed, args.device)}
    Path(args.out).write_text(json.dumps(results, indent=1))

    # summary: worst columns per family
    print("\n## Feature parity summary (worst 5 columns per family)")
    for fam in ("aid_features", "session_features", "interaction_features"):
        cols = results[fam]["columns"]
        worst = sorted(cols.items(), key=lambda kv: -kv[1]["max_rel_diff"])[:5]
        print(f"\n{fam}: {len(cols)} columns")
        for name, st in worst:
            print(f"  {name}: max_abs {st['max_abs_diff']:.3g} "
                  f"rel {st['max_rel_diff']:.3g} nan_agree {st['nan_pattern_agree']:.4f}")
    print(f"\nprotocol: {results['protocol']}")
    print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
