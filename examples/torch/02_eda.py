"""EDA example on the PyTorch port (the counterpart of
``examples/02_eda.py``, which replaces the reference's EDA notebook):
distributions, session anatomy, and a worked recall@20 example for one
session, the recalls computed on ``--device``.

The two figures need matplotlib; where it is not installed the example
says so and writes none.

Run: python examples/torch/02_eda.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from otto_tpu_torch import visualization as viz
from otto_tpu_torch.data import splits
from otto_tpu_torch.data.synthetic import synthetic_events
from otto_tpu_torch.eval.metrics import cart_order_recall_at_k, click_recall_at_k
from otto_tpu_torch.utils.runtime import resolve_device


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=5_000)
    ap.add_argument("--aids", type=int, default=1_000)
    ap.add_argument("--session", type=int, default=0, help="the worked example's session")
    ap.add_argument("--out-dir", default=None,
                    help="where the figures go (default: a new temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    store = synthetic_events(n_sessions=args.sessions, n_aids=args.aids)
    counts = np.bincount(store.aid, minlength=args.aids).astype(float)
    type_mix = np.bincount(store.type, minlength=3) / store.n_events
    print("events:", store.n_events, "sessions:", store.n_sessions)
    print("type mix:", type_mix)
    figures = []
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("figures not written: matplotlib is not installed")
    else:
        out_dir = Path(args.out_dir or tempfile.mkdtemp(prefix="otto_eda_"))
        figures = [str(viz.visualize_aid_frequencies(counts, out_dir / "eda_freq.png")),
                   str(viz.visualize_session(store, 0, out_dir / "eda_session.png"))]
        print("figures:", *figures)

    # worked recall example (reference EDA notebook cells 41-45)
    sp = splits.split_by_fraction(store, val_fraction=0.2)
    s = args.session
    preds = np.full((1, 20), -1, np.int32)
    lo, hi = sp.val_input.offsets[s], sp.val_input.offsets[s + 1]
    own = list(dict.fromkeys(sp.val_input.aid[lo:hi][::-1].tolist()))[:20]
    preds[0, : len(own)] = own
    p = torch.as_tensor(preds, device=dev)
    click_r, _ = click_recall_at_k(p, torch.as_tensor(sp.val_labels.click[s: s + 1], device=dev))
    cart_r, _ = cart_order_recall_at_k(
        p, torch.as_tensor(sp.val_labels.padded("carts")[s: s + 1], device=dev))
    session_id = int(sp.val_input.session_ids[s])
    print(f"session {session_id}: click recall {float(click_r):.0f}, "
          f"cart recall {float(cart_r):.2f}")
    return {"n_events": int(store.n_events), "n_sessions": int(store.n_sessions),
            "type_mix": type_mix.tolist(), "top_aid_count": float(counts.max()),
            "session_id": session_id, "own_aids": own, "click_recall": float(click_r),
            "cart_recall": float(cart_r), "figures": figures}


if __name__ == "__main__":
    main()
