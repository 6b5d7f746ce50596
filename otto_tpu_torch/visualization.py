"""Offline visualization (reference L7: src/visualization.py:10-329 +
src/matrix_factorization/visualization.py:6-62).

Port of ``otto_tpu/visualization.py``; no path that runs on the card
imports it.

Plots: training curves, ranker feature importance (permutation importance —
the tower's analog of GBDT gain/split importance), train/test prediction
histograms, per-session event timelines, and aid-frequency bars.  All
functions write a PNG and return the path; matplotlib is imported lazily with
the Agg backend so headless runs work.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from otto_tpu_torch.logging_utils import get_logger

log = get_logger(__name__)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def visualize_learning_curve(history: list[dict], path: str | Path,
                             keys=("train_loss", "val_loss")) -> Path:
    """Train/val loss curves (mf visualization.py:6-62)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    epochs = [h.get("epoch", i) for i, h in enumerate(history)]
    for key in keys:
        vals = [h.get(key) for h in history]
        if any(v is not None for v in vals):
            ax.plot(epochs, vals, label=key)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return Path(path)


def permutation_importance(model, features: np.ndarray, labels: np.ndarray,
                           mask: np.ndarray, feature_names: list[str],
                           n_sessions: int = 512, seed: int = 0, *,
                           device) -> dict[str, float]:
    """Permutation importance of the ranking tower: drop in mean positive-
    candidate score rank when a feature column is shuffled.  The tower's
    replacement for LightGBM gain importance (lgb_trainer.py:175-180).
    ``model.predict`` scores on ``device``."""
    rng = np.random.default_rng(seed)
    sel = rng.choice(features.shape[0], size=min(n_sessions, features.shape[0]), replace=False)
    X, y, m = features[sel], labels[sel], mask[sel]

    def pos_score(x):
        scores = model.predict(x, m, device=device)
        pos = scores[(y == 1) & m & np.isfinite(scores)]
        return float(pos.mean()) if len(pos) else 0.0

    base = pos_score(X)
    out = {}
    for f, name in enumerate(feature_names):
        Xp = X.copy()
        perm = rng.permutation(len(sel))
        Xp[:, :, f] = Xp[perm][:, :, f]
        out[name] = base - pos_score(Xp)
    return out


def visualize_feature_importance(importance: dict[str, float], path: str | Path,
                                 top_n: int = 40) -> Path:
    """Horizontal importance bars (visualization.py feature-importance plot)."""
    plt = _plt()
    items = sorted(importance.items(), key=lambda kv: kv[1])[-top_n:]
    names = [k for k, _ in items]
    vals = [v for _, v in items]
    fig, ax = plt.subplots(figsize=(8, max(4, len(items) * 0.25)))
    ax.barh(names, vals)
    ax.set_xlabel("importance (score drop when permuted)")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return Path(path)


def visualize_predictions(train_scores: np.ndarray, test_scores: np.ndarray,
                          path: str | Path) -> Path:
    """Train/test prediction histograms (visualization.py:213-251)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, s in (("train", train_scores), ("test", test_scores)):
        s = np.asarray(s)
        s = s[np.isfinite(s)]
        ax.hist(s, bins=50, alpha=0.5, density=True, label=name)
    ax.set_xlabel("prediction score")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return Path(path)


def visualize_session(store, session_idx: int, path: str | Path) -> Path:
    """One session's event timeline colored by type (visualization.py session
    anatomy plot)."""
    plt = _plt()
    lo, hi = store.offsets[session_idx], store.offsets[session_idx + 1]
    ts = store.ts[lo:hi] - store.ts[lo]
    typ = store.type[lo:hi]
    fig, ax = plt.subplots(figsize=(10, 3))
    colors = np.array(["tab:blue", "tab:orange", "tab:red"])
    ax.scatter(ts, store.aid[lo:hi], c=colors[typ], s=30)
    ax.set_xlabel("seconds since session start")
    ax.set_ylabel("aid")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return Path(path)


def visualize_aid_frequencies(counts: np.ndarray, path: str | Path, top_n: int = 20) -> Path:
    """Top-N aid frequency bars (visualization.py aid-frequency plot)."""
    plt = _plt()
    top = np.argsort(-counts)[:top_n]
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar([str(a) for a in top], counts[top])
    ax.set_xlabel("aid")
    ax.set_ylabel("count")
    ax.tick_params(axis="x", rotation=60)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return Path(path)


def visualize_distributions(store, path: str | Path) -> Path:
    """Dataset distribution panel: session lengths, event-type mix, aid
    frequency tail (visualization.py's distribution plots)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    lengths = store.lengths
    axes[0].hist(lengths, bins=min(50, int(lengths.max())), log=True)
    axes[0].set_xlabel("session length")
    axes[0].set_ylabel("sessions (log)")
    type_counts = np.bincount(store.type, minlength=3)
    axes[1].bar(["clicks", "carts", "orders"], type_counts)
    axes[1].set_ylabel("events")
    counts = np.bincount(store.aid)
    counts = counts[counts > 0]
    axes[2].hist(counts, bins=50, log=True)
    axes[2].set_xlabel("events per aid")
    axes[2].set_ylabel("aids (log)")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return Path(path)


def visualize_feature_distribution(
    train_values: np.ndarray,
    test_values: np.ndarray,
    name: str,
    path: str | Path,
    bins: int = 50,
) -> Path:
    """Train-vs-test overlay of one continuous feature with summary stats
    (reference: src/visualization.py:53-95
    visualize_continuous_feature_distribution)."""
    plt = _plt()
    tr = np.asarray(train_values, np.float64)
    te = np.asarray(test_values, np.float64)
    tr = tr[np.isfinite(tr)]
    te = te[np.isfinite(te)]
    fig, ax = plt.subplots(figsize=(8, 4.5))
    lo = min(tr.min(initial=0.0), te.min(initial=0.0))
    hi = max(tr.max(initial=1.0), te.max(initial=1.0))
    edges = np.linspace(lo, hi, bins + 1)
    ax.hist(tr, bins=edges, alpha=0.5, density=True, label=f"train (n={len(tr)})")
    ax.hist(te, bins=edges, alpha=0.5, density=True, label=f"test (n={len(te)})")
    ax.set_title(
        f"{name}\n"
        f"train mean {tr.mean():.4g} std {tr.std():.4g} | "
        f"test mean {te.mean():.4g} std {te.std():.4g}"
    )
    ax.set_xlabel(name)
    ax.set_ylabel("density")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return Path(path)
