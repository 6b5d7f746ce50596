"""Gradient-boosted decision trees: inference.

Port of the inference half of ``otto_tpu/models/gbdt.py``:

- :func:`fit_bin_edges` and :func:`bin_features` (:57, :80), copied in
  numpy: quantile edges, NaN -> bin 0, finite v -> 1 + #edges < v;
- :class:`GBDTForest` with ``predict_binned`` (:422-449);
- :class:`GBDTRankerModel`: ``predict``, ``predict_binned_folds``,
  ``feature_importance``, ``save`` and ``load`` (:708-821), and
  :meth:`GBDTRankerModel.from_numpy`, which takes the JAX model's arrays;
- :func:`load_ranker_model` (:883).

``save`` and ``load`` read and write the JAX package's npz layout, so a
model saved by either package loads in the other.  The forest pass goes
through :mod:`otto_tpu_torch.ops.forest`: on the card one launch of the
forest kernel routes every fold over all rows (no batching to a fixed shape,
no per-fold pass), and :meth:`GBDTRankerModel.predict` hands it the float32
rows, which it bins in its staging (``predict_forest_rows``); on the CPU the
plain twins.  The numpy :func:`bin_features` and ``.bin()`` stay as the JAX
module's API.  Training
(``fit_gbdt``, ``train_gbdt_ranker``, the histogram kernel) is not ported
yet (ROADMAP M9).

Missing values get a reserved bin 0, which every split sends left.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from otto_tpu_torch.config import GBDTConfig
from otto_tpu_torch.ops import forest
from otto_tpu_torch.utils.runtime import resolve_device


# ----------------------------------------------------------------- binning
def fit_bin_edges(values: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature quantile bin edges from the finite entries of a flat
    ``[rows, F]`` sample.  Returns ``[F, n_bins - 2]`` (bin 0 is reserved for
    missing, so finite values land in bins ``1 .. n_bins - 1``)."""
    F = values.shape[1]
    n_edges = n_bins - 2
    edges = np.zeros((F, n_edges), np.float32)
    qs = np.linspace(0.0, 1.0, n_edges + 2)[1:-1]
    for f in range(F):
        col = values[:, f]
        col = col[np.isfinite(col)]
        if col.size == 0:
            edges[f] = 0.0
            continue
        e = np.unique(np.quantile(col, qs))
        edges[f, : len(e)] = e
        edges[f, len(e):] = e[-1] if len(e) else 0.0
        # pad with +inf so duplicate tail edges never create spurious bins
        if len(e) < n_edges:
            edges[f, len(e):] = np.float32(np.finfo(np.float32).max)
    return edges


def bin_features(values: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Digitize ``[..., F]`` float features into uint8 bins using ``edges``
    from :func:`fit_bin_edges`.  NaN -> bin 0; finite v -> 1 + #edges < v."""
    flat = values.reshape(-1, values.shape[-1])
    F = flat.shape[1]
    out = np.zeros(flat.shape, np.uint8)
    for f in range(F):
        col = flat[:, f]
        finite = ~np.isnan(col)
        b = 1 + np.searchsorted(edges[f], col[finite], side="left")
        out[finite, f] = b.astype(np.uint8)
    return out.reshape(values.shape)


# ----------------------------------------------------------------- models
@dataclass
class GBDTForest:
    """One trained boosted forest (a single fold's model)."""

    feat: np.ndarray  # int32 [T, 2^depth - 1]
    thr: np.ndarray  # int32 [T, 2^depth - 1]
    leaf: np.ndarray  # float32 [T, 2^depth] (lr-scaled)
    base: float
    depth: int
    gain_importance: np.ndarray  # float64 [F]
    split_importance: np.ndarray  # int64 [F]
    best_iteration: int = 0

    def predict_binned(self, binned: np.ndarray, *, device: str | torch.device) -> np.ndarray:
        """Scores float32 [N] of this forest over binned uint8 [N, F] rows,
        on ``device``."""
        dev = resolve_device(device)
        pack = forest.pack_forests([(self.feat, self.thr, self.leaf, self.base)], device=dev)
        x = torch.as_tensor(np.ascontiguousarray(binned), device=dev)
        return forest.predict_forest(x, pack).cpu().numpy()


@dataclass
class GBDTRankerModel:
    """K-fold GBDT ranker: fold-averaged ``predict``, npz ``save``/``load``
    in the JAX package's layout, and ``prior_alpha`` (the two-stage prior
    blend's weight, NaN when none was selected)."""

    forests: list[GBDTForest]
    edges: np.ndarray  # [F, n_bins - 2]
    config: GBDTConfig
    feature_names: list[str] = field(default_factory=list)
    fold_recalls: list[float] = field(default_factory=list)
    oof_recall: float = float("nan")
    prior_alpha: float = float("nan")
    # the fold forests packed for the forest kernel, one pack per device
    _packs: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def from_numpy(cls, folds, edges, config: GBDTConfig, **kw) -> "GBDTRankerModel":
        """From the arrays of an ``otto_tpu`` ``GBDTRankerModel``: ``folds``
        holds, per fold, a mapping with ``GBDTForest``'s fields (``vars(f)``
        of each of its forests); ``kw`` sets the other fields."""
        forests = [GBDTForest(
            feat=np.asarray(f["feat"], np.int32), thr=np.asarray(f["thr"], np.int32),
            leaf=np.asarray(f["leaf"], np.float32), base=float(f["base"]),
            depth=int(f["depth"]),
            gain_importance=np.asarray(f["gain_importance"], np.float64),
            split_importance=np.asarray(f["split_importance"], np.int64),
            best_iteration=int(f.get("best_iteration", 0)),
        ) for f in folds]
        return cls(forests, np.asarray(edges, np.float32), config, **kw)

    def feature_importance(self, kind: str = "gain") -> np.ndarray:
        """Summed across folds (lgb_trainer.py:175-180 gain/split)."""
        attr = "gain_importance" if kind == "gain" else "split_importance"
        return np.sum([getattr(f, attr) for f in self.forests], axis=0)

    def bin(self, features: np.ndarray) -> np.ndarray:
        """The model's uint8 bins [S * C, F] of a [S, C, F] feature tensor."""
        return bin_features(features, self.edges).reshape(-1, features.shape[-1])

    def predict(self, features: np.ndarray, mask: np.ndarray, *,
                device: str | torch.device) -> np.ndarray:
        """Fold-averaged scores [S, C] (lgb_trainer.py:248-263 semantics) of
        a float32 [S, C, F] feature tensor, -inf where ``mask`` is False; the
        rows cross to ``device`` once and are binned and routed there."""
        S, C, F = features.shape
        x = torch.as_tensor(np.ascontiguousarray(features).reshape(S * C, F),
                            device=resolve_device(device))
        scores = self.predict_rows(x).cpu().numpy().reshape(S, C)
        return np.where(mask, scores, -np.inf)

    def packed_edges(self, device: str | torch.device) -> torch.Tensor:
        """The bin edges packed for the forest kernel on ``device`` (made
        once per device)."""
        key = ("edges", str(resolve_device(device)))
        if key not in self._packs:
            self._packs[key] = forest.pack_edges(self.edges, device=resolve_device(device))
        return self._packs[key]

    def predict_rows(self, x: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
        """Fold-averaged scores float32 [N] of float32 feature rows [N, F] on
        their device: one launch of the forest kernel, which bins them (on
        the CPU, the twins).  On the CPU, ``stats`` (if given) gets the
        twin's binning seconds added to ``binning_s``."""
        pack, edges = self.packed(x.device), self.packed_edges(x.device)
        if stats is None or x.device.type != "cpu":
            return forest.predict_forest_rows(x, edges, pack)
        t0 = time.perf_counter()
        binned = forest._bin_rows_reference(x, edges)
        stats["binning_s"] = stats.get("binning_s", 0.0) + time.perf_counter() - t0
        return forest.predict_forest(binned, pack)

    def packed(self, device: str | torch.device) -> forest.ForestPack:
        """The fold forests packed on ``device`` (made once per device)."""
        dev = resolve_device(device)
        key = str(dev)
        if key not in self._packs:
            self._packs[key] = forest.pack_forests(
                [(f.feat, f.thr, f.leaf, f.base) for f in self.forests], device=dev)
        return self._packs[key]

    def predict_binned_folds(self, binned: np.ndarray, *,
                             device: str | torch.device) -> np.ndarray:
        """Fold-averaged scores float32 [N] for a pre-binned uint8 [N, F]
        matrix: the rows cross to ``device`` once and one forest pass routes
        every fold over them."""
        pack = self.packed(device)
        x = torch.as_tensor(np.ascontiguousarray(binned), device=pack.device)
        return forest.predict_forest(x, pack).cpu().numpy()

    def save(self, path) -> None:
        """The ``.npz`` that ``otto_tpu``'s ``GBDTRankerModel.save`` writes."""
        flat = {}
        for i, f in enumerate(self.forests):
            flat[f"fold{i}_feat"] = f.feat
            flat[f"fold{i}_thr"] = f.thr
            flat[f"fold{i}_leaf"] = f.leaf
            flat[f"fold{i}_meta"] = np.asarray([f.base, f.depth, f.best_iteration])
            flat[f"fold{i}_gain"] = f.gain_importance
            flat[f"fold{i}_split"] = f.split_importance
        np.savez_compressed(
            path, __gbdt=np.int64(1), __n_folds=len(self.forests),
            __edges=self.edges,
            __config=np.frombuffer(self.config.to_json().encode(), np.uint8),
            __features=np.asarray(self.feature_names, dtype=object),
            __fold_recalls=np.asarray(self.fold_recalls, np.float64),
            __oof=np.float64(self.oof_recall),
            __prior_alpha=np.float64(self.prior_alpha),
            **flat,
        )

    @classmethod
    def load(cls, path) -> "GBDTRankerModel":
        """Read an ``.npz`` written by either package's ``save``."""
        with np.load(path, allow_pickle=True) as z:
            config = GBDTConfig.from_dict(json.loads(bytes(z["__config"]).decode()))
            forests = []
            for i in range(int(z["__n_folds"])):
                base, depth, best = z[f"fold{i}_meta"]
                forests.append(GBDTForest(
                    feat=z[f"fold{i}_feat"], thr=z[f"fold{i}_thr"], leaf=z[f"fold{i}_leaf"],
                    base=float(base), depth=int(depth),
                    gain_importance=z[f"fold{i}_gain"], split_importance=z[f"fold{i}_split"],
                    best_iteration=int(best),
                ))
            return cls(
                forests, z["__edges"], config,
                feature_names=[str(f) for f in z["__features"]],
                fold_recalls=list(z["__fold_recalls"]),
                oof_recall=float(z["__oof"]),
                prior_alpha=float(z["__prior_alpha"]),
            )


def load_ranker_model(path) -> GBDTRankerModel:
    """Load a ranker from an npz.  Only the GBDT engine (the ``__gbdt``
    marker) is ported; the listwise tower's npz raises (ROADMAP M12)."""
    with np.load(path, allow_pickle=True) as z:
        is_gbdt = "__gbdt" in z.files
    if not is_gbdt:
        raise NotImplementedError(f"{path}: a listwise-tower ranker; the tower (RankerModel) "
                                  "is not ported yet (ROADMAP M12)")
    return GBDTRankerModel.load(path)
