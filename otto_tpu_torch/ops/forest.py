"""Forest routing: fold-averaged scores of boosted depth-d trees over
binned rows, or over float32 feature rows binned on the way (K4).

Port of ``otto_tpu/models/gbdt.py::_predict_forest`` (:334), with
``_route_tree`` (:321), the fold average of
``GBDTRankerModel.predict_binned_folds`` (:747-778) and, for float rows,
``bin_features`` (:80).  In the JAX package the forest pass is an XLA program
(a ``lax.scan`` over trees, one dispatch per fold and per 1<<20-row batch),
not a Pallas kernel, and the binning is host numpy.  Here one launch of a
hand-written CUDA kernel (``csrc/forest_kernels.cu::forest_kernel``) routes
every fold of one model over the whole input: :func:`predict_forest` on
uint8 bins, :func:`predict_forest_rows` on float32 rows, which the kernel
bins in its staging against the model's edges.  :func:`bin_rows` bins float32
rows alone, by the same search in a kernel of its own (the GBDT fit's
training rows).  On a CPU tensor each runs its plain twin.

Binning: NaN -> bin 0, any other v -> 1 + #(edges[f] < v).  Routing, for each
row and each fold: walk every tree, ``pos = 2 pos + (bin[feat[i]] > thr[i])``
with ``i = 2^level - 1 + pos``; sum ``base + leaf_0 + leaf_1 + ...`` in tree
order in float32; add the folds in order (``r_0 + r_1 + r_2``) and multiply by
``float32(1 / n_folds)``.  That order is the reference's, so the kernel and
the twins give its float32 result exactly.

The kernel reads the model in slices of 32 trees, one tree a lane: a slice is
int32 ``[2^(depth + 1), 32]``, row ``j`` holding the node of 1-based heap
index ``j`` (``(thr << 7) | feat``, for ``j < 2^depth``) or the float32 bits of
leaf ``j - 2^depth``.  ``thr`` reaches ``n_bins`` (256) at nodes that do not
split; the kernel's compare (``n - (bin << 7) < 0``) sends no bin right there.
``feat`` has 7 bits: the kernel takes F <= 128.  The edges go to the kernel
padded to 256 a feature with +inf (:func:`pack_edges`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from otto_tpu_torch.ops import _kernels

# The kernel's limits: a node's feature has 7 bits, the walk is unrolled
# for depths 1-12, and a feature's edges are searched in 8 steps over 255
# slots (254 edges and +inf: n_bins <= 256).
MAX_FEATURES = 128
MAX_DEPTH = 12
SLICE_TREES = 32
EDGE_SLOTS = 256
FEAT_BITS = 7
# rows routed together by the twin: its [rows, trees] index tensors stay
# near 4M entries
_TWIN_ENTRIES = 1 << 22


@dataclass
class ForestPack:
    """One model's fold forests on one device, all trees in fold order.

    ``feat``/``thr`` int32 [T, 2^depth - 1] (level-order internal nodes),
    ``leaf`` float32 [T, 2^depth], ``fold_end`` int32 [n_folds] (each fold's
    end in the tree axis), ``base`` float32 [n_folds], and ``model`` int32
    [ceil(T / 32), 2^(depth + 1), 32], the kernel's slices (None when a node
    reads a feature past the kernel's 128)."""

    feat: torch.Tensor
    thr: torch.Tensor
    leaf: torch.Tensor
    fold_end: torch.Tensor
    base: torch.Tensor
    model: torch.Tensor | None
    depth: int
    max_feat: int  # the largest feature index a node reads

    @property
    def n_trees(self) -> int:
        return int(self.feat.shape[0])

    @property
    def n_folds(self) -> int:
        return int(self.fold_end.shape[0])

    @property
    def device(self) -> torch.device:
        return self.leaf.device

    def folds(self):
        """(feat, thr, leaf, base) of each fold, in order."""
        ends = self.fold_end.cpu().tolist()
        starts = [0] + ends[:-1]
        return [(self.feat[a:b], self.thr[a:b], self.leaf[a:b], self.base[f])
                for f, (a, b) in enumerate(zip(starts, ends))]


def pack_forests(folds: Sequence[tuple], *, device: str | torch.device) -> ForestPack:
    """Pack fold forests ``(feat, thr, leaf, base)`` (numpy arrays of the
    JAX package's layout, one depth) for :func:`predict_forest` on
    ``device``."""
    if not folds:
        raise ValueError("pack_forests: no fold")
    feats = [np.asarray(f[0]) for f in folds]
    n_internal = feats[0].shape[1]
    depth = int(np.log2(n_internal + 1))
    if (1 << depth) - 1 != n_internal or not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"pack_forests: {n_internal} internal nodes a tree is not a depth "
                         f"of 1-{MAX_DEPTH}")
    for feat, thr, leaf, _ in folds:
        if (np.shape(feat)[1:] != (n_internal,) or np.shape(thr) != np.shape(feat)
                or np.shape(leaf) != (np.shape(feat)[0], n_internal + 1)):
            raise ValueError("pack_forests: folds of different depths or mismatched arrays")
    feat = np.concatenate(feats).astype(np.int32)
    thr = np.concatenate([np.asarray(f[1]) for f in folds]).astype(np.int32)
    leaf = np.concatenate([np.asarray(f[2]) for f in folds]).astype(np.float32)
    if feat.size and (feat.min() < 0 or feat.max() > 0xFFFF or thr.min() < 0
                      or thr.max() > 0x7FFF):
        raise ValueError("pack_forests: the kernel takes 0 <= feat <= 65535 and "
                         "0 <= thr <= 32767")
    fold_end = np.cumsum([len(f) for f in feats]).astype(np.int32)
    base = np.asarray([f[3] for f in folds], np.float32)
    dev = torch.device(device)
    max_feat = int(feat.max()) if feat.size else 0

    def t(a):
        return torch.as_tensor(a, device=dev)

    model = None
    if max_feat < MAX_FEATURES and len(feat):
        T, n_slices = len(feat), -(-len(feat) // SLICE_TREES)
        words = np.zeros((n_slices * SLICE_TREES, 2 << depth), np.int32)  # pad trees: zeros
        words[:T, 1:n_internal + 1] = (thr << FEAT_BITS) | feat
        words[:T, n_internal + 1:] = leaf.view(np.int32)
        model = t(np.ascontiguousarray(
            words.reshape(n_slices, SLICE_TREES, 2 << depth).transpose(0, 2, 1)))
    return ForestPack(feat=t(feat), thr=t(thr), leaf=t(leaf), fold_end=t(fold_end),
                      base=t(base), model=model, depth=depth, max_feat=max_feat)


def pack_edges(edges, *, device: str | torch.device) -> torch.Tensor:
    """A model's bin edges float32 [F, E] (E = n_bins - 2 <= 254, each row
    non-decreasing, as ``fit_bin_edges`` writes them) as the kernel reads
    them: float32 [F, 256] on ``device``, each row padded with +inf.  Raises
    on other shapes, on NaN and on a row that decreases: the kernel's search
    counts the edges below a value only over sorted edges."""
    e = np.asarray(edges)
    if e.dtype != np.float32 or e.ndim != 2 or not 1 <= e.shape[1] <= EDGE_SLOTS - 2:
        raise ValueError(f"pack_edges: edges must be float32 [F, E <= {EDGE_SLOTS - 2}], got "
                         f"{e.dtype} {e.shape}")
    if np.isnan(e).any() or (e[:, 1:] < e[:, :-1]).any():
        raise ValueError("pack_edges: every feature's edges must be non-decreasing, no NaN")
    out = np.full((e.shape[0], EDGE_SLOTS), np.inf, np.float32)
    out[:, : e.shape[1]] = e
    return torch.as_tensor(out, device=torch.device(device))


def _bin_rows_reference(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Plain-torch twin of the kernel's binning, bit-equal to numpy
    ``bin_features``: uint8 [N, F] bins of float32 rows [N, F] against packed
    edges [F, 256] (:func:`pack_edges`): NaN -> 0, else 1 + #(edges[f] < v),
    by ``torch.searchsorted`` (the +inf pads count for no value).  Rows go in
    blocks so the int64 indices stay small."""
    N, F = x.shape
    out = torch.empty((N, F), dtype=torch.uint8, device=x.device)
    step = max(1, _TWIN_ENTRIES // max(F, 1))
    for r0 in range(0, N, step):
        v = x[r0:r0 + step].T.contiguous()  # [F, rows]
        b = torch.searchsorted(edges, v, side="left") + 1
        out[r0:r0 + step] = torch.where(torch.isnan(v), 0, b).T.to(torch.uint8)
    return out


def bin_rows(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """uint8 bins [N, F] of float32 rows [N, F] against packed edges [F, 256]
    (:func:`pack_edges`), as numpy ``bin_features`` bins them: NaN -> 0,
    else 1 + #(edges[f] < v).

    On a CUDA tensor this launches the binning kernel (contiguous rows, F <=
    128, the edges on the same device; anything else raises); on a CPU tensor
    it runs :func:`_bin_rows_reference`.  Rows of another dtype raise, as in
    :func:`predict_forest_rows`."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise TypeError(f"bin_rows: rows must be float32 [N, F], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if edges.dtype != torch.float32 or tuple(edges.shape) != (x.shape[1], EDGE_SLOTS):
        raise ValueError(f"bin_rows: edges must be float32 [{x.shape[1]}, {EDGE_SLOTS}] from "
                         f"pack_edges, got {edges.dtype} {tuple(edges.shape)}")
    if edges.device != x.device:
        raise ValueError(f"bin_rows: rows on {x.device}, edges on {edges.device}")
    if x.device.type == "cpu":
        return _bin_rows_reference(x, edges)
    if x.device.type != "cuda":
        raise ValueError(f"bin_rows: no kernel for device {x.device}")
    if not 1 <= x.shape[1] <= MAX_FEATURES or not x.is_contiguous():
        raise ValueError(f"bin_rows: the kernel takes contiguous rows of 1-{MAX_FEATURES} "
                         f"features, got {tuple(x.shape)}")
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.shape[0]:
        if x.data_ptr() % 16:  # the kernel reads four values at a time
            x = x.clone()
        _kernels.launch_bin_rows(x, edges.contiguous(), out)
        bin_rows.launches += 1
    return out


bin_rows.launches = 0  # kernel launches made by this wrapper


def _route_trees(binned: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                 depth: int) -> torch.Tensor:
    """Leaf id of every row under every tree, int64 [N, T]: the walk of
    ``_route_tree`` with all trees side by side."""
    N, T = binned.shape[0], feat.shape[0]
    n_internal = feat.shape[1] if feat.ndim == 2 else 0
    tree = torch.arange(T, device=binned.device)[None, :] * n_internal
    feat, thr = feat.long(), thr.to(torch.int32)
    pos = torch.zeros((N, T), dtype=torch.int64, device=binned.device)
    for level in range(depth):
        i = tree + ((1 << level) - 1) + pos
        bv = torch.gather(binned, 1, torch.take(feat, i))
        pos = pos * 2 + (bv.to(torch.int32) > torch.take(thr, i)).long()
    return pos


def _route_tree(binned: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                depth: int) -> torch.Tensor:
    """Final leaf id of every row under one tree (level-order arrays), int32
    [N] — ``otto_tpu/models/gbdt.py::_route_tree``."""
    return _route_trees(binned, feat[None], thr[None], depth)[:, 0].to(torch.int32)


def _predict_forest_reference(binned: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                              leaf: torch.Tensor, base, depth: int) -> torch.Tensor:
    """Plain-torch twin of one fold: ``base`` plus every tree's leaf value,
    added in tree order in float32 — ``otto_tpu/models/gbdt.py::_predict_forest``.
    Rows go in blocks so the [rows, trees] index tensors stay small."""
    N, T = binned.shape[0], feat.shape[0]
    base = torch.as_tensor(base, dtype=torch.float32, device=binned.device)
    out = torch.empty(N, dtype=torch.float32, device=binned.device)
    step = max(1, _TWIN_ENTRIES // max(T, 1))
    tree = torch.arange(T, device=binned.device)[None, :]
    for r0 in range(0, N, step):
        x = binned[r0:r0 + step]
        values = leaf[tree, _route_trees(x, feat, thr, depth)].T.contiguous()  # [T, rows]
        pred = base.expand(x.shape[0]).clone()
        for t in range(T):
            pred = pred + values[t]
        out[r0:r0 + step] = pred
    return out


def _check_rows(name: str, x: torch.Tensor, forests: ForestPack) -> None:
    if x.device != forests.device:
        raise ValueError(f"{name}: rows on {x.device}, forests on {forests.device}")
    if forests.max_feat >= x.shape[1] and forests.feat.numel():
        raise ValueError(f"{name}: a node reads feature {forests.max_feat} of {x.shape[1]}")
    if x.device.type == "cuda":
        if x.shape[1] > MAX_FEATURES or forests.model is None:
            raise ValueError(f"{name}: the kernel takes F <= {MAX_FEATURES}, got {x.shape[1]}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous rows")
    elif x.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {x.device}")


def _launch(x: torch.Tensor, edges: torch.Tensor | None, forests: ForestPack) -> torch.Tensor:
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if x.shape[0]:
        _kernels.launch_predict_forest(x, edges, forests.model, forests.n_trees,
                                       forests.fold_end, forests.base, out, forests.depth,
                                       float(np.float32(1.0 / forests.n_folds)))
    return out


def predict_forest(binned: torch.Tensor, forests: ForestPack) -> torch.Tensor:
    """Fold-averaged scores float32 [N] of the packed fold forests over
    binned rows uint8 [N, F].

    On a CUDA tensor this launches the forest kernel once for all folds
    (contiguous rows, F <= 128, the pack on the same device; anything else
    raises); on a CPU tensor it runs :func:`_predict_forest_reference` per
    fold and averages as the kernel does.
    """
    if binned.ndim != 2 or binned.dtype != torch.uint8:
        raise TypeError(f"predict_forest: binned must be uint8 [N, F], got {binned.dtype} "
                        f"{tuple(binned.shape)}")
    _check_rows("predict_forest", binned, forests)
    if binned.device.type == "cpu":
        acc = None
        for feat, thr, leaf, base in forests.folds():
            r = _predict_forest_reference(binned, feat, thr, leaf, base, forests.depth)
            acc = r if acc is None else acc + r
        return acc * torch.tensor(np.float32(1.0 / forests.n_folds))
    out = _launch(binned, None, forests)
    predict_forest.launches += int(binned.shape[0] > 0)
    return out


predict_forest.launches = 0  # kernel launches made by this wrapper


def predict_forest_rows(x: torch.Tensor, edges: torch.Tensor,
                        forests: ForestPack) -> torch.Tensor:
    """Fold-averaged scores float32 [N] of the packed fold forests over
    float32 feature rows [N, F], binned against ``edges`` (the model's,
    packed by :func:`pack_edges`, [F, 256]) as numpy ``bin_features`` bins.

    On a CUDA tensor this launches the forest kernel once, which bins the
    rows in its staging (contiguous rows, F <= 128, everything on one
    device; anything else raises); on a CPU tensor it runs
    :func:`_bin_rows_reference` and then :func:`predict_forest`'s twin.
    Rows of any other dtype raise: numpy compares float64 features in
    float64, and a cast to float32 would move bins.
    """
    if x.ndim != 2 or x.dtype != torch.float32:
        raise TypeError(f"predict_forest_rows: rows must be float32 [N, F], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if edges.dtype != torch.float32 or tuple(edges.shape) != (x.shape[1], EDGE_SLOTS):
        raise ValueError(f"predict_forest_rows: edges must be float32 [{x.shape[1]}, "
                         f"{EDGE_SLOTS}] from pack_edges, got {edges.dtype} "
                         f"{tuple(edges.shape)}")
    if edges.device != x.device:
        raise ValueError(f"predict_forest_rows: rows on {x.device}, edges on {edges.device}")
    _check_rows("predict_forest_rows", x, forests)
    if x.device.type == "cpu":
        return predict_forest(_bin_rows_reference(x, edges), forests)
    out = _launch(x, edges.contiguous(), forests)
    predict_forest_rows.launches += int(x.shape[0] > 0)
    return out


predict_forest_rows.launches = 0  # kernel launches made by this wrapper
