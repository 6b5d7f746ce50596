"""Forest routing: fold-averaged scores of boosted depth-d trees over
binned rows (K4).

Port of ``otto_tpu/models/gbdt.py::_predict_forest`` (:334), with
``_route_tree`` (:321) and the fold average of
``GBDTRankerModel.predict_binned_folds`` (:747-778).  In the JAX package the
forest pass is an XLA program (a ``lax.scan`` over trees, one dispatch per
fold and per 1<<20-row batch), not a Pallas kernel.  Here
:func:`predict_forest` routes every fold of one model over the whole input
in one launch of a hand-written CUDA kernel
(``csrc/forest_kernels.cu::predict_forest_kernel``); on a CPU tensor it runs
the plain twin.

For each row and each fold: walk every tree, ``pos = 2 pos + (bin[feat[i]] >
thr[i])`` with ``i = 2^level - 1 + pos``; sum ``base + leaf_0 + leaf_1 + ...``
in tree order in float32; add the folds in order (``r_0 + r_1 + r_2``) and
multiply by ``float32(1 / n_folds)``.  That order is the reference's, so the
kernel and the twin give its float32 result exactly.

The kernel packs a node as ``(thr << 16) | feat``: ``thr`` reaches
``n_bins`` (256) at nodes that do not split, so it needs more than 8 bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from otto_tpu_torch.ops import _kernels

# The kernel stages a block's 128 rows of F bytes in shared memory (48 KB
# without an opt-in), and unrolls the walk for depths 1-12.
KERNEL_ROWS = 128
MAX_FEATURES = 48 * 1024 // KERNEL_ROWS
MAX_DEPTH = 12
# rows routed together by the twin: its [rows, trees] index tensors stay
# near 4M entries
_TWIN_ENTRIES = 1 << 22


@dataclass
class ForestPack:
    """One model's fold forests on one device, all trees in fold order.

    ``feat``/``thr`` int32 [T, 2^depth - 1] (level-order internal nodes),
    ``leaf`` float32 [T, 2^depth], ``fold_end`` int32 [n_folds] (each fold's
    end in the tree axis), ``base`` float32 [n_folds], and ``nodes`` int32
    [T, 2^depth - 1], the kernel's ``(thr << 16) | feat``."""

    feat: torch.Tensor
    thr: torch.Tensor
    leaf: torch.Tensor
    fold_end: torch.Tensor
    base: torch.Tensor
    nodes: torch.Tensor
    depth: int
    max_feat: int  # the largest feature index a node reads

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

    def t(a):
        return torch.as_tensor(a, device=dev)

    return ForestPack(feat=t(feat), thr=t(thr), leaf=t(leaf), fold_end=t(fold_end),
                      base=t(base), nodes=t((thr << 16) | feat), depth=depth,
                      max_feat=int(feat.max()) if feat.size else 0)


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


def predict_forest(binned: torch.Tensor, forests: ForestPack) -> torch.Tensor:
    """Fold-averaged scores float32 [N] of the packed fold forests over
    binned rows uint8 [N, F].

    On a CUDA tensor this launches ``predict_forest_kernel`` once for all
    folds (contiguous rows, F <= 384, depth <= 12, the pack on the same
    device; anything else raises); on a CPU tensor it runs
    :func:`_predict_forest_reference` per fold and averages as the kernel
    does.
    """
    if binned.ndim != 2 or binned.dtype != torch.uint8:
        raise TypeError(f"predict_forest: binned must be uint8 [N, F], got {binned.dtype} "
                        f"{tuple(binned.shape)}")
    if binned.device != forests.device:
        raise ValueError(f"predict_forest: rows on {binned.device}, forests on "
                         f"{forests.device}")
    N, F = binned.shape
    if forests.max_feat >= F and forests.feat.numel():
        raise ValueError(f"predict_forest: a node reads feature {forests.max_feat} of {F}")
    inv = np.float32(1.0 / forests.n_folds)
    if binned.device.type == "cpu":
        acc = None
        for feat, thr, leaf, base in forests.folds():
            r = _predict_forest_reference(binned, feat, thr, leaf, base, forests.depth)
            acc = r if acc is None else acc + r
        return acc * torch.tensor(inv)
    if binned.device.type != "cuda":
        raise ValueError(f"predict_forest: no kernel for device {binned.device}")
    if F > MAX_FEATURES:
        raise ValueError(f"predict_forest: the kernel takes F <= {MAX_FEATURES}, got {F}")
    if not binned.is_contiguous():
        raise ValueError("predict_forest: the kernel takes contiguous rows")
    out = torch.empty(N, dtype=torch.float32, device=binned.device)
    if N:
        _kernels.launch_predict_forest(binned, forests.nodes, forests.leaf, forests.fold_end,
                                       forests.base, out, forests.depth, float(inv))
        predict_forest.launches += 1
    return out


predict_forest.launches = 0  # kernel launches made by this wrapper
