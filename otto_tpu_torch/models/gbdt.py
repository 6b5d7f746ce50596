"""Gradient-boosted decision trees: training and inference.

Port of ``otto_tpu/models/gbdt.py``:

- :func:`fit_bin_edges` and :func:`bin_features` (:57, :80), copied in
  numpy: quantile edges, NaN -> bin 0, finite v -> 1 + #edges < v; and
  :func:`fit_bin_edges_rows`, the same edges from rows on the device (a
  device sort, numpy's interpolation on the host);
- :func:`_grow_tree` (``_grow_tree_impl``, :163-311): level-wise growth on
  the device, each level's histogram from the hand-written kernel K5
  (:mod:`otto_tpu_torch.ops.hist`) over a row list kept grouped by node,
  split search, routing and leaves in plain torch;
- the objectives :func:`_lambdarank_gh` (:354) and :func:`_bce_gh` (:412);
- :func:`fit_gbdt` (:452-703) and :func:`train_gbdt_ranker` (:824-880), the
  reference's fold protocol with MAP@20 early stopping;
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
module's API; training bins its rows on the device (``bin_rows``).  A fit
keeps its rows, gradients, bags, histograms, routing and scores on the
device and reads back each tree's arrays and the early-stopping metric; on the card it gives the same bits on every run (K5
sums in integer fixed point, and the leaves come from the last level's
histogram, not from a float scatter).

Missing values get a reserved bin 0, which every split sends left.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from otto_tpu_torch.config import GBDTConfig
from otto_tpu_torch.eval.metrics import map_at_k
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.models.ranker import RankerData, group_kfold, negative_sample_mask
from otto_tpu_torch.ops import forest
from otto_tpu_torch.ops.forest import bin_rows
from otto_tpu_torch.ops.hist import node_histograms, pad_rows
from otto_tpu_torch.utils.runtime import resolve_device

log = get_logger(__name__)


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


def fit_bin_edges_rows(x: torch.Tensor, mask: torch.Tensor, n_bins: int) -> np.ndarray:
    """:func:`fit_bin_edges` of the rows of ``x`` (float32 [N, F], on any
    device) where ``mask`` (bool [N]) is True, value-equal to it.

    The heavy part runs on the rows' device: each column sorted (the finite
    masked entries first: the rest become +inf), the finite entries counted,
    and, for every quantile, the two order statistics that numpy's
    ``'linear'`` quantile reads gathered.  The host reads those [F, E, 2]
    values back once and finishes with numpy's own arithmetic
    (``numpy/lib/_function_base_impl.py::_quantile``: the virtual index ``(n -
    1) q`` in float64, a last index past the end for n = 1, and ``_lerp``'s two
    formulas either side of a weight of 0.5, in float64 from the float32
    statistics), then ``np.unique`` in float64, the float32 cast and the pads of
    :func:`fit_bin_edges`.  A statistic that is zero may come back as -0.0
    where numpy reads +0.0 or the reverse (the sort does not order them): the
    edges are equal as values, and so are the bins."""
    N, F = x.shape
    n_edges = n_bins - 2
    qs = np.linspace(0.0, 1.0, n_edges + 2)[1:-1]
    ok = torch.isfinite(x) & mask[:, None]
    cols = torch.sort(torch.where(ok, x, float("inf")).T.contiguous(), dim=1).values
    n = ok.sum(dim=0).cpu().numpy().astype(np.int64)
    virtual = (n[:, None] - 1) * qs[None, :]  # [F, E] float64, as numpy's (n - 1) * q
    prev = np.floor(virtual)
    nxt = prev + 1
    last = virtual >= (n - 1)[:, None]  # numpy reads its last entry (index -1) there
    prev[last] = -1
    nxt[last] = -1
    gamma = virtual - prev
    at = np.stack([np.where(last, n[:, None] - 1, prev), np.where(last, n[:, None] - 1, nxt)],
                  axis=2).astype(np.int64).clip(0, max(N - 1, 0))
    stats = np.zeros((F, n_edges, 2), np.float32)
    if N:
        stats = cols.gather(1, torch.as_tensor(at.reshape(F, -1), device=x.device)).cpu() \
            .numpy().reshape(F, n_edges, 2)
    a, b = stats[..., 0], stats[..., 1]
    # the columns without a finite entry read +inf here and are not used
    with np.errstate(over="ignore", invalid="ignore"):
        diff = np.subtract(b, a)  # float32, as numpy's _lerp
        q = np.asanyarray(np.add(a, diff * gamma))
        np.subtract(b, diff * (1 - gamma), out=q, where=gamma >= 0.5, casting="unsafe",
                    dtype=type(q.dtype))
    edges = np.zeros((F, n_edges), np.float32)
    for f in range(F):
        if n[f] == 0:
            continue
        e = np.unique(q[f])
        edges[f, : len(e)] = e
        edges[f, len(e):] = e[-1] if len(e) else 0.0
        if len(e) < n_edges:
            edges[f, len(e):] = np.float32(np.finfo(np.float32).max)
    return edges


# ----------------------------------------------------------------- grow
HIST_IMPLS = ("matmul", "scatter")


def _f32(x) -> float:
    """A Python float holding ``x`` rounded to float32, as the reference's
    ``jnp.float32`` scalars: torch then computes with it in float32."""
    return float(np.float32(x))


def _row_list(vals: torch.Tensor):
    """A tree's first row list: the rows with a non-zero val, in row order
    (the others add nothing to any histogram), int32, and its bounds, int64
    [2]: the root's rows are the whole list.  Reads the list's length back
    (one read a tree)."""
    order = torch.nonzero((vals != 0).any(dim=1))[:, 0].to(torch.int32)
    return order, torch.tensor([0, order.shape[0]], device=vals.device)


def _split_rows(order: torch.Tensor, seg: torch.Tensor, node: torch.Tensor):
    """Split each node's stretch of the row list stably into its left and
    right children's, after a level's routing (``node``: each row's child,
    ``2 parent + right``); ``seg`` [n + 1] bounds the n nodes' stretches.
    Returns the new list and its 2n + 1 bounds: a pure function of the
    routing, with no read back to the host."""
    M = order.shape[0]
    child = node[order.long()]
    right = (child & 1) == 1
    sid = child >> 1  # the stretch of each position
    lefts = torch.zeros(M + 1, dtype=torch.int64, device=order.device)
    lefts[1:] = torch.cumsum(~right, dim=0)  # left-going positions before each one
    n_left = lefts[seg[1:]] - lefts[seg[:-1]]  # a stretch's left-going rows
    first = seg[sid]
    before = lefts[:-1] - lefts[first]  # left-going positions before this one in its stretch
    pos = torch.arange(M, device=order.device)
    dest = torch.where(right, n_left[sid] + pos - before, first + before)
    new = torch.empty_like(order)
    new[dest] = order
    return new, torch.cat([torch.stack([seg[:-1], seg[:-1] + n_left], dim=1).reshape(-1),
                           seg[-1:]])


def _grow_tree(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
               weight: torch.Tensor, bag: torch.Tensor, feat_mask: torch.Tensor,
               reg_lambda, min_split_gain, min_data_in_leaf, min_child_weight, learning_rate,
               *, depth: int, n_bins: int, hist_impl: str = "matmul",
               rows: torch.Tensor | None = None):
    """Grow one depth-``depth`` tree level-wise on the rows' device
    (``_grow_tree_impl``, :163-311).

    binned uint8 [N, F]; grad, hess, weight (1 = usable training row, 0 =
    padding or sampled out) and bag (this tree's bagging mask) float32 [N];
    feat_mask bool [F] (this tree's feature_fraction); ``rows``, the
    histogram kernel's padded copy of ``binned`` (:func:`pad_rows`; made here
    when None: a fit makes it once).  Returns level-order split features and
    thresholds int32 and gains float32 (``2^depth - 1`` internal nodes: level
    ``l`` position ``p`` is at ``2^l - 1 + p``), the lr-scaled leaf values
    float32 [2^depth], and each row's leaf id int32 [N].

    Level 0 builds the full histogram; every later level builds the left
    children's only and takes right = parent - left, LightGBM's sibling
    subtraction, the semantics of the reference's default
    ``hist_impl="matmul"``.  Both names of ``hist_impl`` run the histogram
    kernel K5 (on the CPU its twin): the MXU one-hot matmul and the XLA
    scatter are the reference's two ways to the same sums.  K5 reads the
    rows through a row list that stays grouped by node: the rows with a
    non-zero (grad, hess, weight) in row order (:func:`_row_list`, the one
    read back of a tree), split stably after each level's routing
    (:func:`_split_rows`); the vals, their largest magnitudes and so K5's
    fixed-point scale are the tree's.  A node whose every split is invalid
    (gain -inf) or gains no more than ``min_split_gain`` does not split:
    feature 0, threshold ``n_bins``, every row left.  The leaf sums are the
    last level's histogram at the chosen split (left: the cumulative sums at
    the threshold; right: the node's total less those), which equal the
    reference's scatter of the rows' gradients where the sums are exact.
    """
    if hist_impl not in HIST_IMPLS:
        raise ValueError(f"_grow_tree: hist_impl {hist_impl!r} is not one of {HIST_IMPLS}")
    N, F = binned.shape
    dev = binned.device
    rows = pad_rows(binned) if rows is None else rows
    lam = _f32(np.float32(reg_lambda) + np.float32(1e-12))
    min_data = _f32(max(np.float32(min_data_in_leaf), np.float32(1.0)))
    min_child = _f32(min_child_weight)
    min_gain = _f32(min_split_gain)
    g = grad * bag
    h = hess * bag
    w = weight * bag
    vals = torch.stack([g, h, w], dim=1).contiguous()
    vmax = vals.abs().amax(dim=0) if N else torch.zeros(3, device=dev)
    order, seg = _row_list(vals)
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    fmask = feat_mask.to(device=dev, dtype=torch.bool)[None, :, None]
    feats, thrs, gains = [], [], []
    parent_hist = None
    for level in range(depth):
        n_nodes = 1 << level
        if level == 0:
            hist = node_histograms(rows, F, vals, vmax, order, seg[:1], seg - seg[0], n_bins)
        else:  # the left children, node 2p of the level keyed by its parent p
            start = seg[0:-1:2]
            pre = torch.cat([seg.new_zeros(1), torch.cumsum(seg[1::2] - start, dim=0)])
            left = node_histograms(rows, F, vals, vmax, order, start, pre, n_bins)
            hist = torch.stack([left, parent_hist - left], dim=1).reshape(n_nodes, F, n_bins, 3)
        parent_hist = hist
        cg = torch.cumsum(hist[..., 0], dim=-1)
        ch = torch.cumsum(hist[..., 1], dim=-1)
        cc = torch.cumsum(hist[..., 2], dim=-1)
        G, H, C = cg[..., -1:], ch[..., -1:], cc[..., -1:]
        GR, HR, CR = G - cg, H - ch, C - cc
        gain = cg * cg / (ch + lam) + GR * GR / (HR + lam) - G * G / (H + lam)
        valid = ((cc >= min_data) & (CR >= min_data) & (ch >= min_child) & (HR >= min_child)
                 & fmask)
        flat = torch.where(valid, gain, float("-inf")).reshape(n_nodes, F * n_bins)
        best = torch.argmax(flat, dim=1)  # the first of equal maxima, as jnp.argmax
        best_gain = flat.gather(1, best[:, None])[:, 0]
        ok = best_gain > min_gain
        bf = torch.where(ok, best // n_bins, 0)
        bb = torch.where(ok, best % n_bins, n_bins)
        feats.append(bf)
        thrs.append(bb)
        gains.append(torch.where(ok, best_gain, 0.0))
        bv = binned.gather(1, bf[node][:, None])[:, 0]
        node = node * 2 + (bv.to(torch.int64) > bb[node]).to(torch.int64)
        if level + 1 < depth:
            order, seg = _split_rows(order, seg, node)
    # the leaves' sums at the last level's chosen splits: leaf 2n left, 2n + 1 right
    at = torch.arange(len(bf), device=dev)
    col = bb.clamp(max=n_bins - 1)
    sums = []
    for cum in (cg, ch):
        left = cum[at, bf, col]
        sums.append(torch.stack([left, cum[at, bf, -1] - left], dim=1).reshape(-1))
    leaf = (-sums[0] / (sums[1] + lam)) * _f32(learning_rate)
    return (torch.cat(feats).to(torch.int32), torch.cat(thrs).to(torch.int32), leaf,
            torch.cat(gains), node.to(torch.int32))


# ----------------------------------------------------------------- objectives
def _lambdarank_gh(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, *,
                   k: int = 20, chunk: int = 1024, norm: bool = True):
    """LambdaRank gradients/hessians over listwise ``[S, C]`` groups
    (:354-409), ``chunk`` sessions at a time.

    For each within-session pair (i, j) with label_i > label_j:
      rho  = sigmoid(s_j - s_i)
      g_i -= rho * |dDCG@k|;  g_j += rho * |dDCG@k|
      h   += rho * (1 - rho) * |dDCG@k|
    With ``norm`` (LightGBM's ``lambdarank_norm``) |dDCG| is divided by the
    session's ideal DCG@k.  Ranks come from a stable sort of the scores,
    descending, masked columns at -1e30 (``jnp.argsort`` is stable).
    """
    S, C = scores.shape
    dev = scores.device
    disc_table = 1.0 / torch.log2(torch.arange(C, dtype=torch.float32, device=dev) + 2.0)
    ideal = torch.cumsum(disc_table[:k], dim=0)
    g_out = torch.empty((S, C), dtype=torch.float32, device=dev)
    h_out = torch.empty((S, C), dtype=torch.float32, device=dev)
    cols = torch.arange(C, device=dev)
    for s0 in range(0, S, chunk):
        s, m = scores[s0:s0 + chunk], mask[s0:s0 + chunk]
        lab = labels[s0:s0 + chunk].to(torch.float32)
        sm = torch.where(m, s, -1e30)
        order = torch.argsort(-sm, dim=1, stable=True)
        ranks = torch.empty_like(order).scatter_(1, order, cols.expand_as(order))
        disc = torch.where(ranks < k, disc_table[ranks.clamp(0, C - 1)], 0.0)
        pos_pair = (lab[:, :, None] > lab[:, None, :]) & m[:, :, None] & m[:, None, :]
        rho = torch.sigmoid(sm[:, None, :] - sm[:, :, None])  # sigmoid(s_j - s_i)
        delta = (disc[:, :, None] - disc[:, None, :]).abs()
        if norm:
            # ideal DCG@k with binary gains: positives stacked at the top
            n_pos = ((lab > 0) & m).sum(dim=1)
            idx = (torch.minimum(n_pos, torch.tensor(k, device=dev)) - 1).clamp(
                0, len(ideal) - 1)
            max_dcg = torch.where(n_pos > 0, ideal[idx], 1.0)
            delta = delta / max_dcg[:, None, None]
        lam = torch.where(pos_pair, rho * delta, 0.0)
        hc = torch.where(pos_pair, rho * (1.0 - rho) * delta, 0.0)
        del rho, delta, pos_pair
        g_out[s0:s0 + chunk] = -lam.sum(dim=2) + lam.sum(dim=1)
        h_out[s0:s0 + chunk] = hc.sum(dim=2) + hc.sum(dim=1)
        del lam, hc
    return g_out, h_out


def _bce_gh(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Pointwise logistic gradients/hessians (:412-417)."""
    p = torch.sigmoid(scores)
    g = torch.where(mask, p - labels.to(torch.float32), 0.0)
    h = torch.where(mask, p * (1.0 - p), 0.0)
    return g, h


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

    def predict_binned(self, binned, *, device: str | torch.device) -> np.ndarray:
        """Scores float32 [N] of this forest over binned uint8 [N, F] rows
        (numpy, or a tensor), on ``device``."""
        dev = resolve_device(device)
        pack = forest.pack_forests([(self.feat, self.thr, self.leaf, self.base)], device=dev)
        return forest.predict_forest(_on(binned, dev), pack).cpu().numpy()


def _on(a, dev: torch.device) -> torch.Tensor:
    """``a`` (numpy, or a tensor) as a contiguous tensor on ``dev``."""
    if torch.is_tensor(a):
        return a.to(dev).contiguous()
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def fit_gbdt(
    binned,  # uint8 [S, C, F] (listwise): numpy, or a tensor (on ``device``: kept there)
    labels: np.ndarray,  # int [S, C]
    mask: np.ndarray,  # bool [S, C] — candidate validity
    train_weight: np.ndarray,  # f32 [S, C] — 1 for rows kept for training
    config: GBDTConfig,
    *,
    val: tuple | None = None,
    seed_offset: int = 0,
    mesh=None,
    device: str | torch.device,
) -> GBDTForest:
    """Boost one forest over listwise candidate groups on ``device``
    (:452-703).

    The bins may be numpy or a tensor (``train_gbdt_ranker`` hands over
    the fold's rows already on the card); the fit pads them once for the
    histogram kernel (:func:`pad_rows`).  ``val = (binned, labels, mask)``
    (its bins likewise) enables MAP@20 early stopping with
    ``early_stopping_rounds`` patience, measured every ``eval_every`` trees
    (the reference's valid_sets + eval_at=[20] contract,
    lgb_trainer.py:156-165); with ``trees_per_call > 1`` once per segment of
    that many trees, patience counted in trees (:604-629; the reference's
    dispatch batching itself is a TPU workaround and is not ported).  The
    forest keeps the trees up to the best metric.

    ``config.hist_impl`` takes both of the reference's names; both run the
    histogram kernel K5.  Random draws: feature_fraction from
    ``np.random.default_rng(config.seed + seed_offset)`` exactly as the
    reference draws it, so the feature masks equal its own; bagging from a
    ``torch.Generator`` on the CPU with that seed (the reference draws
    through ``jax.random``, which the port cannot match), uploaded, so the
    card and the CPU draw the same bags.  ``mesh`` (data-parallel growth)
    is not ported and raises.
    """
    if mesh is not None:
        raise NotImplementedError("fit_gbdt: data-parallel growth over a mesh is not ported "
                                  "yet (ROADMAP M15)")
    dev = resolve_device(device)
    S, C, F = binned.shape
    N = S * C
    flat = _on(binned, dev).reshape(N, F)
    rows = pad_rows(flat)
    lab_d = torch.as_tensor(labels, device=dev)
    w_d = torch.as_tensor(np.asarray(train_weight, np.float32), device=dev)
    w_flat = w_d.reshape(N)
    keep_mask = w_d > 0  # pairs/pointwise terms use only kept rows
    depth, n_bins = config.max_depth, config.n_bins
    rng = np.random.default_rng(config.seed + seed_offset)
    bag_gen = torch.Generator(device="cpu").manual_seed(config.seed + seed_offset)

    if config.loss == "bce":
        pos = float((labels * train_weight).sum())
        tot = float(train_weight.sum())
        p0 = min(max(pos / max(tot, 1.0), 1e-6), 1 - 1e-6)
        base = float(np.log(p0 / (1 - p0)))  # boost_from_average
    else:
        base = 0.0
    pred = torch.full((S, C), base, dtype=torch.float32, device=dev)
    if val is not None:
        vb, vl, vm = val
        Sv, Cv, _ = vb.shape
        vflat = _on(vb, dev).reshape(Sv * Cv, F)
        vl_d = torch.as_tensor(vl.astype(np.int32), device=dev)
        vm_d = torch.as_tensor(vm, device=dev)
        val_pred = torch.full((Sv * Cv,), base, dtype=torch.float32, device=dev)

    gain_imp = np.zeros(F, np.float64)
    split_imp = np.zeros(F, np.int64)
    feats_l, thrs_l, leaves_l = [], [], []
    best_metric, best_iter, since_best = -np.inf, 0, 0
    chunk = min(config.chunk_sessions, max(S, 1))
    # the early-stopping metric's cadence: every eval_every trees (and the
    # last), or at the end of each segment of trees_per_call trees
    per = config.trees_per_call if config.trees_per_call > 1 else config.eval_every
    scalars = (config.reg_lambda, config.min_split_gain, config.min_data_in_leaf,
               config.min_child_weight, config.learning_rate)
    for t in range(config.n_trees):
        if config.loss == "lambdarank":
            g, h = _lambdarank_gh(pred, lab_d, keep_mask, k=config.lambdarank_k, chunk=chunk,
                                  norm=config.lambdarank_norm)
        else:
            g, h = _bce_gh(pred, lab_d, keep_mask)
        g = g.reshape(N) * w_flat
        h = h.reshape(N) * w_flat
        if config.subsample < 1.0:
            bag = (torch.rand(N, generator=bag_gen) < config.subsample).to(
                device=dev, dtype=torch.float32)
        else:
            bag = torch.ones(N, dtype=torch.float32, device=dev)
        if config.colsample < 1.0:
            n_take = max(int(round(config.colsample * F)), 1)
            cols = rng.choice(F, size=n_take, replace=False)
            fm = np.zeros(F, bool)
            fm[cols] = True
        else:
            fm = np.ones(F, bool)

        feat, thr, leaf, gains, leaf_idx = _grow_tree(
            flat, g, h, w_flat, bag, torch.as_tensor(fm, device=dev), *scalars,
            depth=depth, n_bins=n_bins, hist_impl=config.hist_impl, rows=rows)
        pred = pred + leaf[leaf_idx].reshape(S, C)
        feat_h, gains_h = feat.cpu().numpy(), gains.cpu().numpy()
        is_split = gains_h > 0
        np.add.at(gain_imp, feat_h[is_split], gains_h[is_split])
        np.add.at(split_imp, feat_h[is_split], 1)
        feats_l.append(feat_h)
        thrs_l.append(thr.cpu().numpy())
        leaves_l.append(leaf.cpu().numpy())

        if val is not None:
            vpos = forest._route_tree(vflat, feat, thr, depth)
            val_pred = val_pred + leaf[vpos]
            if (t + 1) % per == 0 or t == config.n_trees - 1:
                vs = torch.where(vm_d, val_pred.reshape(Sv, Cv), float("-inf"))
                metric = float(map_at_k(vs, vl_d, vm_d, k=20))
                if metric > best_metric + 1e-9:
                    best_metric, best_iter, since_best = metric, t + 1, 0
                else:
                    since_best += per
                if since_best >= config.early_stopping_rounds:
                    log.info("early stop at tree %d (best %d, MAP@20 %.6f)",
                             t + 1, best_iter, best_metric)
                    break
    n_keep = best_iter if (val is not None and best_iter > 0) else len(feats_l)
    return GBDTForest(
        feat=np.stack(feats_l[:n_keep]).astype(np.int32),
        thr=np.stack(thrs_l[:n_keep]).astype(np.int32),
        leaf=np.stack(leaves_l[:n_keep]).astype(np.float32),
        base=base,
        depth=depth,
        gain_importance=gain_imp,
        split_importance=split_imp,
        best_iteration=n_keep,
    )


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


def train_gbdt_ranker(
    data: RankerData,
    config: GBDTConfig = GBDTConfig(),
    eval_recall=None,
    mesh=None,
    *,
    device: str | torch.device,
) -> tuple[GBDTRankerModel, np.ndarray]:
    """K-fold GBDT training with the reference's protocol on ``device``
    (:824-880); returns the model and the OOF scores [S, C] (-inf where the
    mask is False).

    The float32 features go to ``device`` once; the edges come from the
    masked rows (:func:`fit_bin_edges_rows`: sorted on the device, value-equal
    to numpy :func:`fit_bin_edges`), the rows are binned there
    (:func:`~otto_tpu_torch.ops.forest.bin_rows`, bit-equal to
    :func:`bin_features`), and each fold
    takes its rows there.  The folds are ``group_kfold`` by
    session size, and each fold's training sessions keep their positives and
    a ``negative_sampling_ratio`` of negatives (``np.random.default_rng(
    config.seed)``, so the folds and keep masks equal the reference's).  One
    :func:`fit_gbdt` a fold, early-stopped on its held-out sessions, which
    it then scores (the OOF scores, through the forest kernel's uint8
    entry).  ``eval_recall(session_indices, scores)`` gives the fold
    recalls and ``oof_recall``.  ``mesh`` raises (ROADMAP M15)."""
    if mesh is not None:
        raise NotImplementedError("train_gbdt_ranker: data-parallel training over a mesh is "
                                  "not ported yet (ROADMAP M15)")
    if data.features.dtype != np.float32:
        raise TypeError(f"train_gbdt_ranker: features must be float32, got "
                        f"{data.features.dtype}")
    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    S, C, F = data.features.shape
    x = torch.as_tensor(np.ascontiguousarray(data.features).reshape(S * C, F), device=dev)
    edges = fit_bin_edges_rows(x, torch.as_tensor(data.mask.reshape(-1), device=dev),
                               config.n_bins)
    binned = bin_rows(x, forest.pack_edges(edges, device=dev)).reshape(S, C, F)
    del x

    def sessions(idx):
        return binned[torch.as_tensor(idx, device=dev)]

    fold_of = group_kfold(data.mask.sum(axis=1), config.n_folds)
    oof = np.zeros((S, C), np.float32)
    forests, fold_recalls = [], []
    for fold in range(config.n_folds):
        val_sessions = np.flatnonzero(fold_of == fold)
        train_sessions = np.flatnonzero(fold_of != fold)
        keep = negative_sample_mask(data.labels[train_sessions], data.mask[train_sessions],
                                    config.negative_sampling_ratio, rng)
        usable = keep.sum(axis=1) > 0
        train_sessions = train_sessions[usable]
        keep = keep[usable]

        vb = sessions(val_sessions)
        fit = fit_gbdt(
            sessions(train_sessions), data.labels[train_sessions], data.mask[train_sessions],
            keep.astype(np.float32), config,
            val=(vb, data.labels[val_sessions], data.mask[val_sessions]),
            seed_offset=fold, device=dev,
        )
        forests.append(fit)
        oof[val_sessions] = fit.predict_binned(vb.reshape(-1, F), device=dev).reshape(
            len(val_sessions), C)
        if eval_recall is not None:
            r = eval_recall(val_sessions,
                            np.where(data.mask[val_sessions], oof[val_sessions], -np.inf))
            fold_recalls.append(float(r))
            log.info("gbdt fold %d: %d trees, recall@20 %.6f", fold, fit.best_iteration, r)

    oof = np.where(data.mask, oof, -np.inf)
    model = GBDTRankerModel(forests, edges, config, list(data.feature_names), fold_recalls)
    if eval_recall is not None:
        model.oof_recall = float(eval_recall(np.arange(S), oof))
        log.info("gbdt OOF recall@20 %.6f", model.oof_recall)
    return model, oof


def load_ranker_model(path) -> GBDTRankerModel:
    """Load a ranker from an npz.  Only the GBDT engine (the ``__gbdt``
    marker) is ported; the listwise tower's npz raises (ROADMAP M12)."""
    with np.load(path, allow_pickle=True) as z:
        is_gbdt = "__gbdt" in z.files
    if not is_gbdt:
        raise NotImplementedError(f"{path}: a listwise-tower ranker; the tower (RankerModel) "
                                  "is not ported yet (ROADMAP M12)")
    return GBDTRankerModel.load(path)
