"""Data-parallel training: GBDT tree growth, the ranking tower and the
sequence models, and ZeRO-1.

Port of ``otto_tpu/parallel/data_parallel.py``.  JAX runs each step as one
``shard_map`` program over the mesh; here every rank of the ``data`` axis runs
the step in its own process on its block of the batch (:func:`data_block`:
the whole batch, the same on every rank, of which it keeps its rows, or the
``DTensor`` that ``BatchLoader(mesh=)`` yields).  The parameters, and for the
plain data-parallel steps the optimizer, are replicated: every rank holds the
same ``Tower`` or parameter tree and the same ``torch.optim`` optimizer over
it.  A rank computes the loss on its block and its gradient, the gradients
and the loss are averaged over ``data`` (a SUM all-reduce, then ``/ dp``: the
JAX steps' ``pmean``; they run under ``check_vma=False``, so nothing sums them
twice), and every rank takes the same optimizer step.

ZeRO-1 (:func:`zero_init`, :func:`make_zero_step`) shards the optimizer
state: each leaf's flat vector is padded to a multiple of dp and each rank
owns one slice of it; the gradient is reduce-scattered to the slices (their
mean), the ``torch.optim`` optimizer updates the rank's slices alone, and an
all-gather rebuilds every leaf.  The wire bytes equal an all-reduce; the
optimizer state a rank holds drops to 1/dp.  Exact for any elementwise
optimizer (SGD, Adam, AdamW, Adagrad): slicing a leaf's flat vector commutes
with a per-element update.  ``torch.distributed.optim.ZeroRedundancyOptimizer``
is not used: it gives whole parameters to ranks, so a catalog-sized
embedding's Adam state would sit whole on one rank.

GBDT growth (:func:`make_dp_gbdt_grow`, and ``fit_gbdt(mesh=)``): each rank
builds its rows' histograms with the kernel K5, whose int64 fixed-point sums
are all-reduced once a level before the finish, at the scale of the whole
fit (:func:`otto_tpu_torch.models.gbdt._grow_tree`): the trees have the bits
of one device's.  An int64 accumulator moves twice the bytes of the
reference's float32 ``psum`` (nodes x features x bins x 3 x 8 a level).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from otto_tpu_torch.models.ranker import COMPUTE_DTYPE, LOSSES
from otto_tpu_torch.parallel.mesh import (
    all_gather_flat,
    all_reduce_mean,
    axis_index,
    axis_size,
    data_block,
    gather_batch,
    mesh_device,
    reduce_scatter_mean,
)
from otto_tpu_torch.utils.runtime import full_f32_matmul


def _leaves(params) -> list[torch.Tensor]:
    """The trained tensors of a ``Tower`` (any ``nn.Module``: its
    parameters) or of a sequence model's parameter tree (``tree_leaves``
    order)."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    from otto_tpu_torch.models.sequence import tree_leaves

    return tree_leaves(params)


def _grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _mean_grads(mesh, leaves: list[torch.Tensor], data_axis: str) -> None:
    """Each leaf's gradient averaged over ``data``, in place (one all-reduce
    a leaf; none at dp 1)."""
    if axis_size(mesh, data_axis) == 1:
        return
    for p in leaves:
        p.grad = all_reduce_mean(mesh, _grad(p).contiguous(), data_axis)


def dropout_generator(seed: int, data_index: int, device) -> torch.Generator:
    """The dropout generator of one rank: seeded by ``(seed, data_index)``,
    the counterpart of ``jax.random.fold_in(key, axis_index)`` (equal to it in
    distribution only)."""
    state = np.random.SeedSequence([int(seed), int(data_index)]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) & ((1 << 63) - 1))


def make_dp_ranker_step(mesh, optimizer: torch.optim.Optimizer, loss_name: str = "lambdarank",
                        dropout: float = 0.0, data_axis: str = "data",
                        compute_dtype: torch.dtype = COMPUTE_DTYPE):
    """The data-parallel tower step (:17-45).  Returns ``step(tower, x, y,
    m, seed=0, lr=None)``: ``tower`` a :class:`~otto_tpu_torch.models.ranker.
    Tower` on the rank's device, the same on every rank, and ``optimizer``
    (:func:`~otto_tpu_torch.models.ranker.make_optimizer`) over its
    parameters; x [B, C, F], y, m [B, C] the batch (:func:`data_block`); with
    ``lr`` the step sets the learning rate first, as ``train_step`` does.
    Each rank's dropout draws from :func:`dropout_generator` ``(seed, its data
    index)``.  Returns the loss averaged over ``data`` (a 0-d tensor); the
    tower and optimizer are updated in place, the same on every rank."""
    loss_fn = LOSSES[loss_name]
    idx = axis_index(mesh, data_axis)

    def step(tower, x, y, m, seed: int = 0, lr: float | None = None) -> torch.Tensor:
        xb, yb, mb = (data_block(mesh, a, data_axis) for a in (x, y, m))
        gen = dropout_generator(seed, idx, xb.device) if dropout > 0.0 else None
        if lr is not None:
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        with full_f32_matmul():
            loss = loss_fn(tower(xb, dropout=dropout, generator=gen,
                                 compute_dtype=compute_dtype), yb, mb)
            loss.backward()
        _mean_grads(mesh, _leaves(tower), data_axis)
        optimizer.step()
        return all_reduce_mean(mesh, loss.detach().clone(), data_axis)

    return step


def make_dp_sequence_step(mesh, optimizer: torch.optim.Optimizer, data_axis: str = "data", *,
                          loss: str = "sampled_softmax", bpr_reg: float = 1.0):
    """The data-parallel sequence-model step (:48-84): the objective of
    :func:`~otto_tpu_torch.models.sequence.sequence_loss` on each rank's
    block of (seq, mask, tgt, negs), every leaf's gradient averaged over
    ``data`` (``item_emb``'s is dense, [n_aids + 1, D]).  Returns ``step(params,
    seq, mask, tgt, negs)`` -> the loss averaged over ``data``; ``params``
    (the parameter tree on the rank's device) and ``optimizer``
    (:func:`~otto_tpu_torch.models.sequence.make_optimizer` over its leaves)
    are updated in place."""
    from otto_tpu_torch.models.sequence import sequence_loss

    def step(params, seq, mask, tgt, negs) -> torch.Tensor:
        blocks = [data_block(mesh, a, data_axis) for a in (seq, mask, tgt, negs)]
        optimizer.zero_grad(set_to_none=True)
        with full_f32_matmul():
            value = sequence_loss(params, *blocks, loss=loss, bpr_reg=bpr_reg)
            value.backward()
        _mean_grads(mesh, _leaves(params), data_axis)
        optimizer.step()
        return all_reduce_mean(mesh, value.detach().clone(), data_axis)

    return step


def make_dp_gbdt_grow(mesh, *, depth: int, n_bins: int, data_axis: str = "data",
                      hist_impl: str = "matmul"):
    """Data-parallel GBDT tree growth (:87-118).  Returns ``grow(binned,
    grad, hess, weight, bag, feat_mask, reg_lambda, min_split_gain,
    min_data_in_leaf, min_child_weight, learning_rate)``: the row inputs are
    the whole [N, ...] (N a multiple of dp; :func:`data_block`) and each rank
    grows on its block, K5's int64 sums all-reduced once a level at the scale
    of all N rows (bytes a level: its keys x features x bins x 3 x 8); every
    rank returns the same split features, thresholds, leaves and gains, and
    the leaf ids of all N rows (gathered over ``data``)."""
    from otto_tpu_torch.models.gbdt import _grow_tree

    def grow(binned, grad, hess, weight, bag, feat_mask, *scalars):
        n = binned.shape[0]
        blocks = [data_block(mesh, a, data_axis) for a in (binned, grad, hess, weight, bag)]
        fm = torch.as_tensor(np.asarray(feat_mask) if not torch.is_tensor(feat_mask)
                             else feat_mask, device=mesh_device(mesh))
        feat, thr, leaf, gains, ids = _grow_tree(*blocks, fm, *scalars, depth=depth,
                                                 n_bins=n_bins, hist_impl=hist_impl,
                                                 mesh=mesh, data_axis=data_axis, n_rows=n)
        return feat, thr, leaf, gains, gather_batch(mesh, ids, n, data_axis)

    return grow


# --------------------------------------------------------------------------
# ZeRO-1: optimizer-state sharding over the data axis
# --------------------------------------------------------------------------


def _flat_padded(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t``'s flat vector zero-padded to a multiple of ``dp`` (:132-140)."""
    flat = t.reshape(-1)
    pad = (-flat.numel()) % dp
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


@dataclass
class ZeroState:
    """A rank's ZeRO-1 state: its slice of each leaf's padded flat vector
    (``shards``, in :func:`_leaves` order) and the optimizer over them."""

    shards: list[torch.Tensor]
    optimizer: torch.optim.Optimizer


def zero_init(mesh, optimizer, params, data_axis: str = "data") -> ZeroState:
    """The ZeRO-1 state of ``params`` (a ``Tower`` or a parameter tree on
    the rank's device, the same on every rank) (:161-176).  ``optimizer``
    makes the optimizer from a list of tensors (for instance
    ``functools.partial(torch.optim.Adam, lr=1e-3)``); it gets this rank's
    slices, so its state is 1/dp of the replicated optimizer's (plus, per
    leaf, its scalars and at most one padding entry per state tensor)."""
    dp, idx = axis_size(mesh, data_axis), axis_index(mesh, data_axis)
    shards = []
    for p in _leaves(params):
        flat = _flat_padded(p.detach(), dp)
        per = flat.numel() // dp
        shards.append(nn.Parameter(flat[idx * per:(idx + 1) * per].clone()))
    return ZeroState(shards, optimizer(shards))


def make_zero_step(mesh, loss_fn, n_batch_args: int, data_axis: str = "data"):
    """ZeRO-1 data-parallel step for any ``loss_fn(params, *batch)`` -> a
    0-d tensor, with ``n_batch_args`` batch arrays (:func:`data_block`)
    (:179-210).  Returns ``step(params, state, *batch)`` -> the loss averaged
    over ``data``: the gradient of the rank's block, each leaf's
    reduce-scattered to the rank's slice as the mean over ``data``, the
    optimizer of ``state`` (:func:`zero_init`) on the slices, then each leaf
    rebuilt in place by an all-gather.  The optimizer lives in ``state``, not
    in this call as in the reference's signature."""

    def step(params, state: ZeroState, *batch) -> torch.Tensor:
        if len(batch) != n_batch_args:
            raise TypeError(f"zero step: {n_batch_args} batch arrays expected, got {len(batch)}")
        dp = axis_size(mesh, data_axis)
        leaves = _leaves(params)
        blocks = [data_block(mesh, a, data_axis) for a in batch]
        for p in leaves:
            p.grad = None
        with full_f32_matmul():
            value = loss_fn(params, *blocks)
            value.backward()
        for p, shard in zip(leaves, state.shards):
            shard.grad = reduce_scatter_mean(mesh, _flat_padded(_grad(p), dp), data_axis)
            p.grad = None
        state.optimizer.step()
        with torch.no_grad():
            for p, shard in zip(leaves, state.shards):
                p.copy_(all_gather_flat(mesh, shard.detach(), data_axis)[:p.numel()]
                        .view_as(p))
        return all_reduce_mean(mesh, value.detach().clone(), data_axis)

    return step


def make_zero_sequence_step(mesh, data_axis: str = "data", *, loss: str = "sampled_softmax",
                            bpr_reg: float = 1.0):
    """The ZeRO-1 twin of :func:`make_dp_sequence_step` (:213-232), the same
    objective with the optimizer state sharded dp-ways: ``step(params, state,
    seq, mask, tgt, negs)`` with ``state`` from :func:`zero_init`."""
    from otto_tpu_torch.models.sequence import sequence_loss

    def loss_fn(params, seq, mask, tgt, negs):
        return sequence_loss(params, seq, mask, tgt, negs, loss=loss, bpr_reg=bpr_reg)

    return make_zero_step(mesh, loss_fn, 4, data_axis)


def optimizer_state_numel(optimizer: torch.optim.Optimizer) -> int:
    """The entries of an optimizer's state tensors (Adam: both moments and
    each parameter's step count)."""
    return sum(v.numel() for st in optimizer.state.values() for v in st.values()
               if torch.is_tensor(v))
