"""Tensor-, sequence- and pipeline-parallel training of the session
transformer (``models/sequence.py``), and the three composed.

Port of ``otto_tpu/parallel/model_parallel.py``.  As in the rest of
``otto_tpu_torch.parallel``, one process runs a rank: every rank takes the
same host batch and keeps its ``data`` block (:func:`~otto_tpu_torch.
parallel.mesh.data_block`), holds its block of each parameter
(:func:`shard_params`, under the layouts of :func:`tp_param_specs`,
:func:`pp_param_specs` and :func:`pp_tp_param_specs`), runs the program
JAX runs under ``shard_map`` on them, and updates its blocks in place with
a ``torch.optim`` optimizer over them.  The step returns the loss averaged
over ``data``; :func:`gather_params` joins the blocks again.

- **Tensor parallelism** (:func:`make_tp_sequence_step`): attention heads
  and the FFN hidden dim split over ``model`` (``wq``/``wk``/``wv`` on the
  head dim, ``wo`` on its head-major rows, ``ffn_w1``/``ffn_b1`` on the
  hidden columns, ``ffn_w2`` on the hidden rows; an MoE layer's experts
  split over it: expert parallelism); one ``psum`` after the attention's
  output product and one after the FFN a layer.
- **Sequence parallelism** (``sequence_parallel=True``): the LayerNorm and
  residual regions keep the activations split on the sequence dim; each
  ``psum`` becomes an ``all_gather`` before the sharded products and a
  ``psum_scatter`` after them.
- **Pipeline parallelism** (:func:`make_pp_sequence_step`): GPipe, the
  layers in one stage a rank of the pipeline axis; ``n_micro + S - 1``
  ticks, one ``ppermute`` hop a tick.  Every stage evaluates the embedding
  and the loss head each tick and masks what it does not use, so every
  rank issues the same collectives in the same order, forward and
  backward.
- **3-D** (:func:`make_pp_tp_sequence_step`): ``data x pipe x model``.

Gradients have the reference's semantics (``shard_map`` with
``check_vma=False`` differentiated from outside): the loss is counted on
model-shard 0 only (:func:`_on_shard0`), the collectives' backwards are
their transposes (``parallel/collectives.py``: a ``psum``'s is a
``psum``), and after the backward each leaf's gradient is summed over every
mesh axis but ``data`` on which its layout replicates it (the transpose of
a replicated ``shard_map`` input) and averaged over ``data``.  So the MoE
gate, whose gradient on a rank is its own experts' share, the item table,
which the pipeline's first stage uses for the embedding and its last for
the tied head, and the LayerNorms between the sharded products under
sequence parallelism, all get the single-device gradient.  ``remat=True``
wraps each block in ``torch.utils.checkpoint.checkpoint(use_reentrant=
False)``; the block's collectives run again in the recompute, on every rank
alike.  Products run in float32 (``full_f32_matmul``: TF32 off), as every
sequence step of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard
from torch.utils.checkpoint import checkpoint

from otto_tpu_torch.models.sequence import (
    _last_state,
    _layer_norm,
    _moe_ffn,
    _positions,
    _tree_map,
    sampled_softmax,
    transformer_block,
    tree_leaves,
)
from otto_tpu_torch.parallel import collectives as coll
from otto_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    data_block,
    gather_block,
    replicated,
    sharded,
    take_block,
)
from otto_tpu_torch.utils.runtime import full_f32_matmul


def _on_shard0(loss: torch.Tensor, mesh, model_axis: str) -> torch.Tensor:
    """The loss on model-shard 0 and zero on the others, so that summing the
    shards' outputs, and the replicated leaves' gradients over the axis,
    counts each contribution once."""
    return loss * (1.0 if axis_index(mesh, model_axis) == 0 else 0.0)


# --------------------------------------------------------------------------
# layouts and blocks
# --------------------------------------------------------------------------


def _map_with(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``'s leaves (dicts and lists of tensors
    or arrays) and the layouts at the same places in ``specs``."""
    if isinstance(tree, dict):
        return {k: _map_with(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def _spec_leaves(tree, specs) -> list:
    """``specs``' layouts in :func:`tree_leaves` order of ``tree``."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k], specs[k])]
    if isinstance(tree, list):
        return [s for v, sp in zip(tree, specs) for s in _spec_leaves(v, sp)]
    return [specs]


def _ln_spec(mesh) -> dict:
    return {"scale": replicated(mesh), "bias": replicated(mesh)}


def _tp_layer_spec(mesh, layer, model_axis: str) -> dict:
    """Megatron-style layouts of one layer: ``wq``/``wk``/``wv`` split on the
    head dim, ``wo`` on its head-major rows, ``ffn_w1``/``ffn_b1`` on the
    hidden columns, ``ffn_w2`` on the hidden rows; an MoE layer's experts
    over the axis (expert parallelism)."""
    heads, rows = sharded(mesh, {model_axis: 1}), sharded(mesh, {model_axis: 0})
    spec = {"wq": heads, "wk": heads, "wv": heads, "wo": rows,
            "ln1": _ln_spec(mesh), "ln2": _ln_spec(mesh)}
    if "moe" in layer:
        from otto_tpu_torch.ops.moe import moe_param_specs

        spec["moe"] = moe_param_specs(mesh, model_axis)
    else:
        spec.update(ffn_w1=sharded(mesh, {model_axis: 1}), ffn_b1=rows, ffn_w2=rows,
                    ffn_b2=replicated(mesh))
    return spec


def tp_param_specs(mesh, params, model_axis: str = "model") -> dict:
    """The layouts of ``init_params``' transformer tree under tensor
    parallelism (:func:`_tp_layer_spec`); the embeddings, the head and the
    final norm replicated."""
    return {"item_emb": replicated(mesh), "pos_emb": replicated(mesh),
            "out_proj": replicated(mesh), "final_ln": _ln_spec(mesh),
            "layers": [_tp_layer_spec(mesh, layer, model_axis) for layer in params["layers"]]}


def shard_params(mesh, params, specs):
    """This rank's block of each leaf of ``params`` (the whole tree: tensors,
    or the numpy arrays the JAX package's parameters read as) under
    ``specs``, as new float32 tensors on the rank's device that require
    grad, ready for the steps."""
    def block(a, spec):
        t = a.detach() if torch.is_tensor(a) else torch.from_numpy(np.asarray(a, np.float32))
        return take_block(mesh, t, spec).requires_grad_(True)

    return _map_with(block, params, specs)


def gather_params(mesh, params, specs):
    """The whole tree from every rank's blocks (detached), on every rank of
    the mesh: each rank calls it."""
    return _map_with(lambda t, spec: gather_block(mesh, t, spec), params, specs)


def with_layout(mesh, params, specs):
    """Each block as a ``DTensor`` carrying its mesh and layout (the blocks'
    storage, detached): what :class:`~otto_tpu_torch.utils.checkpoint.
    CheckpointManager` saves whole and restores a rank's block of."""
    from torch.distributed.tensor import DTensor

    return _map_with(lambda t, spec: DTensor.from_local(t.detach(), mesh, spec,
                                                        run_check=False), params, specs)


# --------------------------------------------------------------------------
# the step's frame: gradients and the loss over the mesh
# --------------------------------------------------------------------------


def _reduce_grads(mesh, params, specs, data_axis: str) -> None:
    """Each leaf's gradient summed over every non-``data`` axis on which its
    layout replicates it, then averaged over ``data``, in place."""
    names = mesh.mesh_dim_names
    dp = axis_size(mesh, data_axis)
    for p, spec in zip(tree_leaves(params), _spec_leaves(params, specs)):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        axes = [n for n, pl in zip(names, spec)
                if n != data_axis and not isinstance(pl, Shard) and axis_size(mesh, n) > 1]
        if dp > 1:
            axes.append(data_axis)
        for ax in axes:
            g = coll._all_reduce(mesh, g, ax)
        p.grad = g.div_(dp) if dp > 1 else g


def _mesh_loss(mesh, loss: torch.Tensor, data_axis: str) -> torch.Tensor:
    """The shards' (masked) losses summed over the non-``data`` axes and
    averaged over ``data``: the reference's ``sum(out) / dp``."""
    value = loss.detach().clone()
    for ax in mesh.mesh_dim_names:
        if axis_size(mesh, ax) > 1:
            value = coll._all_reduce(mesh, value, ax)
    dp = axis_size(mesh, data_axis)
    return value / dp if dp > 1 else value


def _run_step(mesh, optimizer, params, specs, loss_fn, data_axis: str) -> torch.Tensor:
    optimizer.zero_grad(set_to_none=True)
    with full_f32_matmul():
        loss = loss_fn()
        loss.backward()
    _reduce_grads(mesh, params, specs, data_axis)
    optimizer.step()
    return _mesh_loss(mesh, loss, data_axis)


# --------------------------------------------------------------------------
# tensor parallelism (+ optional sequence parallelism)
# --------------------------------------------------------------------------


def _tp_block(layer, x, attn_ok, mesh, model_axis: str, sp: bool):
    """A transformer block on the rank's heads and FFN hidden block (or
    experts).  Without sequence parallelism ``x`` is the whole [B, L, D]
    activation and each sharded product ends in a ``psum``; with it ``x``
    is the rank's [B, L/mp, D] slice and the pair becomes ``all_gather`` +
    ``psum_scatter``."""
    hd = layer["wq"].shape[-1]
    h = _layer_norm(layer["ln1"], x)
    if sp:
        h = coll.all_gather(mesh, h, model_axis, 1)
    B, L, _ = h.shape
    q = torch.einsum("bld,dhk->blhk", h, layer["wq"])  # the rank's heads only
    k = torch.einsum("bld,dhk->blhk", h, layer["wk"])
    v = torch.einsum("bld,dhk->blhk", h, layer["wv"])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    logits = torch.where(attn_ok[:, None], logits, -1e9)
    att = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, -1)
    # wo's rows are head-major: the rank's rows line up with its heads
    x = x + _combined(mesh, out @ layer["wo"], model_axis, sp)
    h = _layer_norm(layer["ln2"], x)
    if sp:
        h = coll.all_gather(mesh, h, model_axis, 1)
    if "moe" in layer:
        # the experts split over the axis; moe_apply's psum combines them
        # (replicated: under sp the rank takes its slice)
        red = _moe_ffn(layer["moe"], h, attn_ok, model_axis=model_axis, mesh=mesh)
        return x + (_seq_slice(mesh, red, model_axis) if sp else red)
    part = F.gelu(h @ layer["ffn_w1"] + layer["ffn_b1"], approximate="tanh") @ layer["ffn_w2"]
    return x + _combined(mesh, part, model_axis, sp) + layer["ffn_b2"]


def _combined(mesh, part, model_axis: str, sp: bool):
    """A sharded product's partial sums combined over the axis: summed
    (``psum``), or under sequence parallelism summed and split on the
    sequence dim (``psum_scatter``)."""
    if sp:
        return coll.psum_scatter(mesh, part, model_axis, 1)
    return coll.psum(mesh, part, model_axis)


def _seq_slice(mesh, x, model_axis: str):
    """The rank's slice of the sequence dim (sequence parallelism)."""
    mp, m = axis_size(mesh, model_axis), axis_index(mesh, model_axis)
    L = x.shape[1]
    if L % mp:
        raise ValueError(f"sequence_parallel needs L ({L}) % mp ({mp}) == 0")
    return x[:, m * (L // mp):(m + 1) * (L // mp)]


def tp_encode(params, seq, mask, *, mesh, model_axis: str = "model",
              sequence_parallel: bool = False, remat: bool = False):
    """The tensor-parallel twin of ``models.sequence.encode`` (transformer)
    on the rank's blocks (:func:`tp_param_specs`) and its ``data`` block of
    the batch; returns the [B, dim] session vectors, the same on every rank
    of ``model_axis``.  ``remat=True`` recomputes each block's activations
    in the backward (their collectives too)."""
    mp = axis_size(mesh, model_axis)
    sp = sequence_parallel and mp > 1
    x, attn_ok = _positions(params, seq, mask)
    if sp:
        x = _seq_slice(mesh, x, model_axis)
    for layer in params["layers"]:
        if remat:
            x = checkpoint(_tp_block, layer, x, attn_ok, mesh, model_axis, sp,
                           use_reentrant=False)
        else:
            x = _tp_block(layer, x, attn_ok, mesh, model_axis, sp)
    if sp:
        x = coll.all_gather(mesh, x, model_axis, 1)
    return _last_state(params, x, mask)


def make_tp_sequence_step(mesh, optimizer: torch.optim.Optimizer, *,
                          sequence_parallel: bool = False, remat: bool = False,
                          data_axis: str = "data", model_axis: str = "model"):
    """The tensor(+sequence)-parallel training step of the transformer
    recommender.  Returns ``step(params, seq, mask, tgt, negs)`` -> the
    loss averaged over ``data``: ``params`` the rank's blocks
    (:func:`shard_params` with :func:`tp_param_specs`) and ``optimizer`` over
    them, both updated in place; the batch the whole batch on every rank
    (numpy or tensors; its rows divide by dp)."""
    def step(params, seq, mask, tgt, negs) -> torch.Tensor:
        s, m, t, n = (data_block(mesh, a, data_axis) for a in (seq, mask, tgt, negs))
        specs = tp_param_specs(mesh, params, model_axis)

        def loss():
            h = tp_encode(params, s, m, mesh=mesh, model_axis=model_axis,
                          sequence_parallel=sequence_parallel, remat=remat)
            return _on_shard0(sampled_softmax(h, params["item_emb"], t, n), mesh, model_axis)

        return _run_step(mesh, optimizer, params, specs, loss, data_axis)

    return step


# --------------------------------------------------------------------------
# pipeline parallelism
# --------------------------------------------------------------------------


def stack_pipeline_params(params, n_stages: int) -> dict:
    """The layer list re-laid for the pipeline: a ``stage_layers`` tree with
    the layer's structure whose leaves are [n_stages, layers_per_stage,
    ...] (the leading dim split over the pipeline axis); the shared leaves
    as they are.  Tensors or numpy arrays (numpy in, numpy out)."""
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers not divisible into {n_stages} stages")
    per = len(layers) // n_stages

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        if torch.is_tensor(xs[0]):
            return torch.stack(xs).reshape(n_stages, per, *xs[0].shape)
        return np.stack([np.asarray(x) for x in xs]).reshape(n_stages, per, *np.shape(xs[0]))

    out = {k: v for k, v in params.items() if k != "layers"}
    out["stage_layers"] = stack(*layers)
    return out


def unstack_pipeline_params(params) -> dict:
    """The inverse of :func:`stack_pipeline_params` on a whole tree: the
    per-layer list again (views of the stacked leaves)."""
    stages = params["stage_layers"]
    lead = tree_leaves(stages)[0].shape
    n = lead[0] * lead[1]
    out = {k: v for k, v in params.items() if k != "stage_layers"}
    out["layers"] = [_tree_map(lambda a, i=i: a.reshape(n, *a.shape[2:])[i], stages)
                     for i in range(n)]
    return out


def pp_param_specs(mesh, params, model_axis: str = "model") -> dict:
    """The layouts of :func:`stack_pipeline_params`' tree: the stages split
    over ``model_axis`` (the pipeline), the rest replicated."""
    stages = sharded(mesh, {model_axis: 0})
    return {"item_emb": replicated(mesh), "pos_emb": replicated(mesh),
            "out_proj": replicated(mesh), "final_ln": _ln_spec(mesh),
            "stage_layers": _tree_map(lambda _: stages, params["stage_layers"])}


def _stage_layers(params, S: int, pipe_axis: str) -> list:
    """This rank's layers: the one stage of its block of ``stage_layers``."""
    lead = tree_leaves(params["stage_layers"])[0].shape
    if lead[0] != 1:
        raise ValueError(f"stage_layers holds {lead[0]} stages a rank but the mesh's "
                         f"{pipe_axis!r} axis has {S} devices: call "
                         f"stack_pipeline_params(params, {S}) and shard_params")
    return [_tree_map(lambda a, j=j: a[0, j], params["stage_layers"]) for j in range(lead[1])]


def _pipeline_loss(params, seq, mask, tgt, negs, *, mesh, pipe_axis: str, n_micro: int,
                   remat: bool, model_axis: str | None = None, sp: bool = False):
    """The GPipe schedule on the rank's stage: ``n_micro + S - 1`` ticks; at
    tick t stage s works on microbatch t - s (clipped, its result masked
    where out of range), takes the embedding on stage 0 and the previous
    stage's activation elsewhere, evaluates the loss head and counts it on
    the last stage only, and hands its activation on by one ``ppermute``.
    With ``model_axis`` the blocks are tensor-parallel (and ``sp`` sequence-
    parallel) and the loss counts on model-shard 0 only."""
    S, stage = axis_size(mesh, pipe_axis), axis_index(mesh, pipe_axis)
    layers = _stage_layers(params, S, pipe_axis)
    b_loc, L = seq.shape
    if b_loc % n_micro:
        raise ValueError(f"local batch {b_loc} not divisible by n_micro={n_micro}")
    mbs = b_loc // n_micro
    seqs, masks = seq.reshape(n_micro, mbs, L), mask.reshape(n_micro, mbs, L)
    tgts, negss = tgt.reshape(n_micro, mbs), negs.reshape(n_micro, mbs, -1)
    dev = seq.device
    first = torch.tensor(stage == 0, device=dev)

    def block(layer, h, attn_ok):
        if model_axis is None:
            return transformer_block(layer, h, attn_ok)
        return _tp_block(layer, h, attn_ok, mesh, model_axis, sp)

    D = params["pos_emb"].shape[1]
    l_loc = L // axis_size(mesh, model_axis) if sp else L
    buf = torch.zeros((mbs, l_loc, D), dtype=params["pos_emb"].dtype, device=dev)
    loss_acc = torch.zeros((), dtype=params["pos_emb"].dtype, device=dev)
    ticks = n_micro + S - 1
    for t in range(ticks):
        m_idx = t - stage
        m_c = min(max(m_idx, 0), n_micro - 1)
        k_m = masks[m_c]
        x, attn_ok = _positions(params, seqs[m_c], k_m)
        if sp:
            x = _seq_slice(mesh, x, model_axis)
        h = torch.where(first, x, buf)
        for layer in layers:
            h = (checkpoint(block, layer, h, attn_ok, use_reentrant=False) if remat
                 else block(layer, h, attn_ok))
        hx = coll.all_gather(mesh, h, model_axis, 1) if sp else h
        mb_loss = sampled_softmax(_last_state(params, hx, k_m), params["item_emb"], tgts[m_c],
                                  negss[m_c])
        use = torch.tensor(stage == S - 1 and 0 <= m_idx < n_micro, device=dev)
        loss_acc = loss_acc + torch.where(use, mb_loss, 0.0)
        if t < ticks - 1:  # the last tick's hop feeds nothing
            buf = coll.ppermute(mesh, h, pipe_axis)
    loss = loss_acc / n_micro
    return _on_shard0(loss, mesh, model_axis) if model_axis is not None else loss


def make_pp_sequence_step(mesh, optimizer: torch.optim.Optimizer, *, n_micro: int,
                          remat: bool = False, data_axis: str = "data",
                          model_axis: str = "model"):
    """The GPipe pipeline-parallel training step: ``model_axis`` is the
    pipeline, a rank owns ``n_layers / S`` layers; its ``data`` block splits
    into ``n_micro`` microbatches streamed through the stages.  Returns
    ``step(params, seq, mask, tgt, negs)`` -> the loss averaged over
    ``data``, ``params`` the rank's blocks of :func:`stack_pipeline_params`'
    tree (:func:`pp_param_specs`), updated in place with ``optimizer``.
    An MoE layer routes each microbatch apart (capacity a group)."""
    def step(params, seq, mask, tgt, negs) -> torch.Tensor:
        s, m, t, n = (data_block(mesh, a, data_axis) for a in (seq, mask, tgt, negs))
        specs = pp_param_specs(mesh, params, model_axis)
        return _run_step(mesh, optimizer, params, specs,
                         lambda: _pipeline_loss(params, s, m, t, n, mesh=mesh,
                                                pipe_axis=model_axis, n_micro=n_micro,
                                                remat=remat),
                         data_axis)

    return step


# --------------------------------------------------------------------------
# 3-D parallelism: data x pipeline x tensor in one step
# --------------------------------------------------------------------------


def pp_tp_param_specs(mesh, params, pipe_axis: str = "pipe",
                      model_axis: str = "model") -> dict:
    """The layouts of :func:`stack_pipeline_params`' tree under pipeline +
    tensor parallelism: the stage dim split over ``pipe_axis`` and, within a
    stage, each layer leaf split over ``model_axis`` as
    :func:`_tp_layer_spec` splits it (two leading dims: stage, layer in the
    stage); the embeddings and the head replicated."""
    def stacked(spec):
        return [Shard(0) if name == pipe_axis else
                (Shard(pl.dim + 2) if isinstance(pl, Shard) else pl)
                for name, pl in zip(mesh.mesh_dim_names, spec)]

    layer = _tp_layer_spec(mesh, params["stage_layers"], model_axis)
    return {"item_emb": replicated(mesh), "pos_emb": replicated(mesh),
            "out_proj": replicated(mesh), "final_ln": _ln_spec(mesh),
            "stage_layers": _map_with(lambda _, s: stacked(s), params["stage_layers"], layer)}


def make_pp_tp_sequence_step(mesh, optimizer: torch.optim.Optimizer, *, n_micro: int,
                             sequence_parallel: bool = False, remat: bool = False,
                             data_axis: str = "data", pipe_axis: str = "pipe",
                             model_axis: str = "model"):
    """The 3-D training step on a ``data x pipe x model`` mesh
    (``mesh.make_mesh3d``): batches split over ``data``, stages pipeline
    over ``pipe`` (the GPipe schedule), and within a stage heads and FFN
    hidden blocks split over ``model`` (optionally sequence-parallel).
    Returns ``step(params, seq, mask, tgt, negs)`` -> the loss averaged over
    ``data``, ``params`` the rank's blocks under :func:`pp_tp_param_specs`,
    updated in place with ``optimizer``."""
    sp = sequence_parallel and axis_size(mesh, model_axis) > 1

    def step(params, seq, mask, tgt, negs) -> torch.Tensor:
        s, m, t, n = (data_block(mesh, a, data_axis) for a in (seq, mask, tgt, negs))
        specs = pp_tp_param_specs(mesh, params, pipe_axis, model_axis)
        return _run_step(mesh, optimizer, params, specs,
                         lambda: _pipeline_loss(params, s, m, t, n, mesh=mesh,
                                                pipe_axis=pipe_axis, n_micro=n_micro,
                                                remat=remat, model_axis=model_axis, sp=sp),
                         data_axis)

    return step
