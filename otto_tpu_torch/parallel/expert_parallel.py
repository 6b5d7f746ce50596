"""Expert parallelism: the pooled-session mixture-of-experts recommender
with its experts split one block a rank of the ``model`` axis.

Port of ``otto_tpu/parallel/expert_parallel.py``.  The MoE core (gating,
dispatch, combine, and its one ``psum`` across the axis) is
``otto_tpu_torch/ops/moe.py``, shared with the transformer's
``moe_experts`` FFN; this module adds the recommender (mean-pooled item
embeddings, a residual MoE FFN, the sampled softmax against the tied item
table) and its training step, with the frame of
``parallel/model_parallel.py``: the loss counted on model-shard 0, each
replicated leaf's gradient summed over ``model`` (the gate ``wg``'s on a
rank is its own experts' share) and every leaf's averaged over ``data``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from otto_tpu_torch.models.sequence import _tree_map, sampled_softmax
from otto_tpu_torch.ops.moe import init_moe, moe_apply, moe_param_specs
from otto_tpu_torch.parallel.mesh import data_block, replicated
from otto_tpu_torch.parallel.model_parallel import _on_shard0, _run_step
from otto_tpu_torch.utils.runtime import resolve_device


def init_moe_recommender(generator: torch.Generator, n_aids: int, dim: int, hidden: int,
                         n_experts: int) -> dict:
    """The reference's tree (float32 on the CPU, drawn from ``generator``):
    ``item_emb`` [n_aids + 1, dim] (normals times 0.05; a PAD row) and the
    ``moe`` FFN of :func:`~otto_tpu_torch.ops.moe.init_moe`."""
    return {"item_emb": torch.randn(n_aids + 1, dim, generator=generator) * 0.05,
            "moe": init_moe(generator, dim, hidden, n_experts)}


def moe_recommender_from_numpy(params: dict, *, device) -> dict:
    """The JAX package's ``init_moe_recommender`` tree (any arrays numpy
    reads) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    return _tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev),
                     {"item_emb": params["item_emb"], "moe": dict(params["moe"])})


def moe_recommender_specs(mesh, model_axis: str = "model") -> dict:
    """Layouts: the item table replicated, the experts split over
    ``model_axis`` (:func:`~otto_tpu_torch.ops.moe.moe_param_specs`)."""
    return {"item_emb": replicated(mesh), "moe": moe_param_specs(mesh, model_axis)}


def moe_recommender_loss(params, seq, mask, tgt, negs, *, capacity: int,
                         model_axis: str | None = None, mesh=None) -> torch.Tensor:
    """The recommender's objective on a batch: ``mask`` float [B, L] (1 on
    real events), the session the mean of its events' embeddings, plus the
    MoE FFN of it (its experts split over ``model_axis`` of ``mesh`` when
    given), scored by the sampled softmax.  Without ``model_axis`` it is the
    single-device objective."""
    emb = F.embedding(seq, params["item_emb"]) * mask[:, :, None]  # [B, L, D]
    denom = mask.sum(dim=1, keepdim=True).clamp(min=1)
    pooled = emb.sum(dim=1) / denom  # [B, D]
    h = pooled + moe_apply(params["moe"], pooled, capacity=capacity, model_axis=model_axis,
                           mesh=mesh)
    return sampled_softmax(h, params["item_emb"], tgt, negs)


def make_ep_moe_step(mesh, optimizer: torch.optim.Optimizer, *, capacity: int,
                     data_axis: str = "data", model_axis: str = "model"):
    """The expert-parallel training step of the pooled-session MoE
    recommender: the batch split over ``data``, the experts over ``model``.
    Returns ``step(params, seq, mask, tgt, negs)`` -> the loss averaged over
    ``data``; ``params`` the rank's blocks (``model_parallel.shard_params``
    with :func:`moe_recommender_specs`) and ``optimizer`` over them, updated
    in place; the batch the whole batch on every rank, ``mask`` float."""
    def step(params, seq, mask, tgt, negs) -> torch.Tensor:
        s, m, t, n = (data_block(mesh, a, data_axis) for a in (seq, mask, tgt, negs))

        def loss():
            value = moe_recommender_loss(params, s, m, t, n, capacity=capacity,
                                         model_axis=model_axis, mesh=mesh)
            return _on_shard0(value, mesh, model_axis)

        return _run_step(mesh, optimizer, params, moe_recommender_specs(mesh, model_axis),
                         loss, data_axis)

    return step
