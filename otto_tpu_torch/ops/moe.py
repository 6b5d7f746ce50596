"""Mixture-of-experts FFN core: top-1 gating, fixed per-expert capacity,
gather/scatter dispatch and combine.

Port of ``otto_tpu/ops/moe.py``, used two ways:

- single-device (``model_axis=None``): every expert is local, as the
  transformer uses it when ``SequenceModelConfig.moe_experts > 0``;
- expert-parallel (``model_axis="model"`` and ``mesh=``): each rank of the
  axis holds the contiguous block of ``E/mp`` experts (:func:`moe_param_specs`),
  the tokens are replicated over the axis, the gate softmax runs over all
  ``E`` experts with the replicated ``wg``, local expert ``e`` is global
  expert ``m * E/mp + e``, and one ``psum`` combines the ranks' outputs
  (``otto_tpu_torch/parallel/expert_parallel.py``).

Over-capacity tokens pass through with zero expert contribution (the
standard capacity-factor drop); masked (padding) tokens never win a
capacity slot.  Each expert takes its assigned tokens by gate score,
highest first and the lower token index first among equal scores, as
``jax.lax.top_k`` orders them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def init_moe(generator: torch.Generator, dim: int, hidden: int, n_experts: int) -> dict:
    """The reference's shapes and scales, float32 on the CPU, drawn from
    ``generator``: gate ``wg`` [D, E], expert ``w1`` [E, D, H] and ``w2``
    [E, H, D] (standard normals times 1/sqrt(fan_in)), zero ``b1`` [E, H]
    and ``b2`` [D]."""
    s = (1.0 / dim) ** 0.5
    return {
        "wg": torch.randn(dim, n_experts, generator=generator) * s,
        "w1": torch.randn(n_experts, dim, hidden, generator=generator) * s,
        "b1": torch.zeros(n_experts, hidden),
        "w2": torch.randn(n_experts, hidden, dim, generator=generator) * (1.0 / hidden) ** 0.5,
        "b2": torch.zeros(dim),
    }


def moe_param_specs(mesh, model_axis: str = "model") -> dict:
    """The layout of :func:`init_moe`'s tree under expert parallelism: the
    experts of ``w1``, ``b1``, ``w2`` split over ``model_axis``, the gate and
    the output bias replicated (``mesh.sharded`` placements)."""
    from otto_tpu_torch.parallel.mesh import replicated, sharded

    experts = sharded(mesh, {model_axis: 0})
    return {"wg": replicated(mesh), "w1": experts, "b1": experts, "w2": experts,
            "b2": replicated(mesh)}


def moe_apply(p: dict, x: torch.Tensor, *, capacity: int, model_axis: str | None = None,
              token_mask: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
    """MoE FFN over tokens ``x`` [T, D]; ``token_mask`` [T] bool marks real
    tokens.

    With ``model_axis`` set, ``mesh`` is the rank's mesh, ``p``'s experts
    are this rank's block of them (:func:`moe_param_specs`) and ``x`` is the
    same on every rank of the axis; the result, summed over the axis, is
    the whole.  Without a mesh that raises: never a quiet single-device run.

    Each local expert takes its top-``capacity`` assigned tokens by gate
    probability (a stable descending sort: ties to the lower token index),
    applies its FFN (tanh-form GELU, as ``jax.nn.gelu``) and scatters back
    weighted by the gate probability; empty slots carry weight 0 and add
    nothing."""
    T, _ = x.shape
    capacity = min(capacity, T)
    e_loc = p["w1"].shape[0]
    m = 0
    if model_axis is not None:
        if mesh is None:
            raise ValueError(f"moe_apply: model_axis={model_axis!r} needs the rank's mesh "
                             "(mesh=); pass model_axis=None for every expert on one device")
        from otto_tpu_torch.parallel.mesh import axis_index, axis_size

        if e_loc * axis_size(mesh, model_axis) != p["wg"].shape[1]:
            raise ValueError(f"moe_apply: {e_loc} local experts times the {model_axis!r} "
                             f"axis size is not the gate's {p['wg'].shape[1]} experts")
        m = axis_index(mesh, model_axis)
    gate = torch.softmax(x @ p["wg"], dim=1)  # [T, E] (the global expert count)
    top_p, assign = gate.max(dim=1)  # the first maximum, as jnp.argmax
    if token_mask is not None:
        top_p = torch.where(token_mask, top_p, 0.0)
    out = torch.zeros_like(x)
    for e in range(e_loc):
        score = torch.where((assign == m * e_loc + e) & (top_p > 0), top_p, -1.0)
        val, idx = torch.sort(score, descending=True, stable=True)
        val, idx = val[:capacity], idx[:capacity]  # this expert's tokens
        w = torch.where(val > 0, val, 0.0)  # gate weight; 0 for empty slots
        he = F.gelu(x[idx] @ p["w1"][e] + p["b1"][e], approximate="tanh") @ p["w2"][e]
        out = out.index_add(0, idx, he * w[:, None])  # combine
    if model_axis is not None:
        from otto_tpu_torch.parallel.collectives import psum

        out = psum(mesh, out, model_axis)
    return out + p["b2"]
