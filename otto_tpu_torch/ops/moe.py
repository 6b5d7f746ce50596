"""Mixture-of-experts FFN core: top-1 gating, fixed per-expert capacity,
gather/scatter dispatch and combine.

Port of ``otto_tpu/ops/moe.py`` in its single-device form
(``model_axis=None``): every expert is local, as the transformer uses it
when ``SequenceModelConfig.moe_experts > 0``.  Expert parallelism (the
expert dimension sharded over a mesh axis, one ``psum``) is not ported
(ROADMAP M15c).

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


def moe_apply(p: dict, x: torch.Tensor, *, capacity: int, model_axis: str | None = None,
              token_mask: torch.Tensor | None = None) -> torch.Tensor:
    """MoE FFN over tokens ``x`` [T, D] (the counterpart of ``moe_apply``
    with ``model_axis=None``); ``token_mask`` [T] bool marks real tokens.

    Each expert takes its top-``capacity`` assigned tokens by gate
    probability (a stable descending sort: ties to the lower token index),
    applies its FFN (tanh-form GELU, as ``jax.nn.gelu``) and scatters back
    weighted by the gate probability; empty slots carry weight 0 and add
    nothing."""
    if model_axis is not None:
        raise NotImplementedError("moe_apply: expert parallelism over a mesh axis is not "
                                  "ported yet (ROADMAP M15c, model and expert parallelism); "
                                  "pass model_axis=None")
    T, _ = x.shape
    capacity = min(capacity, T)
    gate = torch.softmax(x @ p["wg"], dim=1)  # [T, E]
    top_p, assign = gate.max(dim=1)  # the first maximum, as jnp.argmax
    if token_mask is not None:
        top_p = torch.where(token_mask, top_p, 0.0)
    out = torch.zeros_like(x)
    for e in range(p["w1"].shape[0]):
        score = torch.where((assign == e) & (top_p > 0), top_p, -1.0)
        val, idx = torch.sort(score, descending=True, stable=True)
        val, idx = val[:capacity], idx[:capacity]  # this expert's tokens
        w = torch.where(val > 0, val, 0.0)  # gate weight; 0 for empty slots
        he = F.gelu(x[idx] @ p["w1"][e] + p["b1"][e], approximate="tanh") @ p["w2"][e]
        out = out.index_add(0, idx, he * w[:, None])  # combine
    return out + p["b2"]
