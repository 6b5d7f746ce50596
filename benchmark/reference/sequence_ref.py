"""SASRec- and GRU4Rec-style session encoders and the catalog scores, in
plain PyTorch, float32 with TF32 off.

The architecture is the one the port states (``otto_tpu_torch/models/
sequence.py``'s docstring), written again here from that description:

- SASRec: item plus position embeddings over the session's last ``max_len``
  aids (left-aligned, zero at padding), pre-LN blocks of causal multi-head
  attention (masked logits -1e9) and a tanh-GELU FFN, a final layer norm
  (biased variance, eps 1e-6), the state at the last valid position through
  ``out_proj``;
- GRU4Rec: a GRU over the embeddings whose reset gate multiplies the state
  before the candidate product, one bias; a padded step keeps the state;
  the last state through ``out_proj``.

``precision="tf32"`` is the control: every matrix product takes its
operands rounded to TF32 (10 explicit mantissa bits, round to nearest even),
as the card's TF32 tensor cores do, and accumulates in float32.  The rounding is done by hand so that the control
reads the same on a CPU.

Parameters are a flat dict of float32 tensors keyed by the port's leaf paths
(``item_emb``, ``layers.0.wq``, ``gru_wx``, ...).
"""

from __future__ import annotations

import math

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def matmul(a, b, precision: str):
    if precision == "f32":
        return a @ b
    if precision == "tf32":
        return round_tf32(a) @ round_tf32(b)
    raise ValueError(f"unknown precision {precision!r}")


def layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) * (x - mean)).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-6) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def embed(P, ids):
    return P["item_emb"][ids]


def sasrec_encode(P: dict, seq: torch.Tensor, mask: torch.Tensor, precision: str = "f32"):
    """seq int64 [B, L] (any id at padding), mask bool [B, L] left-aligned ->
    session vectors [B, D]."""
    B, L = seq.shape
    x = embed(P, seq) + P["pos_emb"][:L][None]
    x = x * mask[..., None]
    n_layers = 1 + max(int(k.split(".")[1]) for k in P if k.startswith("layers."))
    allowed = torch.tril(torch.ones(L, L, dtype=torch.bool, device=seq.device))[None] \
        & mask[:, None, :]  # [B, query, key]
    for i in range(n_layers):
        p = f"layers.{i}."
        D, H, hd = P[p + "wq"].shape
        h = layer_norm(x, P[p + "ln1.scale"], P[p + "ln1.bias"])
        heads = []
        for j in range(H):
            q = matmul(h, P[p + "wq"][:, j, :], precision)  # [B, L, hd]
            k = matmul(h, P[p + "wk"][:, j, :], precision)
            v = matmul(h, P[p + "wv"][:, j, :], precision)
            logits = matmul(q, k.transpose(1, 2), precision) / math.sqrt(hd)
            logits = torch.where(allowed, logits, torch.full_like(logits, -1e9))
            heads.append(matmul(torch.softmax(logits, -1), v, precision))
        x = x + matmul(torch.cat(heads, -1), P[p + "wo"], precision)
        h = layer_norm(x, P[p + "ln2.scale"], P[p + "ln2.bias"])
        f = gelu_tanh(matmul(h, P[p + "ffn_w1"], precision) + P[p + "ffn_b1"])
        x = x + matmul(f, P[p + "ffn_w2"], precision) + P[p + "ffn_b2"]
    x = layer_norm(x, P["final_ln.scale"], P["final_ln.bias"])
    last = (mask.sum(1) - 1).clamp(min=0)
    return matmul(x[torch.arange(B, device=seq.device), last], P["out_proj"], precision)


def gru_encode(P: dict, seq: torch.Tensor, mask: torch.Tensor, precision: str = "f32"):
    B, L = seq.shape
    wx, wh, b = P["gru_wx"], P["gru_wh"], P["gru_b"]
    H = wh.shape[0]
    xs = matmul(embed(P, seq), wx, precision)  # [B, L, 3H]
    h = torch.zeros(B, H, dtype=torch.float32, device=seq.device)
    for t in range(L):
        xt = xs[:, t]
        r = torch.sigmoid(xt[:, :H] + matmul(h, wh[:, :H], precision) + b[:H])
        z = torch.sigmoid(xt[:, H:2 * H] + matmul(h, wh[:, H:2 * H], precision) + b[H:2 * H])
        cand = torch.tanh(xt[:, 2 * H:] + matmul(r * h, wh[:, 2 * H:], precision) + b[2 * H:])
        new = (1.0 - z) * h + z * cand
        h = torch.where(mask[:, t, None], new, h)
    return matmul(h, P["out_proj"], precision)


def encode(P: dict, architecture: str, seq, mask, precision: str = "f32"):
    if architecture == "transformer":
        return sasrec_encode(P, seq, mask, precision)
    if architecture == "gru":
        return gru_encode(P, seq, mask, precision)
    raise ValueError(f"no reference for architecture {architecture!r}")


def catalog_scores(q: torch.Tensor, items: torch.Tensor, precision: str = "f32"):
    """Dot-product scores of session vectors [S, D] against items [N, D]."""
    return matmul(q, items.T, precision)

