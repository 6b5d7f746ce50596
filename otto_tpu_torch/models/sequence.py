"""Sequential session recommender — the RecBole-stack replacement
(reference: src/recbole/{dataset,trainer,inference}.py).

Port of ``otto_tpu/models/sequence.py``.  Five encoder architectures over
the session's last ``max_len`` aids, selected by
``SequenceModelConfig.architecture``: ``gru`` (GRU4Rec-style), ``narm``
(attention-GRU), ``stamp`` (attention/memory priority), ``caser`` (CNN) and
``transformer`` (SASRec-style, causal; with ``moe_experts > 0`` every FFN is
a top-1-gated mixture of experts, :mod:`otto_tpu_torch.ops.moe`).

The parameters are the reference's tree (dicts and lists of float32
tensors, with its names, shapes and scales), and the encoders are plain
functions over it, one per reference function.  What the reference's XLA
programs compute and PyTorch's defaults do not:

- the GRU cell applies the reset gate to the state *before* the candidate
  product, ``tanh(x W_xn + (r * h) W_hn + b_n)``, with one bias ``gru_b``
  [3H] (``torch.nn.GRU`` computes ``r * (h W_hn + b_hn)`` with two), and a
  masked step keeps the old state;
- GELU is the tanh form (``jax.nn.gelu``'s default); layer norm uses the
  biased variance and eps 1e-6; masked attention logits are set to -1e9,
  so a fully masked row is uniform, not NaN;
- products run in full float32 (TF32 off on the card).

Training (:func:`train_sequence_model`) draws the epoch permutations and the
negatives from ``np.random.default_rng(config.seed)`` exactly as the
reference does, so batches and negatives are bit-equal to its; only the
initial parameters differ, in distribution only (a ``torch.Generator``
seeded with ``config.seed``).  The optimizer is a dense Adam (every row's
moments decay every step, as ``optax.adam``'s).

Inference is ``full_sort_predict`` semantics: encode the session, score all
items (the PAD row excluded) through :class:`~otto_tpu_torch.ops.
fused_retrieval.FusedRetriever` (compensated precision; K1 and K2 on the
card) where the catalog has at least 65,536 aids, else the exact
:func:`~otto_tpu_torch.ops.retrieval.topk_scan`.  The 3-way serving routing
(>= 20 distinct aids -> recency weights, K3 on the card; else the model;
unknown last aid -> embedding-kNN fallback, recbole/inference.py:137-148) is
:func:`sequence_serving_predictions`.  Save and load use the reference's
npz layout (``leaf_{i}`` in ``jax.tree_util`` order), so either package
loads the other's file (the port stores it, not deflated).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from otto_tpu_torch import EVENT_TYPES
from otto_tpu_torch.config import SequenceModelConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.ops.moe import init_moe, moe_apply
from otto_tpu_torch.ops.retrieval import topk_scan
from otto_tpu_torch.utils.profiling import span
from otto_tpu_torch.utils.runtime import full_f32_matmul, resolve_device

log = get_logger(__name__)

# full_sort_topk scores through the fused retriever from this catalog size
FUSED_MIN_AIDS = 1 << 16


# ------------------------------------------------------------------ the tree
# A parameter tree is dicts and lists of tensors or arrays, as the
# reference's init_params builds it.
def tree_leaves(tree) -> list:
    """The leaves of a parameter tree in ``jax.tree_util`` order: dict keys
    sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _tree_unflatten(template, leaves):
    """``template``'s structure with ``leaves`` (in :func:`tree_leaves`
    order) in place of its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    return build(template)


# ------------------------------------------------------------------ params
def init_params(
    generator: torch.Generator,
    n_aids: int,
    dim: int,
    hidden: int,
    architecture: str = "gru",
    max_len: int = 20,
    n_layers: int = 2,
    n_heads: int = 2,
    moe_experts: int = 0,
) -> dict:
    """The reference's parameter tree (names, shapes and scales), float32 on
    the CPU, drawn from ``generator``; ``item_emb`` has a PAD row at
    ``n_aids``."""

    def normal(*shape):
        return torch.randn(*shape, generator=generator)

    if architecture in ("gru", "narm"):
        p = {
            "item_emb": normal(n_aids + 1, dim) * 0.05,  # +1 PAD row
            "gru_wx": normal(dim, 3 * hidden) * math.sqrt(1.0 / dim),
            "gru_wh": normal(hidden, 3 * hidden) * math.sqrt(1.0 / hidden),
            "gru_b": torch.zeros(3 * hidden),
            "out_proj": normal(hidden, dim) * math.sqrt(1.0 / hidden),
        }
        if architecture == "narm":
            # additive attention over the hidden-state sequence (NARM's local
            # encoder); out_proj widens to consume [global ; local]
            p["narm_a1"] = normal(hidden, hidden) * math.sqrt(1.0 / hidden)
            p["narm_a2"] = normal(hidden, hidden) * math.sqrt(1.0 / hidden)
            p["narm_v"] = normal(hidden) * math.sqrt(1.0 / hidden)
            p["out_proj"] = normal(2 * hidden, dim) * math.sqrt(0.5 / hidden)
        return p
    if architecture == "stamp":
        s = math.sqrt(1.0 / dim)
        return {
            "item_emb": normal(n_aids + 1, dim) * 0.05,
            "stamp_w1": normal(dim, dim) * s,
            "stamp_w2": normal(dim, dim) * s,
            "stamp_w3": normal(dim, dim) * s,
            "stamp_ba": torch.zeros(dim),
            "stamp_w0": normal(dim) * s,
            "stamp_ws": normal(dim, dim) * s,
            "stamp_bs": torch.zeros(dim),
            "stamp_wt": normal(dim, dim) * s,
            "stamp_bt": torch.zeros(dim),
        }
    if architecture == "caser":
        heights = (2, 3, 4)
        n_h = max(8, hidden // 4)  # filters per height
        n_v = 4
        p = {
            "item_emb": normal(n_aids + 1, dim) * 0.05,
            "caser_wv": normal(n_v, max_len) * math.sqrt(1.0 / max_len),
            "caser_wh": [normal(h * dim, n_h) * math.sqrt(1.0 / (h * dim)) for h in heights],
        }
        fc_in = n_v * dim + n_h * len(heights)
        p["caser_fc"] = normal(fc_in, dim) * math.sqrt(1.0 / fc_in)
        p["caser_fb"] = torch.zeros(dim)
        return p
    if architecture == "transformer":
        if dim % n_heads:
            raise ValueError(f"dim={dim} not divisible by n_heads={n_heads}")
        p = {
            "item_emb": normal(n_aids + 1, dim) * 0.05,
            "pos_emb": normal(max_len, dim) * 0.05,
            "out_proj": normal(dim, dim) * math.sqrt(1.0 / dim),
            "final_ln": {"scale": torch.ones(dim), "bias": torch.zeros(dim)},
            "layers": [],
        }
        s = math.sqrt(1.0 / dim)
        hd = dim // n_heads
        for _ in range(n_layers):
            layer = {
                # [D, heads, head_dim], as the reference lays them out
                "wq": normal(dim, n_heads, hd) * s,
                "wk": normal(dim, n_heads, hd) * s,
                "wv": normal(dim, n_heads, hd) * s,
                "wo": normal(dim, dim) * s,
                "ln1": {"scale": torch.ones(dim), "bias": torch.zeros(dim)},
                "ln2": {"scale": torch.ones(dim), "bias": torch.zeros(dim)},
            }
            if moe_experts > 0:
                layer["moe"] = init_moe(generator, dim, 4 * dim, moe_experts)
            else:
                layer.update(
                    ffn_w1=normal(dim, 4 * dim) * s,
                    ffn_b1=torch.zeros(4 * dim),
                    ffn_w2=normal(4 * dim, dim) * math.sqrt(0.25 / dim),
                    ffn_b2=torch.zeros(dim),
                )
            p["layers"].append(layer)
        return p
    raise ValueError(f"unknown architecture {architecture!r}")


def _config_params(config: SequenceModelConfig, generator: torch.Generator,
                   n_aids: int | None = None) -> dict:
    return init_params(generator, config.n_aids if n_aids is None else n_aids, config.dim,
                       config.hidden, architecture=config.architecture, max_len=config.max_len,
                       n_layers=config.n_layers, n_heads=config.n_heads,
                       moe_experts=config.moe_experts)


def _template(config: SequenceModelConfig) -> dict:
    """``config``'s tree with a one-row item table (its structure, and every
    shape but the table's)."""
    return _config_params(config, torch.Generator().manual_seed(0), n_aids=0)


def _check_leaves(leaves: list, config: SequenceModelConfig, what: str) -> None:
    """Raise unless ``leaves`` have the count and shapes of ``config``'s
    tree."""
    shapes = _tree_map(lambda t: tuple(t.shape), _template(config))
    shapes["item_emb"] = (config.n_aids + 1, config.dim)
    want = tree_leaves(shapes)
    got = [tuple(np.shape(v)) for v in leaves]
    if got != want:
        raise ValueError(f"{what}: parameter shapes {got} do not match the config's {want}")


def sequence_params_from_numpy(params: dict, config: SequenceModelConfig, *,
                               device: str | torch.device) -> dict:
    """The JAX package's parameter tree (dicts and lists of arrays, as its
    ``init_params`` builds them; any array type numpy reads) as float32
    tensors on ``device``; raises if its shapes are not ``config``'s."""
    _check_leaves(tree_leaves(params), config, "sequence_params_from_numpy")
    dev = resolve_device(device)
    return _tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), params)


def sequence_params_to_numpy(params: dict) -> dict:
    """The parameter tree as float32 numpy arrays (the JAX package's layout)."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), params)


# ------------------------------------------------------------------ encoders
def _embed(params, ids):
    """Rows ``ids`` of the item table.  ``F.embedding``'s backward sums the
    rows' gradients by a sort and segmented sums (deterministic); indexing's
    backward (``index_put_`` with accumulate) takes ~15 ms at the 1M rows of
    a step's negatives on an H100."""
    return F.embedding(ids, params["item_emb"])


def _gru_cell(w, h, xw):
    """One GRU step from the state ``h`` [B, H] and the input's projection
    ``xw`` = x @ gru_wx [B, 3H]; ``w`` holds ``gru_wh`` and ``gru_b`` split
    into their reset/update and candidate columns.  The reset gate applies
    to ``h`` before the candidate product, one bias."""
    wh_rz, wh_n, b_rz, b_n = w
    H = h.shape[-1]
    gates = xw[:, :2 * H] + h @ wh_rz + b_rz
    r = torch.sigmoid(gates[:, :H])
    z = torch.sigmoid(gates[:, H:])
    n = torch.tanh(xw[:, 2 * H:] + (r * h) @ wh_n + b_n)
    return (1 - z) * h + z * n


def _gru_states(params, seq, mask):
    """The GRU over time: the states [B, L, H] (a masked step keeps the old
    state) and the last one."""
    wh, b = params["gru_wh"], params["gru_b"]
    H = wh.shape[0]
    w = (wh[:, :2 * H], wh[:, 2 * H:], b[:2 * H], b[2 * H:])
    # the input projections of every step in one product (each is a dot
    # over D, as the reference's per-step products)
    xws = (_embed(params, seq) @ params["gru_wx"]).unbind(1)  # L x [B, 3H]
    h = torch.zeros((seq.shape[0], H), dtype=wh.dtype, device=wh.device)
    hs = []
    for t, xw in enumerate(xws):
        h = torch.where(mask[:, t, None], _gru_cell(w, h, xw), h)
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _encode_gru(params, seq, mask):
    _, h = _gru_states(params, seq, mask)
    return h @ params["out_proj"]


def _encode_narm(params, seq, mask):
    """NARM: the GRU's final state (global encoder) and an additive-attention
    context over all its states (local encoder; unnormalized sigmoid
    weights, zero at padding), ``[h_global ; c_local] @ out_proj``."""
    hs, h_last = _gru_states(params, seq, mask)
    q = h_last @ params["narm_a1"]  # [B, H]
    kk = hs @ params["narm_a2"]  # [B, L, H]
    alpha = torch.sigmoid(q[:, None, :] + kk) @ params["narm_v"]  # [B, L]
    alpha = torch.where(mask, alpha, 0.0)
    c_local = torch.einsum("bl,blh->bh", alpha, hs)
    return torch.cat([h_last, c_local], dim=1) @ params["out_proj"]


def _encode_stamp(params, seq, mask):
    """STAMP: attention a_i = w0 . sigmoid(W1 x_i + W2 m_t + W3 m_s + b_a),
    memory m_a = sum a_i x_i + m_s, session vector tanh(W_s m_a + b_s) *
    tanh(W_t m_t + b_t)."""
    emb = _embed(params, seq) * mask[:, :, None]  # [B, L, D]
    cnt = mask.sum(dim=1, keepdim=True).clamp(min=1)
    m_s = emb.sum(dim=1) / cnt  # [B, D] session mean
    last = (mask.sum(dim=1) - 1).clamp(min=0)
    m_t = emb[torch.arange(seq.shape[0], device=seq.device), last]  # [B, D]
    pre = (emb @ params["stamp_w1"] + (m_t @ params["stamp_w2"])[:, None, :]
           + (m_s @ params["stamp_w3"])[:, None, :] + params["stamp_ba"])
    alpha = torch.sigmoid(pre) @ params["stamp_w0"]  # [B, L]
    alpha = torch.where(mask, alpha, 0.0)
    m_a = torch.einsum("bl,bld->bd", alpha, emb) + m_s
    h_s = torch.tanh(m_a @ params["stamp_ws"] + params["stamp_bs"])
    h_t = torch.tanh(m_t @ params["stamp_wt"] + params["stamp_bt"])
    return h_s * h_t


def _encode_caser(params, seq, mask):
    """Caser: horizontal convolutions of heights 2-4 as products of stacked
    windows, ReLU, windows past the session length zeroed, max-pooled over
    time; a vertical convolution over positions; both through the
    fully-connected layer and a ReLU."""
    emb = _embed(params, seq) * mask[:, :, None]  # [B, L, D]
    B, L, D = emb.shape
    lens = mask.sum(dim=1)  # [B]
    feats = [torch.einsum("vl,bld->bvd", params["caser_wv"], emb).reshape(B, -1)]
    for w in params["caser_wh"]:
        h = w.shape[0] // D
        win = torch.cat([emb[:, j:L - h + 1 + j] for j in range(h)], dim=-1)  # [B, L-h+1, h*D]
        conv = torch.relu(win @ w)  # [B, L-h+1, n_h]
        valid = (torch.arange(L - h + 1, device=seq.device)[None, :] + h) <= lens[:, None]
        conv = torch.where(valid[:, :, None], conv, 0.0)
        feats.append(conv.amax(dim=1))
    z = torch.cat(feats, dim=1)
    return torch.relu(z @ params["caser_fc"] + params["caser_fb"])


def _layer_norm(ln, x, eps: float = 1e-6):
    """Layer norm with the biased variance and eps 1e-6, as the reference's."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * ln["scale"] + ln["bias"]


def transformer_block(layer, x, attn_ok):
    """One pre-LN causal self-attention + FFN block; layers carrying a
    ``moe`` sub-tree use the mixture-of-experts FFN."""
    B, L, D = x.shape
    h = _layer_norm(layer["ln1"], x)
    hd = layer["wq"].shape[-1]
    q = torch.einsum("bld,dhk->blhk", h, layer["wq"])
    k = torch.einsum("bld,dhk->blhk", h, layer["wk"])
    v = torch.einsum("bld,dhk->blhk", h, layer["wv"])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    logits = torch.where(attn_ok[:, None], logits, -1e9)
    att = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, D)
    x = x + out @ layer["wo"]
    h = _layer_norm(layer["ln2"], x)
    if "moe" in layer:
        return x + _moe_ffn(layer["moe"], h, attn_ok)
    return x + F.gelu(h @ layer["ffn_w1"] + layer["ffn_b1"],
                      approximate="tanh") @ layer["ffn_w2"] + layer["ffn_b2"]


def _moe_ffn(moe, h, attn_ok, model_axis: str | None = None, mesh=None):
    """MoE FFN over the flattened [B*L] token stream; padding positions (the
    last attention row is the key mask) never occupy expert capacity.
    Capacity factor 2 over a uniform split, T counting the padded rows.
    With ``model_axis`` (and the rank's ``mesh``) the experts split over
    that axis (``moe_apply``'s expert parallelism)."""
    B, L, D = h.shape
    n_experts = moe["wg"].shape[1]
    tok_ok = attn_ok[:, -1, :].reshape(-1)  # [B*L] key mask
    T = B * L
    cap = min(T, max(1, -(-2 * T // n_experts)))
    return moe_apply(moe, h.reshape(T, D), capacity=cap, model_axis=model_axis,
                     token_mask=tok_ok, mesh=mesh).reshape(B, L, D)


def _positions(params, seq, mask):
    """The transformer's input: item and position embeddings, zero at
    padding [B, L, D], and the causal key mask [B, Lq, Lk]."""
    L = seq.shape[1]
    x = _embed(params, seq) + params["pos_emb"][None, :L]  # [B, L, D]
    x = torch.where(mask[:, :, None], x, 0.0)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=seq.device))
    return x, causal[None] & mask[:, None, :]


def _last_state(params, x, mask):
    """The final norm, the state at the last valid position, ``out_proj``."""
    x = _layer_norm(params["final_ln"], x)
    last = (mask.sum(dim=1) - 1).clamp(min=0)  # [B]
    return x[torch.arange(x.shape[0], device=x.device), last] @ params["out_proj"]


def _encode_transformer(params, seq, mask):
    """SASRec-style causal encoder over right-padded sessions; the session
    vector is the state at the last valid position."""
    x, attn_ok = _positions(params, seq, mask)
    for layer in params["layers"]:
        x = transformer_block(layer, x, attn_ok)
    return _last_state(params, x, mask)


def encode(params, seq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """seq: int [B, L] (PAD = n_aids), mask: bool [B, L] on the parameters'
    device; returns session vectors float32 [B, dim].  The caller turns
    TF32 off on the card (:func:`full_f32_matmul`)."""
    if "stamp_w0" in params:
        return _encode_stamp(params, seq, mask)
    if "caser_fc" in params:
        return _encode_caser(params, seq, mask)
    if "narm_v" in params:
        return _encode_narm(params, seq, mask)
    if "gru_wx" in params:
        return _encode_gru(params, seq, mask)
    return _encode_transformer(params, seq, mask)


# ------------------------------------------------------------------ model
@dataclass
class SequenceModel:
    """Trained parameters (a tree of float32 tensors on one device), the
    config and the per-epoch mean losses."""

    params: dict
    config: SequenceModelConfig
    history: list = field(default_factory=list)

    @property
    def device(self) -> torch.device:
        return self.params["item_emb"].device

    @torch.no_grad()
    def session_vectors(self, store: EventStore, batch: int = 4096) -> torch.Tensor:
        """Session vectors float32 [S, dim] on the model's device.  Every
        batch is padded to ``batch`` rows with all-PAD sessions, as the
        reference pads it (the MoE's capacity counts those rows)."""
        cfg = self.config
        dev = self.device
        packed = store.pack(max_len=cfg.max_len, keep="last")
        with span("otto::sessions.pack"):  # the upload counts as packing
            seq = torch.as_tensor(np.where(packed.mask, packed.aids, cfg.n_aids).astype(np.int32),
                                  device=dev)
            mask = torch.as_tensor(packed.mask, device=dev)
        out = torch.empty((store.n_sessions, cfg.dim), dtype=torch.float32, device=dev)
        with span("otto::encode"), full_f32_matmul():
            for start in range(0, store.n_sessions, batch):
                end = min(start + batch, store.n_sessions)
                s, m = seq[start:end], mask[start:end]
                pad = batch - (end - start)
                if pad:
                    s = torch.cat([s, torch.full((pad, cfg.max_len), cfg.n_aids,
                                                 dtype=s.dtype, device=dev)])
                    m = torch.cat([m, torch.zeros((pad, cfg.max_len), dtype=torch.bool,
                                                  device=dev)])
                out[start:end] = encode(self.params, s, m)[:end - start]
        return out

    def encode_sessions(self, store: EventStore, batch: int = 4096) -> np.ndarray:
        """:meth:`session_vectors` as numpy."""
        return self.session_vectors(store, batch).cpu().numpy()

    @torch.no_grad()
    def full_sort_topk(self, store: EventStore, k: int = 20, batch: int = 4096) -> np.ndarray:
        """Top-k items for every session (recbole full_sort_predict + topk,
        PAD row excluded), int32 [S, k].

        Catalogs of at least 65,536 aids go through
        ``FusedRetriever(precision="compensated")`` (K1 and K2 on the card,
        their twins on the CPU; f32-accurate scores to ~2^-17); smaller ones
        through the exact :func:`topk_scan`."""
        vecs = self.session_vectors(store, batch=batch)
        items = self.params["item_emb"][:self.config.n_aids]
        out = np.zeros((store.n_sessions, k), np.int32)
        retriever = None
        if self.config.n_aids >= FUSED_MIN_AIDS:
            from otto_tpu_torch.ops.fused_retrieval import FusedRetriever

            retriever = FusedRetriever(items, metric="dot", precision="compensated",
                                       device=self.device)
        for start in range(0, store.n_sessions, batch):
            q = vecs[start:start + batch]
            if retriever is not None:
                _, i = retriever.topk(q, k=k)
            else:
                _, i = topk_scan(q, items, k=k, block=16384, metric="dot")
            with span("otto::serve.readback"):
                out[start:start + batch] = i.cpu().numpy()
        return out

    def save(self, path) -> None:
        """The reference's npz layout: ``leaf_{i}`` in ``jax.tree_util``
        order (dict keys sorted, lists in order).  Stored, not deflated (a
        float32 item table barely compresses, and deflating the full
        catalog's 475 MB takes seconds); ``np.load`` in either package
        reads both."""
        np.savez(path, **{f"leaf_{i}": v for i, v in enumerate(
            tree_leaves(sequence_params_to_numpy(self.params)))})

    @classmethod
    def load(cls, path, config: SequenceModelConfig, *,
             device: str | torch.device) -> "SequenceModel":
        """Read an npz written by either package's ``save``."""
        with np.load(path) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
        _check_leaves(leaves, config, f"SequenceModel.load({path})")
        return cls(sequence_params_from_numpy(_tree_unflatten(_template(config), leaves), config,
                                              device=device), config)


# ------------------------------------------------------------------ training
def _training_examples(store: EventStore, max_len: int, n_aids: int):
    """(prefix sequence, next aid) pairs: one example per event with >= 1
    predecessor, prefix clipped to the last max_len events (numpy, copied)."""
    pos = store.position_in_session
    valid = pos > 0
    tgt_idx = np.flatnonzero(valid)
    n = len(tgt_idx)
    seqs = np.full((n, max_len), n_aids, np.int32)
    masks = np.zeros((n, max_len), bool)
    # for each target event at flat index i with in-session position p, the
    # prefix is events [i-p, i) clipped to max_len
    p = pos[tgt_idx]
    take = np.minimum(p, max_len)
    for j in range(max_len):  # bounded by max_len (20), vectorized over n
        src = tgt_idx - take + j
        ok = j < take
        seqs[ok, j] = store.aid[src[ok]]
        masks[ok, j] = True
    targets = store.aid[tgt_idx].astype(np.int32)
    return seqs, masks, targets


def sequence_loss(params, seq, mask, tgt, negs, *, loss: str = "sampled_softmax",
                  bpr_reg: float = 1.0) -> torch.Tensor:
    """The training objective of one batch: sampled softmax (one positive
    against the sampled negatives) or GRU4Rec+'s BPR-max (negatives
    softmax-weighted by their own scores, plus a score regularizer)."""
    h = encode(params, seq, mask)  # [B, D]
    if loss != "bpr_max":
        return sampled_softmax(h, params["item_emb"], tgt, negs)
    pos_logit, neg_logit = _scores(h, params["item_emb"], tgt, negs)
    s = torch.softmax(neg_logit, dim=1)
    p_win = (s * torch.sigmoid(pos_logit[:, None] - neg_logit)).sum(dim=1)
    reg = (s * neg_logit ** 2).sum(dim=1)
    return (-torch.log(p_win + 1e-10) + bpr_reg * reg).mean()


def _scores(h, item_emb, tgt, negs):
    """The session vectors' scores [B] against the targets and [B, Neg]
    against the negatives; the positive and the negatives in one gather
    (one table-sized gradient)."""
    rows = F.embedding(torch.cat([tgt[:, None], negs], dim=1), item_emb)  # [B, 1 + Neg, D]
    pos_e, neg_e = rows[:, 0], rows[:, 1:]
    return (h * pos_e).sum(dim=1), torch.einsum("bd,bnd->bn", h, neg_e)


def sampled_softmax(h, item_emb, tgt, negs) -> torch.Tensor:
    """One positive against the sampled negatives: the mean over the batch of
    -log softmax of the positive's score."""
    pos_logit, neg_logit = _scores(h, item_emb, tgt, negs)
    logits = torch.cat([pos_logit[:, None], neg_logit], dim=1)
    return -torch.log_softmax(logits, dim=1)[:, 0].mean()


def make_optimizer(params: dict, config: SequenceModelConfig) -> torch.optim.Adam:
    """``optax.adam(config.learning_rate)``: b1 0.9, b2 0.999, eps 1e-8,
    dense over every leaf (the fused implementation: one pass a tensor)."""
    return torch.optim.Adam(tree_leaves(params), lr=config.learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, fused=True)


def train_step(params: dict, optimizer: torch.optim.Optimizer, seq, mask, tgt, negs, *,
               loss: str = "sampled_softmax", bpr_reg: float = 1.0) -> torch.Tensor:
    """One update of ``params`` (leaves that require grad) on a batch.
    Returns the loss before the update (a 0-d tensor; nothing is read
    back)."""
    optimizer.zero_grad(set_to_none=True)
    with full_f32_matmul():
        value = sequence_loss(params, seq, mask, tgt, negs, loss=loss, bpr_reg=bpr_reg)
        value.backward()
    optimizer.step()
    return value.detach()


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; on the card through pinned memory without
    waiting for the copy (the caching host allocator keeps the buffer until
    the copy has run)."""
    t = torch.from_numpy(a)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def train_sequence_model(
    store: EventStore, config: SequenceModelConfig = SequenceModelConfig(), *,
    device: str | torch.device,
) -> SequenceModel:
    """Train on every (prefix, next aid) example of ``store`` on ``device``.

    The examples go to ``device`` once.  One ``np.random.default_rng(
    config.seed)`` stream draws each epoch's permutation and then each
    step's negatives [batch, n_negatives] (uniform over the catalog), as the
    reference draws them; an epoch takes ``max(n // batch, 1)`` steps, a
    short batch tiled from its own rows.  Each epoch's mean loss is read
    back once, into ``history``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    params = _tree_map(lambda t: t.to(dev).requires_grad_(True),
                       _config_params(config, torch.Generator().manual_seed(config.seed)))
    optimizer = make_optimizer(params, config)

    seqs, masks, targets = _training_examples(store, config.max_len, config.n_aids)
    log.info("sequence model: %d training examples", len(targets))
    seqs_d, masks_d, targets_d = (torch.as_tensor(a, device=dev) for a in (seqs, masks, targets))

    B = config.batch_size
    n = len(targets)
    n_steps = max(n // B, 1)
    history = []
    for epoch in range(config.epochs):
        order = rng.permutation(n)
        sels = []
        for i in range(n_steps):
            sel = order[i * B:(i + 1) * B]
            if len(sel) < B:
                # wrap (tiling as needed) so tiny datasets still fill a batch
                reps = -(-B // max(len(sel), 1))
                sel = np.tile(sel, reps)[:B]
            sels.append(sel)
        sels = _upload(np.stack(sels), dev)
        losses = []
        for i in range(n_steps):
            negs = rng.integers(0, config.n_aids, (B, config.n_negatives)).astype(np.int32)
            sel = sels[i]
            losses.append(train_step(params, optimizer, seqs_d[sel], masks_d[sel],
                                     targets_d[sel], _upload(negs, dev), loss=config.loss,
                                     bpr_reg=config.bpr_reg))
        history.append({"epoch": epoch,
                        "loss": float(torch.stack(losses).to(torch.float64).mean())})
        log.info("sequence epoch %d: loss %.4f", epoch, history[-1]["loss"])
    params = _tree_map(lambda t: t.detach(), params)
    return SequenceModel(params, config, history)


# ------------------------------------------------------------------ serving
def sequence_serving_predictions(
    store: EventStore,
    model: SequenceModel,
    trained_aid_mask: np.ndarray | None = None,
    ft_neighbors: np.ndarray | None = None,
    k: int = 20,
) -> dict[str, np.ndarray]:
    """3-way serving routing (recbole/inference.py:137-148), on the model's
    device:

    - >= 20 distinct aids -> typed recency weights (K3 on the card)
    - last aid seen in training -> the model's full-sort top-k
    - otherwise -> the embedding-kNN row of the last aid (``-1`` without
      ``ft_neighbors``)

    Adds each route's sessions to ``sequence_serving_predictions.sessions``.
    """
    from otto_tpu_torch.models.covisitation import sessions_with_distinct_at_least
    from otto_tpu_torch.ops.sessions import recency_weighted_top_aids

    with span("otto::serve"):
        dev = model.device
        with span("otto::serve.route"):
            route_recency = sessions_with_distinct_at_least(store, 20)
            last = store.last_aid()
            S = store.n_sessions
            in_vocab = (trained_aid_mask[last] if trained_aid_mask is not None
                        else np.ones(S, bool))
            route_model = ~route_recency & in_vocab
            route_fallback = ~route_recency & ~in_vocab
        routed = sequence_serving_predictions.sessions
        for route, on in (("recency", route_recency), ("model", route_model),
                          ("fallback", route_fallback)):
            routed[route] += int(on.sum())

        preds = np.full((S, k), -1, np.int32)
        if route_recency.any():
            with span("otto::serve.recency"):
                idx = np.flatnonzero(route_recency)
                packed = store.select_sessions(idx).pack(max_len=256, keep="last")
                with span("otto::sessions.pack"):  # the upload counts as packing
                    rows = [torch.as_tensor(a, device=dev) for a in (
                        packed.aids, packed.types, packed.mask, packed.lengths)]
                top, _ = recency_weighted_top_aids(
                    *rows, torch.tensor([1.0, 6.0, 3.0], dtype=torch.float32, device=dev),
                    k=k, lo=0.1, hi=1.0,
                )
                del rows  # free the uploads before the model route runs
                with span("otto::serve.readback"):
                    preds[idx] = top.cpu().numpy()
        if route_model.any():
            with span("otto::serve.model"):
                idx = np.flatnonzero(route_model)
                preds[idx] = model.full_sort_topk(store.select_sessions(idx), k=k)
        if route_fallback.any() and ft_neighbors is not None:
            with span("otto::serve.fallback"):
                idx = np.flatnonzero(route_fallback)
                rows = ft_neighbors[last[idx]][:, :k]
                preds[idx, :rows.shape[1]] = rows
        return {etype: preds.copy() for etype in EVENT_TYPES}


# sessions served by each route, summed over calls (the fallback's get no
# list without ``ft_neighbors``)
sequence_serving_predictions.sessions = {"recency": 0, "model": 0, "fallback": 0}
