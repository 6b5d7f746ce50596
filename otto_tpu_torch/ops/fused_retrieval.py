"""Fused retrieval: one-pass packed windowed-max + peeled selection.

Port of ``otto_tpu/ops/pallas_retrieval.py``; :class:`FusedRetriever` is the
counterpart of ``PallasRetriever``.  It replaces the reference's Annoy index
(src/gensim_fasttext/inference.py:40-65) with a two-stage top-k:

- **Stage 1** (:func:`fused_stage1`, hand-written CUDA kernel on the card) —
  score every query against the augmented, transposed item table and reduce
  each strided 128-item window to ONE packed float32: the score's bits with
  the low 7 bits replaced by the item's position in the window.  Within each
  16384-item chunk, window ``l`` holds the items ``{l, 128+l, ...,
  127*128+l}``.  The [B, N] score matrix is never stored.

  The euclidean bias (-||x||^2), a power-of-two positivity shift C and the
  padding mask are folded into the product through two augmented dimensions:
  item column [x, -||x||^2, 1] against query row [2q, 1, C].  Every real
  score is >= 1; pad columns are all zero and score exactly 0, so they pack to
  bits in [0, 128) and rank below every real item.

- **Stage 2** (:func:`otto_tpu_torch.ops.row_topk.peel_rows`, hand-written
  CUDA kernel on the card) — R rounds of pop-the-max of every 128-window over
  the [B, N/128] packed maxima.

- **Stage 3** (plain torch) — a stable sort of the R*(N/16384) survivors,
  decode (column, low bits) to the item index, and optionally rescore the k
  winners exactly.

Recall: an entry is missed if another top-k entry shares its 128-item window
(stage 1, ~(k-1)*128/N) or if >= R stronger window maxima share its stage-2
window.  Use :func:`otto_tpu_torch.ops.retrieval.topk_scan` when exactness is
required.
"""

from __future__ import annotations

import numpy as np
import torch

from otto_tpu_torch.ops import _kernels
from otto_tpu_torch.ops.row_topk import peel_rows
from otto_tpu_torch.utils.runtime import full_f32_matmul, resolve_device

NEG = float(np.float32(-3.0e38))
WINDOW = 128
LANE_MASK = WINDOW - 1  # low 7 bits carry the in-window position
CHUNK = WINDOW * WINDOW  # strided windows live inside 16384-item chunks
LIVE_BITS = 0x3F800000  # bits of 1.0: every real score is >= 1

# The stage-1 twin materialises [B, cols] float32 scores; it walks the
# columns in whole chunks so that one step holds at most this many elements.
_REFERENCE_STEP_ELEMS = 1 << 28

# Routes of stage 1 on the card, chosen by dtype and depth
# (:func:`stage1_route`): bf16 tables go to the tensor cores, through the
# wgmma kernel whose table tile of DA rows is one TMA box (at most 256
# rows), or through the deep wgmma kernel, whose tile is two boxes and whose
# query rows sit in registers as wgmma A fragments (at most 512).  Float32
# tables, and bf16 tables deeper than that, go to the FMA kernel, whose
# [DA, 32] float32 query tile must fit in a block's 232,448 bytes of shared
# memory on an H100.
K1_WGMMA_MAX_DA = 256
K1_WGMMA_DEEP_MAX_DA = 512
K1_FMA_MAX_DA = 232_448 // (32 * 4)  # 1,816


def stage1_route(dtype: torch.dtype, da: int) -> str:
    """The kernel :func:`fused_stage1` launches for a card's operands of
    ``dtype`` and depth ``da``: ``"wgmma"`` (bf16, DA <= 256),
    ``"wgmma_deep"`` (bf16, 256 < DA <= 512) or ``"fma"`` (float32, and bf16
    deeper than 512).  Raises for DA outside 1..1,816 and for other dtypes."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_stage1: no kernel for {dtype}")
    if not 1 <= da <= K1_FMA_MAX_DA:
        raise ValueError(f"fused_stage1: the kernels take 1 <= DA <= {K1_FMA_MAX_DA}, got {da}")
    if dtype == torch.bfloat16 and da <= K1_WGMMA_MAX_DA:
        return "wgmma"
    if dtype == torch.bfloat16 and da <= K1_WGMMA_DEEP_MAX_DA:
        return "wgmma_deep"
    return "fma"


def _pack_window_max(s: torch.Tensor) -> torch.Tensor:
    """[B, n_chunks*16384] float32 scores -> [B, n_chunks*128] packed maxima."""
    b, n = s.shape
    code = (torch.arange(n, device=s.device, dtype=torch.int32) >> 7) & LANE_MASK
    packed = ((s.view(torch.int32) & ~LANE_MASK) | code).view(torch.float32)
    # [B, chunk, a, l] -> max over the position a of each strided window l
    return packed.reshape(b, n // CHUNK, WINDOW, WINDOW).amax(dim=2).reshape(b, n // WINDOW)


def _stage1_reference(q_aug: torch.Tensor, items_aug_t: torch.Tensor) -> torch.Tensor:
    """Plain-torch twin of the stage-1 kernel: float32 scores of q_aug
    [B, DA] against items_aug_t [DA, N_pad], packed and window-maxed to
    [B, N_pad/128].  Products run in float32 (TF32 off on the card)."""
    b = q_aug.shape[0]
    n_pad = items_aug_t.shape[1]
    q = q_aug.to(torch.float32)
    out = torch.empty((b, n_pad // WINDOW), dtype=torch.float32, device=q_aug.device)
    step = max(_REFERENCE_STEP_ELEMS // max(b, 1) // CHUNK, 1) * CHUNK
    with full_f32_matmul():
        for c0 in range(0, n_pad, step):
            c1 = min(c0 + step, n_pad)
            s = q @ items_aug_t[:, c0:c1].to(torch.float32)
            out[:, c0 // WINDOW:c1 // WINDOW] = _pack_window_max(s)
    return out


def fused_stage1(q_aug: torch.Tensor, items_aug_t: torch.Tensor) -> torch.Tensor:
    """Packed strided-window maxima [B, N_pad/128] float32 of q_aug [B, DA]
    against items_aug_t [DA, N_pad] (the counterpart of ``_stage1``).

    Both operands bf16, or both float32; N_pad a multiple of 16384.  On a
    CUDA tensor this launches the kernel :func:`stage1_route` names:
    ``fused_stage1_bf16_kernel`` (tensor cores, bf16 with DA <= 256; counted
    in ``fused_stage1.launches``), ``fused_stage1_deep_kernel`` (tensor
    cores, bf16 with 256 < DA <= 512; ``fused_stage1.deep_launches``) or
    ``fused_stage1_fma_kernel`` (CUDA-core FMA: float32, and bf16 with DA >
    512; ``fused_stage1.fma_launches``), and raises for DA > 1,816; on a CPU
    tensor it runs :func:`_stage1_reference`.
    """
    b, da = q_aug.shape
    da_t, n_pad = items_aug_t.shape
    if da != da_t or n_pad % CHUNK:
        raise ValueError(f"fused_stage1: shapes {tuple(q_aug.shape)} x "
                         f"{tuple(items_aug_t.shape)} (N_pad must be a multiple of {CHUNK})")
    if q_aug.dtype != items_aug_t.dtype or q_aug.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_stage1: dtypes {q_aug.dtype}, {items_aug_t.dtype}; "
                        "both must be bfloat16 or both float32")
    if q_aug.device != items_aug_t.device:
        raise ValueError("fused_stage1: operands on different devices")
    if q_aug.device.type == "cpu":
        return _stage1_reference(q_aug, items_aug_t)
    if q_aug.device.type != "cuda":
        raise ValueError(f"fused_stage1: no kernel for device {q_aug.device}")
    if n_pad // CHUNK > 65535:
        raise ValueError(f"fused_stage1: {n_pad} items exceed the kernel's grid")
    route = stage1_route(q_aug.dtype, da)
    q_aug = q_aug.contiguous()
    items_aug_t = items_aug_t.contiguous()
    if route != "fma" and items_aug_t.data_ptr() % 16:
        raise ValueError("fused_stage1: the table must start on a 16-byte boundary (TMA)")
    out = torch.empty((b, n_pad // WINDOW), dtype=torch.float32, device=q_aug.device)
    if b:
        if route == "wgmma":
            _kernels.launch_fused_stage1_bf16(q_aug, items_aug_t, out)
            fused_stage1.launches += 1
        elif route == "wgmma_deep":
            _kernels.launch_fused_stage1_deep(q_aug, items_aug_t, out)
            fused_stage1.deep_launches += 1
        else:
            _kernels.launch_fused_stage1_fma(q_aug, items_aug_t, out)
            fused_stage1.fma_launches += 1
    return out


# launches made by this wrapper, one counter a kernel
fused_stage1.launches = 0       # the wgmma kernel (bf16, DA <= 256)
fused_stage1.deep_launches = 0  # the deep wgmma kernel (bf16, 256 < DA <= 512)
fused_stage1.fma_launches = 0   # the FMA kernel (float32; bf16, DA > 512)


def _bf16_split(x: torch.Tensor):
    """float32 -> (hi, lo) bf16 with hi + lo ~ x to ~2^-17 relative; the
    casts round to nearest even, as JAX's do."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


class FusedRetriever:
    """Prepared item table + fused top-k search (counterpart of
    ``otto_tpu.ops.pallas_retrieval.PallasRetriever``).

    ``items`` [N, D] float, moved to ``device``.  ``metric``: "dot" (score
    q.x) or "euclidean" (Annoy euclidean order: score 2 q.x - ||x||^2).  The
    augmented table [D+2, N_pad] is stored transposed in ``table_dtype``
    (bf16 by default); returned exact scores come from a float32 copy.

    ``precision="compensated"`` stores an error-compensated bf16 split of the
    augmented table: item columns ``[hi(x); lo(x); hi(x)]`` scored against
    query rows ``[qhi, qhi, qlo]``, so the product accumulates
    ``qhi·hi + qhi·lo + qlo·hi ≈ q·x`` to ~2^-17 relative error from bf16
    inputs.  The contraction grows from D+2 to 3(D+2).

    ``block`` is a multiple of 16384; it sets only the dense-fallback rule
    of :meth:`topk` (tables of at most 4 blocks are scored densely).
    """

    def __init__(self, items, metric: str = "dot", block: int = CHUNK,
                 table_dtype: torch.dtype = torch.bfloat16, precision: str = "single",
                 *, device: str | torch.device):
        if block % CHUNK:
            raise ValueError("block must be a multiple of 128*128")
        if precision not in ("single", "compensated"):
            raise ValueError(f"unknown precision {precision!r}")
        if metric not in ("dot", "euclidean"):
            raise ValueError(f"unknown metric {metric!r}")
        if precision == "compensated" and table_dtype != torch.bfloat16:
            raise ValueError(
                "precision='compensated' hardcodes a bf16 hi/lo split; "
                f"table_dtype={table_dtype} is ignored — pass the default "
                "bf16 or use precision='single'")
        if table_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"table_dtype must be bfloat16 or float32, got {table_dtype}")
        self.device = resolve_device(device)
        itf = torch.as_tensor(items, dtype=torch.float32, device=self.device)
        self.n_items, self.dim = itf.shape
        self.metric = metric
        self.block = block
        self.precision = precision
        n_pad = (-self.n_items) % block

        sq = (itf * itf).sum(dim=1)
        self.max_sq = float(sq.max())
        self.items = itf  # [N, D] float32, for rescoring
        self.sq = sq      # [N] float32
        ones = torch.ones((self.n_items, 1), dtype=torch.float32, device=self.device)
        aug = torch.cat([itf, -sq[:, None], ones], dim=1)  # rows [x, -||x||^2, 1]
        if precision == "compensated":
            hi, lo = _bf16_split(aug)
            table = torch.cat([hi, lo, hi], dim=1)  # [N, 3(D+2)] bf16
        else:
            table = aug.to(table_dtype)
        self.items_aug_t = torch.nn.functional.pad(table.T, (0, n_pad)).contiguous()

    def topk(self, queries, k: int, rounds: int = 6, exact_scores: bool = False):
        """queries [B, D] -> (scores [B, k] float32, indices [B, k] int32),
        descending.

        Scores decode from the packed keys (relative error <= 2^-17 of the
        shifted score — the 7 lane bits); ``exact_scores=True`` re-gathers the
        winning items and rescores them in float32.
        """
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        n_pad = self.items_aug_t.shape[1]
        n_cands = rounds * (n_pad // CHUNK)
        if k > n_cands or n_pad <= 4 * self.block:
            return _dense_topk(self.items, self.sq, q, metric=self.metric,
                               k=min(k, self.n_items))
        return _topk_impl(self.items_aug_t, self.items, self.sq, q, metric=self.metric,
                          n_items=self.n_items, max_sq=self.max_sq, rounds=rounds, k=k,
                          exact_scores=exact_scores, precision=self.precision)


def _decode_index(col: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Strided-window decode: global window column ``col`` = chunk*128 + lane,
    packed low bits ``pos`` = position within the window -> item index
    ``chunk*16384 + pos*128 + lane``."""
    return (col >> 7) * CHUNK + pos * WINDOW + (col & LANE_MASK)


def _augment_queries(q: torch.Tensor, max_sq: float, metric: str):
    """[B, D] float32 -> ([B, D+2] = [aq, u, C], C); C a power of two making
    every real score positive (>= 1) in both metrics.

    The exponent is ceil(log2(bound)) in float32, as in the reference; the
    power itself is formed exactly on the host, so C is exact in bf16 (the
    reference's ``jnp.exp2`` is not exact on every backend: XLA on the CPU
    returns 8192.004 for 2^13)."""
    qsq_max = (q * q).sum(dim=1).max()
    bound = 2.0 + qsq_max + 2.0 * max_sq
    c = 2.0 ** int(torch.ceil(torch.log2(bound)).item())
    # score = a*(q.x) - u*||x||^2 + c against item column [x, -||x||^2, 1]
    a, u = (2.0, 1.0) if metric == "euclidean" else (1.0, 0.0)
    b = q.shape[0]
    extra = torch.tensor([u, c], dtype=torch.float32, device=q.device).expand(b, 2)
    return torch.cat([a * q, extra], dim=1), c


def _rescore(items: torch.Tensor, sq: torch.Tensor, q: torch.Tensor, idx: torch.Tensor,
             metric: str) -> torch.Tensor:
    """Scores of items ``idx`` [B, k] under the metric, float32 math."""
    s = torch.einsum("bd,bkd->bk", q, items[idx])
    if metric == "euclidean":
        s = 2.0 * s - sq[idx]
    return s


def _topk_impl(items_aug_t, items, sq, queries, *, metric, n_items, max_sq, rounds, k,
               exact_scores, precision):
    q_aug, c_shift = _augment_queries(queries, max_sq, metric)
    if precision == "compensated":
        # [qhi, qhi, qlo] against item rows [hi; lo; hi]: the C and u
        # augmented entries are bf16-exact, so their lo parts are 0 and the
        # shift/bias accumulate exactly once
        qhi, qlo = _bf16_split(q_aug)
        q_aug = torch.cat([qhi, qhi, qlo], dim=1)
    else:
        q_aug = q_aug.to(items_aug_t.dtype)

    packed = fused_stage1(q_aug, items_aug_t)
    vals, cols = peel_rows(packed, rounds)
    # stable sort: ties keep column order, as jax.lax.sort_key_val does
    neg_keys, order = torch.sort(-vals, dim=1, stable=True)
    top_v = -neg_keys[:, :k]
    col = torch.gather(cols, 1, order[:, :k])  # window index
    bits = top_v.view(torch.int32)
    idx = _decode_index(col, bits & LANE_MASK).clamp(max=n_items - 1)
    # pad windows pack to bits in [0, 128); every real score is >= 1.0
    live = bits >= LIVE_BITS
    if exact_scores:
        s = torch.where(live, _rescore(items, sq, queries, idx, metric), NEG)
        s_sorted, pos = torch.sort(s, dim=1, descending=True, stable=True)
        return s_sorted[:, :k], torch.gather(idx, 1, pos[:, :k])
    s = (bits & ~LANE_MASK).view(torch.float32) - c_shift
    return torch.where(live, s, NEG), idx


def _dense_topk(items, sq, queries, *, metric, k):
    """Exact path for tables too small for the windowed kernel: float32
    scores (TF32 off), top-k with ties to the lower index."""
    with full_f32_matmul():
        s = queries @ items.T
    if metric == "euclidean":
        s = 2.0 * s - sq[None, :]
    v, i = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k].to(torch.int32)
