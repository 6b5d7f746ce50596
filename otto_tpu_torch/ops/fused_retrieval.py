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

**The int8 route** (:class:`Int8Retriever`, :func:`fused_stage1_int8`) keeps
the table as per-row int8 with float32 scales (a quarter of a float32
table's bytes) and scores it on the int8 tensor cores into the same packed
window maxima, so stages 2 and 3 run unchanged after it.

Recall: an entry is missed if another top-k entry shares its 128-item window
(stage 1, ~(k-1)*128/N) or if >= R stronger window maxima share its stage-2
window (:func:`expected_window_recall`).  Given a ``recall_target``, the
retrievers' :meth:`topk` raise R or take an exact dense route to meet it
(:func:`window_rounds`).  Use :func:`otto_tpu_torch.ops.retrieval.topk_scan`
when exactness is required.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from otto_tpu_torch.ops import _kernels
from otto_tpu_torch.ops.row_topk import peel_rows
from otto_tpu_torch.utils.profiling import span
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
# tables, and bf16 tables deeper than that, go to the FMA kernel, which
# streams the table in tiles of at most 64 rows and keeps its query tile of
# 16-128 rows in shared memory: 16 float32 rows of DA 2,048 (128 KB) beside
# two float32 table tiles (64 KB) fit a block's 232,448 bytes on an H100.
K1_WGMMA_MAX_DA = 256
K1_WGMMA_DEEP_MAX_DA = 512
K1_FMA_MAX_DA = 2048
# The int8 kernel's contraction: a multiple of 32 (wgmma's k32 step) of
# at most 8 k steps.  Its integer products are exact in float32 (the twin's
# route, and the kernel's conversion of its int32 sums) while 127^2 * D_pad
# < 2^24, which holds to D_pad 256.
K1_INT8_MAX_DPAD = 256


def stage1_route(dtype: torch.dtype, da: int) -> str:
    """The kernel :func:`fused_stage1` launches for a card's operands of
    ``dtype`` and depth ``da``: ``"wgmma"`` (bf16, DA <= 256),
    ``"wgmma_deep"`` (bf16, 256 < DA <= 512) or ``"fma"`` (float32, and bf16
    deeper than 512).  Raises for DA outside 1..2,048 and for other dtypes."""
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
    512; ``fused_stage1.fma_launches``), and raises for DA > 2,048 and for a
    table off a 16-byte boundary (each kernel loads it by TMA); on a CPU
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
    if items_aug_t.data_ptr() % 16:
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


def expected_window_recall(n_items: int, k: int, rounds: int) -> float:
    """Expected recall of the windowed route for a row whose top ``k`` lie at
    random among ``n_items``: stage 1 keeps one item a 128-item window, so
    the j-th best is lost when one of the j - 1 better ones shares its
    window; the peel keeps ``rounds`` windows a 16,384-item chunk, so a chunk
    that holds X of the k loses max(0, X - rounds).  The two losses are
    added, which overstates them a little."""
    if n_items <= 0 or k <= 0:
        return 1.0
    full, tail = divmod(n_items, CHUNK)
    sizes = [(CHUNK, full)] + ([(tail, 1)] if tail else [])
    # a chunk of m items: lanes l < m % 128 hold m // 128 + 1 of them
    pair = sum(count * ((m % WINDOW) * (m // WINDOW + 1) ** 2
                        + (WINDOW - m % WINDOW) * (m // WINDOW) ** 2)
               for m, count in sizes) / n_items**2
    lost = sum(1.0 - (1.0 - pair) ** j for j in range(k))
    for m, count in sizes:
        p = m / n_items
        if p >= 1.0:
            lost += count * max(0, k - rounds)
            continue
        for x in range(rounds + 1, k + 1):  # X ~ Binomial(k, p)
            log_pmf = (math.lgamma(k + 1) - math.lgamma(x + 1) - math.lgamma(k - x + 1)
                       + x * math.log(p) + (k - x) * math.log1p(-p))
            lost += count * (x - rounds) * math.exp(log_pmf)
    return 1.0 - lost / k


def window_rounds(n_items: int, n_pad: int, k: int, rounds: int,
                  recall_target: float | None, block: int = CHUNK) -> int | None:
    """The peel's rounds for a windowed top-k, or None for the exact dense
    route: tables of at most 4 blocks, and k above the survivors' count, go
    dense; with a ``recall_target``, ``rounds`` is raised until
    :func:`expected_window_recall` meets it, and a table whose stage 1
    alone loses more goes dense."""
    if k > rounds * (n_pad // CHUNK) or n_pad <= 4 * block:
        return None
    if recall_target is None:
        return rounds
    if expected_window_recall(n_items, k, max(rounds, k)) < recall_target:
        return None
    while expected_window_recall(n_items, k, rounds) < recall_target:
        rounds += 1
    return rounds


def _int8_keys(acc: torch.Tensor, q_scale: torch.Tensor, item_scale: torch.Tensor,
               item_bias: torch.Tensor, shift: float, metric: str) -> torch.Tensor:
    """The int8 route's selection keys from exact integer sums ``acc`` [B, n]
    (float32): ``acc * (q_scale * item_scale)``, then ``2 s - item_bias`` for
    euclidean, plus the power-of-two ``shift``, each step one float32
    rounding in this order (the kernel's epilogue).  Overwrites ``acc``."""
    key = acc.mul_(q_scale[:, None] * item_scale[None, :])
    if metric == "euclidean":
        key.mul_(2.0).sub_(item_bias[None, :])
    return key.add_(shift)


def _stage1_int8_reference(q8: torch.Tensor, q_scale: torch.Tensor, table8: torch.Tensor,
                           item_scale: torch.Tensor, item_bias: torch.Tensor, *,
                           n_items: int, shift: float, metric: str) -> torch.Tensor:
    """Plain-torch twin of the int8 stage-1 kernel: packed window maxima
    [B, N_pad/128] of the keys of :func:`_int8_keys`, pad items (>= n_items)
    keyed 0.  The integer products run in float32 (TF32 off on the card),
    exact while 127^2 * D_pad < 2^24."""
    b = q8.shape[0]
    n_pad = table8.shape[0]
    q = q8.to(torch.float32)
    out = torch.empty((b, n_pad // WINDOW), dtype=torch.float32, device=q8.device)
    step = max(_REFERENCE_STEP_ELEMS // max(b, 1) // CHUNK, 1) * CHUNK
    with full_f32_matmul():
        for c0 in range(0, n_pad, step):
            c1 = min(c0 + step, n_pad)
            acc = q @ table8[c0:c1].to(torch.float32).T
            key = _int8_keys(acc, q_scale, item_scale[c0:c1], item_bias[c0:c1], shift, metric)
            key[:, max(n_items - c0, 0):] = 0.0
            out[:, c0 // WINDOW:c1 // WINDOW] = _pack_window_max(key)
    return out


def fused_stage1_int8(q8: torch.Tensor, q_scale: torch.Tensor, table8: torch.Tensor,
                      item_scale: torch.Tensor, item_bias: torch.Tensor, *, n_items: int,
                      shift: float, metric: str) -> torch.Tensor:
    """Packed strided-window maxima [B, N_pad/128] float32 of int8 queries
    q8 [B, D_pad] against the int8 table table8 [N_pad, D_pad] (both
    row-major, zero-padded to D_pad, a multiple of 32 up to 256; N_pad a
    multiple of 16384), in K1's layout: item ``c*16384 + a*128 + l`` goes to
    window ``c*128 + l`` with code ``a``.

    An item's key is ``f32(q8 . t8) * (q_scale * item_scale)``, then ``2 s -
    item_bias`` for ``metric="euclidean"`` (``item_bias`` is unread for
    "dot"), plus ``shift``, a power of two that the caller makes large enough
    for every live key to be >= 1.0; items >= ``n_items`` key 0, below
    ``LIVE_BITS``.  ``q_scale`` [B], ``item_scale`` and ``item_bias``
    [N_pad] are float32.

    On a CUDA tensor this launches ``fused_stage1_int8_kernel`` (int8 tensor
    cores; ``csrc/int8_retrieval_kernels.cu``; counted in
    ``fused_stage1_int8.launches``); on a CPU tensor it runs
    :func:`_stage1_int8_reference`.  Raises on other dtypes, shapes and, on
    the card, operands that are not 16-byte aligned."""
    b, d_pad = q8.shape
    n_pad, d_t = table8.shape
    if q8.dtype != torch.int8 or table8.dtype != torch.int8:
        raise TypeError(f"fused_stage1_int8: q8 and table8 must be int8, got {q8.dtype}, "
                        f"{table8.dtype}")
    if any(x.dtype != torch.float32 for x in (q_scale, item_scale, item_bias)):
        raise TypeError("fused_stage1_int8: q_scale, item_scale and item_bias must be float32")
    if (d_t != d_pad or n_pad % CHUNK or tuple(q_scale.shape) != (b,)
            or tuple(item_scale.shape) != (n_pad,) or tuple(item_bias.shape) != (n_pad,)):
        raise ValueError(f"fused_stage1_int8: shapes q8 {tuple(q8.shape)}, table8 "
                         f"{tuple(table8.shape)}, q_scale {tuple(q_scale.shape)}, item_scale "
                         f"{tuple(item_scale.shape)}, item_bias {tuple(item_bias.shape)} "
                         f"(N_pad must be a multiple of {CHUNK})")
    if d_pad % 32 or not 32 <= d_pad <= K1_INT8_MAX_DPAD:
        raise ValueError(f"fused_stage1_int8: D_pad must be a multiple of 32 in 32.."
                         f"{K1_INT8_MAX_DPAD}, got {d_pad}")
    if not 0 <= n_items <= n_pad:
        raise ValueError(f"fused_stage1_int8: n_items {n_items} outside 0..{n_pad}")
    if metric not in ("dot", "euclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    if len({x.device for x in (q8, q_scale, table8, item_scale, item_bias)}) != 1:
        raise ValueError("fused_stage1_int8: operands on different devices")
    if q8.device.type == "cpu":
        return _stage1_int8_reference(q8, q_scale, table8, item_scale, item_bias,
                                      n_items=n_items, shift=shift, metric=metric)
    if q8.device.type != "cuda":
        raise ValueError(f"fused_stage1_int8: no kernel for device {q8.device}")
    if n_pad // CHUNK > 65535 or -(-b // 128) > 2**31 - 1:
        raise ValueError(f"fused_stage1_int8: [{b} x {n_pad}] exceeds the kernel's grid")
    ops = tuple(x.contiguous() for x in (q8, q_scale, table8, item_scale, item_bias))
    if any(x.data_ptr() % 16 for x in ops):
        raise ValueError("fused_stage1_int8: every operand must start on a 16-byte boundary")
    out = torch.empty((b, n_pad // WINDOW), dtype=torch.float32, device=q8.device)
    if b:
        _kernels.launch_fused_stage1_int8(*ops, out, n_items=n_items, shift=shift,
                                          euclidean=metric == "euclidean")
        fused_stage1_int8.launches += 1
    return out


fused_stage1_int8.launches = 0  # launches of the int8 kernel made by this wrapper


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
    (bf16 by default); exact scores come from a copy of the items in
    ``rescore_dtype`` (float32 by default; bf16 halves it), upcast to
    float32 for the products.

    ``precision="compensated"`` stores an error-compensated bf16 split of the
    augmented table: item columns ``[hi(x); lo(x); hi(x)]`` scored against
    query rows ``[qhi, qhi, qlo]``, so the product accumulates
    ``qhi·hi + qhi·lo + qlo·hi ≈ q·x`` to ~2^-17 relative error from bf16
    inputs.  The contraction grows from D+2 to 3(D+2).

    ``block`` is a multiple of 16384; it sets only the dense-fallback rule
    of :meth:`topk` (tables of at most 4 blocks are scored densely).
    """

    def __init__(self, items, metric: str = "dot", block: int = CHUNK,
                 table_dtype: torch.dtype = torch.bfloat16,
                 rescore_dtype: torch.dtype = torch.float32, precision: str = "single",
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
        with span("otto::retrieval.build"):
            self.device = resolve_device(device)
            itf = torch.as_tensor(items, dtype=torch.float32, device=self.device)
            self.n_items, self.dim = itf.shape
            self.metric = metric
            self.block = block
            self.precision = precision
            n_pad = (-self.n_items) % block

            sq = (itf * itf).sum(dim=1)
            self.max_sq = float(sq.max())
            self.items = itf.to(rescore_dtype)  # [N, D], for rescoring
            self.sq = sq      # [N] float32
            ones = torch.ones((self.n_items, 1), dtype=torch.float32, device=self.device)
            aug = torch.cat([itf, -sq[:, None], ones], dim=1)  # rows [x, -||x||^2, 1]
            if precision == "compensated":
                hi, lo = _bf16_split(aug)
                table = torch.cat([hi, lo, hi], dim=1)  # [N, 3(D+2)] bf16
            else:
                table = aug.to(table_dtype)
            self.items_aug_t = torch.nn.functional.pad(table.T, (0, n_pad)).contiguous()

    def topk(self, queries, k: int, rounds: int = 6, exact_scores: bool = False,
             rescore_survivors: bool = False, recall_target: float | None = None):
        """queries [B, D] -> (scores [B, k] float32, indices [B, k] int32),
        descending.

        Scores decode from the packed keys (relative error <= 2^-17 of the
        shifted score — the 7 lane bits); ``exact_scores=True`` re-gathers the
        winning items and rescores them in float32.  ``rescore_survivors=True``
        instead rescores every stage-2 survivor (rounds * N_pad/16384 a row)
        from the ``rescore_dtype`` copy in float32 and keeps the k best, so the
        table's type only picks the survivor pool.  A ``recall_target`` makes
        ``rounds`` a floor (:func:`window_rounds`).
        """
        with span("otto::retrieval.topk"):
            q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
            n_pad = self.items_aug_t.shape[1]
            rounds = window_rounds(self.n_items, n_pad, k, rounds, recall_target, self.block)
            if rounds is None:
                return _dense_topk(self.items, self.sq, q, metric=self.metric,
                                   k=min(k, self.n_items))
            return _topk_impl(self.items_aug_t, self.items, self.sq, q, metric=self.metric,
                              n_items=self.n_items, max_sq=self.max_sq, rounds=rounds, k=k,
                              exact_scores=exact_scores, rescore_survivors=rescore_survivors,
                              precision=self.precision)


def quantize_rows_int8(x: torch.Tensor):
    """Per-row symmetric int8 quantization of float32 rows [R, D]: returns
    (q8 [R, D] int8, scale [R] float32) with ``x ~ q8 * scale``: the scale is
    max(max |x|, 1e-30) / 127, each value divided by it, rounded half to
    even and clipped to +-127 (``otto_tpu/ops/retrieval.py:256-258, 288-289``).
    The divisor 127 is a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its rounded reciprocal, an ulp off the quotient at times."""
    top = torch.clamp(x.abs().amax(dim=1), min=1e-30)
    scale = top / torch.full_like(top, 127.0)
    q8 = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q8, scale


def row_sumsq(x: torch.Tensor) -> torch.Tensor:
    """||x||^2 of float32 rows [R, D], the d-th square added in ascending d:
    the same bits on the card and on the CPU (a library reduction sums in an
    order of its own on each), and XLA's on the CPU for rows of up to 32."""
    s = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for d in range(x.shape[1]):
        s = s + x[:, d] * x[:, d]
    return s


class Int8Retriever:
    """Prepared per-row int8 item table + windowed top-k on the int8 tensor
    cores (the port's route for the reference's ``topk_hybrid_int8``).

    ``q8`` [N, D] int8, ``scale`` [N] and ``sq`` [N] float32, as
    ``otto_tpu_torch.ops.retrieval.quantize_items_int8`` returns them, moved
    to ``device``.  The table is kept zero-padded to [N_pad, D_pad] (N_pad a
    multiple of ``block``, D_pad of 32; zeros add nothing to an integer
    dot), with the scales and norms padded alike: N_pad * (D_pad + 8) bytes
    and no float32 copy of the table.  ``metric``: "dot" (score f32(q8 .
    x8) * (qs * scale)) or "euclidean" (2 s - sq).

    :meth:`topk` quantizes the queries per row, runs :func:`fused_stage1_int8`,
    the peel, the decode, and rescores the k winners exactly from the int8
    table with the reference's float32 formula.  Where :func:`window_rounds`
    says so it takes an exact dense route over the quantized scores, as
    :meth:`FusedRetriever.topk` does.
    """

    def __init__(self, q8, scale, sq, metric: str = "dot", block: int = CHUNK, *,
                 device: str | torch.device):
        if block % CHUNK:
            raise ValueError("block must be a multiple of 128*128")
        if metric not in ("dot", "euclidean"):
            raise ValueError(f"unknown metric {metric!r}")
        self.device = resolve_device(device)
        q8 = torch.as_tensor(q8, device=self.device)
        if q8.dtype != torch.int8 or q8.dim() != 2:
            raise TypeError(f"Int8Retriever: q8 must be [N, D] int8, got {q8.dtype} "
                            f"{tuple(q8.shape)}")
        self.n_items, self.dim = q8.shape
        self.metric = metric
        self.block = block
        n_pad = -(-self.n_items // block) * block
        d_pad = -(-self.dim // 32) * 32
        self.table8 = torch.zeros((n_pad, d_pad), dtype=torch.int8, device=self.device)
        self.table8[:self.n_items, :self.dim] = q8
        self.item_scale = torch.zeros(n_pad, dtype=torch.float32, device=self.device)
        self.item_scale[:self.n_items] = torch.as_tensor(scale, dtype=torch.float32,
                                                         device=self.device)
        self.item_bias = torch.zeros(n_pad, dtype=torch.float32, device=self.device)
        self.item_bias[:self.n_items] = torch.as_tensor(sq, dtype=torch.float32,
                                                        device=self.device)
        # views of the unpadded table, scales and norms, for rescoring
        self.q8 = self.table8[:self.n_items, :self.dim]
        self.scale = self.item_scale[:self.n_items]
        self.sq = self.item_bias[:self.n_items]
        # the largest dequantized norm ||q8 * scale|| and ||x||^2, for the shift
        norms = self.q8.to(torch.float64).square().sum(dim=1).sqrt() * self.scale
        self.max_norm = float(norms.max()) if self.n_items else 0.0
        self.max_sq = float(self.sq.max()) if self.n_items else 0.0

    def _shift(self, q8q: torch.Tensor, qs: torch.Tensor) -> float:
        """A power of two C with every live key >= 1: by Cauchy-Schwarz a
        score is at most ||q^|| ||x^|| in magnitude (the dequantized rows),
        2 ||q^|| ||x^|| + max ||x||^2 for euclidean's 2 s - sq, and 2^-10 of
        slack covers the float32 roundings."""
        qn = float((q8q.to(torch.float64).square().sum(dim=1).sqrt() * qs).max())
        mag = qn * self.max_norm
        if self.metric == "euclidean":
            mag = 2.0 * mag + self.max_sq
        return 2.0 ** math.ceil(math.log2((2.0 + mag) * (1.0 + 2.0**-10)))

    def _scores(self, acc: torch.Tensor, qs: torch.Tensor, scale: torch.Tensor,
                sq: torch.Tensor) -> torch.Tensor:
        """The reference's float32 scores from exact integer sums ``acc``:
        f32(acc) * (qs * scale), then 2 s - sq for euclidean."""
        s = acc * (qs[:, None] * scale)
        return 2.0 * s - sq if self.metric == "euclidean" else s

    def _rescore(self, q8q: torch.Tensor, qs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Scores of items ``idx`` [B, k]: integer dots, then :meth:`_scores`."""
        acc = (q8q[:, None, :].to(torch.int32) * self.q8[idx].to(torch.int32)).sum(dim=2)
        return self._scores(acc.to(torch.float32), qs, self.scale[idx], self.sq[idx])

    def _dense_topk(self, q8q: torch.Tensor, qs: torch.Tensor, k: int):
        """Exact top-k over the quantized scores (TF32 off: the integer
        products are exact in float32), ties to the lower index."""
        table = self.q8.to(torch.float32)

        def scores(rows):
            with full_f32_matmul():
                acc = q8q[rows].to(torch.float32) @ table.T
            return self._scores(acc, qs[rows], self.scale[None, :], self.sq[None, :])

        return _sorted_topk(scores, q8q.shape[0], self.n_items, k)

    def topk(self, queries, k: int, rounds: int = 6, recall_target: float | None = None):
        """queries [B, D] float -> (scores [B, k] float32, indices [B, k]
        int32), descending by the quantized score.  A ``recall_target`` makes
        ``rounds`` a floor (:func:`window_rounds`)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        q8q, qs = quantize_rows_int8(q)
        n_pad, d_pad = self.table8.shape
        rounds = window_rounds(self.n_items, n_pad, k, rounds, recall_target, self.block)
        if rounds is None:
            return self._dense_topk(q8q, qs, min(k, self.n_items))
        packed = fused_stage1_int8(
            torch.nn.functional.pad(q8q, (0, d_pad - self.dim)), qs, self.table8,
            self.item_scale, self.item_bias, n_items=self.n_items,
            shift=self._shift(q8q, qs), metric=self.metric)
        _, idx, live = _survivors(packed, rounds, k, self.n_items)
        s = torch.where(live, self._rescore(q8q, qs, idx), NEG)
        s_sorted, pos = torch.sort(s, dim=1, descending=True, stable=True)
        return s_sorted[:, :k], torch.gather(idx, 1, pos[:, :k])


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
    s = torch.einsum("bd,bkd->bk", q, items[idx].to(torch.float32))
    if metric == "euclidean":
        s = 2.0 * s - sq[idx]
    return s


def _survivors(packed: torch.Tensor, rounds: int, k: int, n_items: int):
    """Stages 2 and 3 on packed window maxima: the peel, a stable sort of the
    survivors by packed key (ties in column order, as
    ``jax.lax.sort_key_val``), then the decode of the best ``k``.  Returns (packed bits int32, item indices, live mask),
    [B, k] each; pad windows pack below ``LIVE_BITS`` and are not live."""
    vals, cols = peel_rows(packed, rounds)
    neg_keys, order = torch.sort(-vals, dim=1, stable=True)
    top_v = -neg_keys[:, :k]
    col = torch.gather(cols, 1, order[:, :k])  # window index
    bits = top_v.view(torch.int32)
    idx = _decode_index(col, bits & LANE_MASK).clamp(max=n_items - 1)
    return bits, idx, bits >= LIVE_BITS


def _topk_impl(items_aug_t, items, sq, queries, *, metric, n_items, max_sq, rounds, k,
               exact_scores, rescore_survivors, precision):
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
    if rescore_survivors:
        # every survivor, in column order, rescored; a stable sort of the
        # negated scores keeps ties in that order, as the reference's
        # sort_key_val does
        vals, cols = peel_rows(packed, rounds)
        bits_all = vals.view(torch.int32)
        idx_all = _decode_index(cols, bits_all & LANE_MASK).clamp(max=n_items - 1)
        s_all = torch.where(bits_all >= LIVE_BITS,
                            _rescore(items, sq, queries, idx_all, metric), NEG)
        neg_s, order = torch.sort(-s_all, dim=1, stable=True)
        return -neg_s[:, :k], torch.gather(idx_all, 1, order[:, :k])
    bits, idx, live = _survivors(packed, rounds, k, n_items)
    if exact_scores:
        s = torch.where(live, _rescore(items, sq, queries, idx, metric), NEG)
        s_sorted, pos = torch.sort(s, dim=1, descending=True, stable=True)
        return s_sorted[:, :k], torch.gather(idx, 1, pos[:, :k])
    s = (bits & ~LANE_MASK).view(torch.float32) - c_shift
    return torch.where(live, s, NEG), idx


def _sorted_topk(scores, b: int, n: int, k: int):
    """Top-k of the [rows, n] blocks ``scores(rows)`` over b query rows,
    ties to the lower index, a block of at most 2^28 scores at a time."""
    step = max(_REFERENCE_STEP_ELEMS // max(n, 1), 1)
    vals, ids = [], []
    for r0 in range(0, max(b, 1), step):
        v, i = torch.sort(scores(slice(r0, r0 + step)), dim=1, descending=True, stable=True)
        vals.append(v[:, :k])
        ids.append(i[:, :k].to(torch.int32))
    return torch.cat(vals), torch.cat(ids)


def _dense_topk(items, sq, queries, *, metric, k):
    """Exact path for tables the windowed route does not suit: float32
    scores (TF32 off), top-k with ties to the lower index."""
    table = items.to(torch.float32)

    def scores(rows):
        with full_f32_matmul():
            s = queries[rows] @ table.T
        return 2.0 * s - sq[None, :] if metric == "euclidean" else s

    return _sorted_topk(scores, queries.shape[0], items.shape[0], k)
