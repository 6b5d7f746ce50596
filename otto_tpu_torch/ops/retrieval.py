"""Top-k retrieval over the item embedding table.

Port of ``otto_tpu/ops/retrieval.py``: :func:`topk_scan`, the exact blocked
scan that serves as the oracle; :func:`build_neighbor_table`, the all-items
kNN table that replaces the reference's per-query ``annoy.get_nns_by_item``
(src/gensim_fasttext/inference.py:40-65); and the reference's other
backends, :func:`topk_hybrid`, :func:`topk_approx` (float32 scores at a
recall target) and :func:`topk_hybrid_int8` over the per-row int8 table of
:func:`quantize_items_int8`.  The reference builds those three on the TPU's
PartialReduce unit (``jax.lax.approx_max_k``); the port gives the same
semantics through its own kernels: the fused stage 1 (float32 or bf16
tables; :class:`~otto_tpu_torch.ops.fused_retrieval.FusedRetriever`) or the
int8 stage 1 (:class:`~otto_tpu_torch.ops.fused_retrieval.Int8Retriever`),
then the window peel and an exact rescoring of the winners.

Metrics:
- ``dot``       score = q . x
- ``euclidean`` rank by -(||q - x||^2), computed as 2 q.x - ||x||^2 (+ const
  per query), matching Annoy's euclidean ordering.

Both return (scores [B, k], indices [B, k]) sorted descending by score, ties
to the lower item index.
"""

from __future__ import annotations

import numpy as np
import torch

from otto_tpu_torch.ops.fused_retrieval import (FusedRetriever, Int8Retriever,
                                                quantize_rows_int8, row_sumsq)
from otto_tpu_torch.utils.runtime import full_f32_matmul, resolve_device

NEG = float(np.float32(-3.4e38))
# the reference's build_neighbor_table searches at topk_hybrid's default
RECALL_TARGET = 0.99


def topk_scan(queries: torch.Tensor, items: torch.Tensor, k: int, block: int = 8192,
              metric: str = "dot"):
    """Exact blocked running-top-k scan in float32 (TF32 off).

    queries: [B, D] float; items: [N, D] float, on one device.  Never holds
    more than a [B, k + block] score block.  Returns (scores [B, k] float32,
    indices [B, k] int32); rows with fewer than k items pad with (NEG, -1).
    """
    q = queries.to(torch.float32)
    items = items.to(torch.float32)
    B = q.shape[0]
    n = items.shape[0]
    dev = q.device
    top_s = torch.full((B, k), NEG, dtype=torch.float32, device=dev)
    top_i = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    with full_f32_matmul():
        for start in range(0, n, block):
            blk = items[start:start + block]
            s = q @ blk.T
            if metric == "euclidean":
                s = 2.0 * s - (blk * blk).sum(dim=1)[None, :]
            idx = torch.arange(start, start + blk.shape[0], dtype=torch.int32, device=dev)
            cat_s = torch.cat([top_s, s], dim=1)
            cat_i = torch.cat([top_i, idx.expand(B, -1)], dim=1)
            # stable: earlier blocks, then lower indices, win ties
            top_s, pos = torch.sort(cat_s, dim=1, descending=True, stable=True)
            top_s = top_s[:, :k]
            top_i = torch.gather(cat_i, 1, pos[:, :k])
    return top_s, top_i


def build_neighbor_table(
    embeddings,
    k: int,
    metric: str = "euclidean",
    exclude_self: bool = True,
    query_batch: int = 4096,
    block: int = 16384,
    scores_out: bool = False,
    exact: bool = False,
    backend: str | None = None,
    *,
    device: str | torch.device,
):
    """All-items kNN table: for every aid, its top-k nearest aids.

    One batched sweep on ``device``; returns int32 [N, k] numpy (+ float32
    scores when requested).  ``exclude_self`` drops the query aid itself
    from its row (the reference skips neighbor 0 — inference.py:167).

    ``backend``, each built once and then searched a query batch at a time:

    - "compensated" (the default): the fused kernels over the hi/lo
      error-compensated bf16 table, ``FusedRetriever(precision=
      "compensated")``: 3(D + 2) bf16 a padded item, plus the float32
      rescoring copy (4 D bytes an item);
    - "pallas" (the reference's name): the fused kernels over a single bf16
      table, (D + 2) bf16 plus the float32 copy;
    - "hybrid" and "approx": float32 scores at a recall target,
      :func:`topk_hybrid`: the table in the embeddings' type, (D + 2)
      float32, or for a torch bf16 tensor 3(D + 2) bf16 (compensated), plus
      the float32 copy;
    - "int8": the per-row int8 table of :func:`quantize_items_int8` through
      :class:`Int8Retriever` (D_pad + 8 bytes a padded item, no float32
      copy: a memory option; its recall against the float32 scan is the
      quantization's).

    "hybrid", "approx" and "int8" search at the reference's recall target,
    0.99 (:func:`~otto_tpu_torch.ops.fused_retrieval.window_rounds`).

    The reference defaults to "hybrid" off a TPU; the port keeps
    "compensated".  ``exact=True`` overrides with the exact blocked scan.
    """
    if backend is None:
        backend = "compensated"
    if backend not in ("compensated", "pallas", "hybrid", "approx", "int8"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    table_dtype = (torch.bfloat16 if isinstance(embeddings, torch.Tensor)
                   and embeddings.dtype == torch.bfloat16 else torch.float32)
    items = torch.as_tensor(embeddings, dtype=torch.float32, device=dev)
    n = items.shape[0]
    fetch = k + 1 if exclude_self else k
    out = np.empty((n, k), np.int32)
    out_s = np.empty((n, k), np.float32) if scores_out else None
    retriever, search = None, {}
    if not exact and backend == "int8":
        retriever = Int8Retriever(*quantize_items_int8(items), metric=metric, device=dev)
        search = {"rounds": min(6, fetch), "recall_target": RECALL_TARGET}
    elif not exact and backend in ("hybrid", "approx"):  # topk_hybrid's route, prepared once
        retriever = hybrid_retriever(items, metric, table_dtype, dev)
        search = {"rounds": min(6, fetch), "exact_scores": True, "recall_target": RECALL_TARGET}
    elif not exact:
        retriever = FusedRetriever(items, metric=metric, precision="single" if backend == "pallas"
                                   else "compensated", device=dev)
    for start in range(0, n, query_batch):
        end = min(start + query_batch, n)
        q = items[start:end]
        if exact:
            s, i = topk_scan(q, items, k=fetch, block=block, metric=metric)
        else:
            s, i = retriever.topk(q, k=fetch, **search)
        s = s.cpu().numpy()
        i = i.cpu().numpy()
        if exclude_self:
            rows = np.arange(start, end)[:, None]
            keep = i != rows
            # at most one self entry per row, so keep has >= k True columns;
            # stable argsort moves them left in original (descending) order
            cols = np.argsort(~keep, axis=1, kind="stable")[:, :k]
            r_idx = np.arange(end - start)[:, None]
            out[start:end] = i[r_idx, cols]
            if scores_out:
                out_s[start:end] = s[r_idx, cols]
        else:
            out[start:end] = i[:, :k]
            if scores_out:
                out_s[start:end] = s[:, :k]
    return (out, out_s) if scores_out else out


def _as_tensor(x) -> torch.Tensor:
    """A tensor as it is (its device and dtype); anything else as a CPU tensor."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def quantize_items_int8(items):
    """Per-row symmetric int8 quantization of the item table: returns
    ``(q8 [N, D] int8, scale [N] float32, sq [N] float32)`` with
    ``x[i] ~ q8[i] * scale[i]`` and ``sq[i] = ||x[i]||^2`` kept exact in
    float32 (for euclidean ranking), on the items' device.  A quarter of a
    float32 table's bytes; the scores run on the int8 tensor cores
    (:class:`Int8Retriever`)."""
    x = _as_tensor(items).to(torch.float32)
    q8, scale = quantize_rows_int8(x)
    return q8, scale, row_sumsq(x)


def topk_hybrid(queries, items, k: int, tile: int = 256, metric: str = "dot",
                recall_target: float = 0.99, rounds: int = 6):
    """Top-k with float32 scores at a recall target (the reference's
    PartialReduce + peel route), on the items' device.

    The table is prepared in the items' type, as the reference's
    ``compute_dt`` follows them (:func:`hybrid_retriever`): float32 items as
    ``FusedRetriever(precision="single", table_dtype=float32)``, stage 1's
    FMA kernel; bf16 items as ``FusedRetriever(precision="compensated")``,
    its wgmma kernels; then the peel and an exact float32 rescoring of the
    winners.  The reference's :func:`topk_hybrid` and :func:`topk_approx`
    differ only in how they aggregate the TPU's PartialReduce output, which
    is not ported, so both run this route.  ``recall_target`` holds the
    route's expected recall
    (:func:`~otto_tpu_torch.ops.fused_retrieval.window_rounds`): the peel
    takes ``min(rounds, k)`` rounds or more, and a table whose windows alone
    would lose more (at k 22, below ~132,500 items) is scored exactly.
    ``tile`` is accepted for the signature's sake: the kernels take the
    whole batch.

    Returns (scores [B, k] float32, indices [B, k] int32), descending.
    """
    items = _as_tensor(items)
    retriever = hybrid_retriever(items, metric, items.dtype, items.device)
    return retriever.topk(queries, k=k, rounds=min(rounds, k), exact_scores=True,
                          recall_target=recall_target)


def hybrid_retriever(items, metric: str, dtype: torch.dtype,
                     device: torch.device) -> FusedRetriever:
    """The table of :func:`topk_hybrid` for items of ``dtype``: float32 (and
    any type but bf16) in single precision as float32; bf16 items
    compensated.  The bf16 values are exact in the hi parts, and the split
    keeps the float32 norms and shift of the augmented columns, which the
    reference adds in float32 (``2 s - sq``); a single bf16 table would
    round ||x||^2 to 8 bits (recall 0.984 against the exact scan at 300,000
    x 32, euclidean, against 0.995 in float32)."""
    if dtype == torch.bfloat16:
        return FusedRetriever(items, metric=metric, precision="compensated", device=device)
    return FusedRetriever(items, metric=metric, table_dtype=torch.float32, precision="single",
                          device=device)


def topk_approx(queries, items, k: int, tile: int = 256, metric: str = "dot",
                recall_target: float = 0.99):
    """The reference's exact-aggregation PartialReduce route: the port runs
    :func:`topk_hybrid` with its default rounds (see there)."""
    return topk_hybrid(queries, items, k, tile=tile, metric=metric,
                       recall_target=recall_target)


def topk_hybrid_int8(queries, q8, scale, sq, k: int, tile: int = 256, metric: str = "dot",
                     recall_target: float = 0.99, rounds: int = 6):
    """Top-k over an int8-quantized item table (from
    :func:`quantize_items_int8`), on its device: the queries quantize per
    row, the int8 stage-1 kernel scores and window-maxes the table, the peel
    (``min(rounds, k)`` rounds, more where ``recall_target`` needs them)
    keeps the survivors, and the k winners are rescored exactly with the
    reference's formula ``f32(q8q . q8) * (qs * scale)`` (then ``2 s - sq``
    for euclidean).  Tables too small for the target take an exact dense
    route over the same scores (:class:`Int8Retriever`, as
    :func:`topk_hybrid`).  ``tile`` is accepted for the signature's sake.

    Returns (scores [B, k] float32, indices [B, k] int32), descending.
    """
    q8 = _as_tensor(q8)
    retriever = Int8Retriever(q8, _as_tensor(scale), _as_tensor(sq), metric=metric,
                              device=q8.device)
    return retriever.topk(queries, k=k, rounds=min(rounds, k), recall_target=recall_target)
