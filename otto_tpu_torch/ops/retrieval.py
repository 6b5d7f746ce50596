"""Top-k retrieval over the item embedding table.

Port of ``otto_tpu/ops/retrieval.py:38-175``: :func:`topk_scan`, the exact
blocked scan that serves as the oracle, and :func:`build_neighbor_table`, the
all-items kNN table that replaces the reference's per-query
``annoy.get_nns_by_item`` (src/gensim_fasttext/inference.py:40-65).

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

from otto_tpu_torch.utils.runtime import full_f32_matmul, resolve_device

NEG = float(np.float32(-3.4e38))


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

    ``backend``: "compensated" (the default: the fused kernels over the
    hi/lo error-compensated bf16 table, see
    ``FusedRetriever(precision="compensated")``) or "pallas" (the fused
    kernels over a single bf16 table; the name is the reference's).
    ``exact=True`` overrides with the exact blocked scan.  The reference's
    "hybrid", "approx" and "int8" backends are built on the TPU's
    PartialReduce unit (``jax.lax.approx_max_k``) and are not ported.
    """
    if backend is None:
        backend = "compensated"
    if backend in ("hybrid", "approx", "int8"):
        raise ValueError(
            f"backend {backend!r} runs on the TPU's PartialReduce unit and is not "
            "ported (ROADMAP M11); use 'compensated', 'pallas' or exact=True")
    if backend not in ("compensated", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    items = torch.as_tensor(embeddings, dtype=torch.float32, device=dev)
    n = items.shape[0]
    fetch = k + 1 if exclude_self else k
    out = np.empty((n, k), np.int32)
    out_s = np.empty((n, k), np.float32) if scores_out else None
    retriever = None
    if not exact:
        from otto_tpu_torch.ops.fused_retrieval import FusedRetriever

        retriever = FusedRetriever(
            items, metric=metric,
            precision="compensated" if backend == "compensated" else "single",
            device=dev,
        )
    for start in range(0, n, query_batch):
        end = min(start + query_batch, n)
        q = items[start:end]
        if exact:
            s, i = topk_scan(q, items, k=fetch, block=block, metric=metric)
        else:
            s, i = retriever.topk(q, k=fetch)
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
