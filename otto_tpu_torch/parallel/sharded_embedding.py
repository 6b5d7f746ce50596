"""Row-sharded embedding tables: the collective lookup, the distributed
top-k, and the table-sharded SGNS and MF training steps.

Port of ``otto_tpu/parallel/sharded_embedding.py``.  A table's rows split in
blocks over the mesh's ``model`` axis (:func:`otto_tpu_torch.parallel.mesh.
shard_rows`); every function here takes this rank's block and returns what
the JAX function returns to its single controller, whole on every rank.
Batches are the whole batch on every rank; each rank takes its ``data``
slice.

- :func:`sharded_lookup`: masked local gather, summed over ``model``.
- :class:`ShardedRetriever` and :func:`sharded_topk`: a local top-k a shard
  (a dense product under :data:`HYBRID_MIN_SHARD_ROWS` rows; from there the
  fused retrieval kernels K1 and K2 through :meth:`~otto_tpu_torch.ops.
  fused_retrieval.FusedRetriever.topk`, compensated, where the JAX package
  takes ``topk_hybrid`` on ``approx_max_k``), then the ``k`` best of every
  shard's ``k``.
- :func:`make_sharded_sgns_step`: dense adagrad a shard, the gradient summed
  over ``data`` once.  The JAX step sums it twice when ``data`` has more
  than one device (its ``value_and_grad`` already sums the data-varying loss
  over ``data``, then an explicit ``psum`` sums again), so its accumulators
  come out dp^2 times too large; this port keeps the single-device
  semantics.
- :func:`make_sharded_mf_step`: the sparse, batch-complete adagrad of
  :func:`otto_tpu_torch.models.matrix_factorization.sparse_step`, with the
  batch's gradient rows gathered over ``data`` and each shard applying the
  rows it owns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from otto_tpu_torch.ops.fused_retrieval import CHUNK, FusedRetriever, _dense_topk
from otto_tpu_torch.parallel.mesh import (
    all_gather,
    all_reduce_sum,
    axis_index,
    axis_size,
    data_slice,
)

# shard-row threshold from which the local top-k runs the fused kernels
# instead of a dense [B, N_local] product and sort
HYBRID_MIN_SHARD_ROWS = 1 << 16
# K2's rounds on the fused route (FusedRetriever.topk's default), raised
# where a shard has too few 16,384-item chunks to yield k survivors
FUSED_ROUNDS = 6


def _owned(mesh, idx: torch.Tensor, rows_per: int, model_axis: str):
    """(local row, owned) of global row ids ``idx`` on this rank's block."""
    li = idx.long() - axis_index(mesh, model_axis) * rows_per
    owned = (li >= 0) & (li < rows_per)
    return li.clamp(0, rows_per - 1), owned


def sharded_lookup(mesh, table: torch.Tensor, indices, model_axis: str = "model"):
    """Rows ``indices`` [B] of a row-sharded table (this rank's block
    ``table`` [rows_per, D]): [B, D] on every rank."""
    idx = torch.as_tensor(indices, device=table.device)
    safe, owned = _owned(mesh, idx, table.shape[0], model_axis)
    rows = torch.where(owned[..., None], table[safe], torch.zeros((), dtype=table.dtype,
                                                                  device=table.device))
    return all_reduce_sum(mesh, rows.contiguous(), model_axis)


class ShardedRetriever:
    """This rank's block ``items`` [rows_per, D] of a row-sharded table,
    prepared once for :meth:`topk`: from :data:`HYBRID_MIN_SHARD_ROWS` rows a
    compensated :class:`FusedRetriever` (K1 and K2 on the card), below them
    the float32 rows and their squared norms for a dense search.  Pad rows
    of the block are items (zero vectors), as in the JAX package."""

    def __init__(self, mesh, items: torch.Tensor, metric: str = "dot",
                 model_axis: str = "model"):
        if metric not in ("dot", "euclidean"):
            raise ValueError(f"unknown metric {metric!r}")
        self.mesh, self.metric, self.model_axis = mesh, metric, model_axis
        self.items = items.to(torch.float32)
        self.rows_per = self.items.shape[0]
        self.fused = None
        if self.rows_per >= HYBRID_MIN_SHARD_ROWS:
            self.fused = FusedRetriever(self.items, metric=metric, precision="compensated",
                                        device=self.items.device)
        else:
            self.sq = (self.items * self.items).sum(dim=1)

    def local_topk(self, q: torch.Tensor, k: int):
        """(scores, local row ids) [B, k] of this block alone; on the fused
        route K2 takes enough rounds to yield ``k`` survivors."""
        if self.fused is None:
            return _dense_topk(self.items, self.sq, q, metric=self.metric, k=k)
        n_chunks = self.fused.items_aug_t.shape[1] // CHUNK
        return self.fused.topk(q, k, rounds=max(FUSED_ROUNDS, -(-k // n_chunks)),
                               exact_scores=True)

    def topk(self, queries, k: int):
        """Queries [B, D] (the same on every rank) -> (scores [B, k]
        float32, global row ids [B, k] int32), descending, ties to the lower
        id, on every rank: each block's ``k`` best, gathered over ``model``,
        then the ``k`` best of them."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.items.device)
        loc_s, loc_i = self.local_topk(q, k)
        glob_i = loc_i.to(torch.int32) + axis_index(self.mesh, self.model_axis) * self.rows_per
        all_s = torch.cat(all_gather(self.mesh, loc_s.contiguous(), self.model_axis), dim=1)
        all_i = torch.cat(all_gather(self.mesh, glob_i.contiguous(), self.model_axis), dim=1)
        best_s, pos = torch.sort(all_s, dim=1, descending=True, stable=True)
        return best_s[:, :k], torch.gather(all_i, 1, pos[:, :k])


def sharded_topk(mesh, queries, items: torch.Tensor, k: int, model_axis: str = "model",
                 metric: str = "dot"):
    """Distributed top-k of queries [B, D] against a row-sharded table (this
    rank's block ``items``): :meth:`ShardedRetriever.topk` of a retriever
    built for this one call.  A table served more than once keeps its
    :class:`ShardedRetriever`."""
    return ShardedRetriever(mesh, items, metric, model_axis).topk(queries, k)


def _batch_part(mesh, data_axis: str, dev, *cols):
    """This rank's ``data`` slice of each batch column, on ``dev``."""
    B = cols[0].shape[0]
    dp = axis_size(mesh, data_axis)
    if B % dp:
        raise ValueError(f"batch of {B} does not split over {dp} data ranks")
    sl, _ = data_slice(mesh, B, data_axis)
    return [torch.as_tensor(c, device=dev)[sl] for c in cols]


def make_sharded_sgns_step(mesh, n_negatives: int, data_axis: str = "data",
                           model_axis: str = "model"):
    """SGNS step over a mesh: the batch split over ``data``, the four tables
    row-sharded over ``model`` (this rank's blocks, updated in place).

    ``step(w_in, w_out, acc_in, acc_out, centers, contexts, negatives, lr)``
    returns ``(w_in, w_out, acc_in, acc_out, loss)``, loss the batch's summed
    loss (a 0-d tensor).  The update is dense a shard, as the JAX step's:
    each touched row's gradient is summed over the whole batch first, so
    ``acc += g^2`` takes the square of the sum, then ``w -= lr * g /
    sqrt(acc + 1e-10)``; rows with no gradient keep their values.  The
    gradient is summed over ``data`` once, the single-device semantics.
    :func:`otto_tpu_torch.models.embeddings.sgns_step` differs in two ways:
    it returns the loss's batch mean, and it adds each occurrence's square
    (sparse); on a batch whose center rows and whose context and negative
    rows are distinct, both give the same tables."""

    def step(w_in, w_out, acc_in, acc_out, centers, contexts, negatives, lr):
        dev = w_in.device
        c, x, negs = _batch_part(mesh, data_axis, dev, centers, contexts, negatives)
        if negs.shape[1] != n_negatives:
            raise ValueError(f"negatives [B, {negs.shape[1]}], step made for {n_negatives}")
        b, D = c.shape[0], w_in.shape[1]
        c_rows = sharded_lookup(mesh, w_in, c, model_axis)
        pos_rows = sharded_lookup(mesh, w_out, x, model_axis)
        neg_rows = sharded_lookup(mesh, w_out, negs.reshape(-1), model_axis).reshape(b, -1, D)
        pos_logit = (c_rows * pos_rows).sum(dim=1)
        neg_logit = torch.einsum("bd,bnd->bn", c_rows, neg_rows)
        loss = (-F.logsigmoid(pos_logit)).sum() + (-F.logsigmoid(-neg_logit)).sum()
        g_pos = torch.sigmoid(pos_logit) - 1.0
        g_neg = torch.sigmoid(neg_logit)
        g_c = g_pos[:, None] * pos_rows + torch.einsum("bn,bnd->bd", g_neg, neg_rows)
        g_ctx = g_pos[:, None] * c_rows
        g_negrows = (g_neg[:, :, None] * c_rows[:, None, :]).reshape(-1, D)
        g_in = _dense_grad(mesh, w_in, [(c, g_c)], model_axis)
        g_out = _dense_grad(mesh, w_out, [(x, g_ctx), (negs.reshape(-1), g_negrows)],
                            model_axis)
        all_reduce_sum(mesh, g_in, data_axis)
        all_reduce_sum(mesh, g_out, data_axis)
        all_reduce_sum(mesh, loss, data_axis)
        for w, acc, g in ((w_in, acc_in, g_in), (w_out, acc_out, g_out)):
            acc.add_(g * g)
            w.sub_(lr * g * torch.rsqrt(acc + 1e-10))
        return w_in, w_out, acc_in, acc_out, loss

    return step


def _dense_grad(mesh, table: torch.Tensor, updates, model_axis: str) -> torch.Tensor:
    """The gradient of this rank's block: each ``(idx, g)`` row it owns
    added in."""
    grad = torch.zeros_like(table)
    for idx, g in updates:
        li, owned = _owned(mesh, idx, table.shape[0], model_axis)
        grad.index_add_(0, li[owned], g[owned])
    return grad


def make_sharded_mf_step(mesh, loss: str = "mse", data_axis: str = "data",
                         model_axis: str = "model"):
    """Matrix-factorization step over a mesh: the batch split over ``data``,
    the session table [Ns, D] and the aid table [Na, D] row-sharded over
    ``model`` (this rank's blocks, updated in place with their
    accumulators).

    ``step(ses, aid, acc_s, acc_a, s_idx, a_idx, y, lr)`` returns ``(ses,
    aid, acc_s, acc_a, loss)``, the loss the batch mean.  Each data slice
    computes the closed-form row gradients of the mean loss (MSE: ``2 (l -
    y) / B``; BCE: ``(sigmoid(l) - y) / B``); the gradient rows and their
    ids are gathered over ``data`` (batch-sized traffic), and each model
    shard adds every owned occurrence's square into its accumulator, then
    every owned update scaled by the batch-complete accumulator: the
    semantics of ``sparse_step``."""
    if loss not in ("mse", "bce"):
        raise ValueError(loss)

    def step(ses_t, aid_t, acc_s, acc_a, s_idx, a_idx, y, lr):
        dev = ses_t.device
        si, ai, yy = _batch_part(mesh, data_axis, dev, s_idx, a_idx, y)
        e1 = sharded_lookup(mesh, ses_t, si, model_axis)
        e2 = sharded_lookup(mesh, aid_t, ai, model_axis)
        logits = (e1 * e2).sum(dim=-1)
        B_total = yy.shape[0] * axis_size(mesh, data_axis)
        if loss == "bce":
            per = -(yy * F.logsigmoid(logits) + (1 - yy) * F.logsigmoid(-logits))
            dl = (torch.sigmoid(logits) - yy) / B_total
        else:
            per = (logits - yy) ** 2
            dl = 2.0 * (logits - yy) / B_total
        value = all_reduce_sum(mesh, per.sum(), data_axis) / B_total
        g1 = dl[:, None] * e2
        g2 = dl[:, None] * e1
        for table, acc, idx, g in ((ses_t, acc_s, si, g1), (aid_t, acc_a, ai, g2)):
            idx_all = torch.cat(all_gather(mesh, idx.contiguous(), data_axis))
            g_all = torch.cat(all_gather(mesh, g.contiguous(), data_axis))
            li, owned = _owned(mesh, idx_all, table.shape[0], model_axis)
            li, g_all = li[owned], g_all[owned]
            acc.index_add_(0, li, g_all * g_all)
            table.index_add_(0, li, -lr * g_all * torch.rsqrt(acc[li] + 1e-10))
        return ses_t, aid_t, acc_s, acc_a, value

    return step


__all__ = ["HYBRID_MIN_SHARD_ROWS", "ShardedRetriever", "sharded_lookup", "sharded_topk",
           "make_sharded_sgns_step", "make_sharded_mf_step"]
