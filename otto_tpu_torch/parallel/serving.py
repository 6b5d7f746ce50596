"""Sharded serving: the candidate generator and the covisitation heuristic
over a ``data x model`` mesh.

Port of ``otto_tpu/parallel/serving.py``.  Sessions split over ``data``;
the covisitation neighbor tables and the kNN table split row-wise over
``model``: at OTTO scale the wide tables are ~1.86M x 100 int32, about 740
MB each, the serving state worth sharding.  A rank scores its ``data``
slice of each chunk with the port's single-device functions
(:func:`otto_tpu_torch.models.candidates._regular_chunk`,
:func:`otto_tpu_torch.models.covisitation._covisit_route` and
``_recency_route``), whose only change is the neighbor gather: the owning
shard contributes ``row + 1`` and the others 0, summed over ``model``
(:func:`_gather_rows`).  The slices are then gathered over ``data``, so
every rank returns the whole chunk, equal to the single-device result bit
for bit.  The per-session work repeats across ``model``; the table memory
is what scales down as 1/|model|.  The entry points
(``regular_candidates``, ``covisit_heuristic_predictions``) run one path
with or without a mesh through :class:`ServingLayout`.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES
from otto_tpu_torch.ops.multiset import gather_neighbors
from otto_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_sum,
    axis_index,
    axis_size,
    data_slice,
    gather_batch,
    mesh_device,
    pad_rows_to,
    rank_device,
    shard_rows,
)
from otto_tpu_torch.utils.runtime import resolve_device

CANDGEN_TABLE_KINDS = ("time_weighted", "click_weighted", "cart_weighted",
                       "click_cart", "cart_order")


def _gather_rows(mesh, table_shard: torch.Tensor, queries: torch.Tensor,
                 model_axis: str = "model") -> torch.Tensor:
    """Neighbor rows of a row-sharded int32 table (-1 padded): queries
    [S, U] (the same on every rank of a ``model`` group), this rank's block
    [rows_per, K].  Returns [S, U*K] as ``gather_neighbors`` does: the owning
    shard contributes ``row + 1``, the others 0, so after the sum the -1 of
    padding queries and of empty table slots survives."""
    rows_per = table_shard.shape[0]
    li = queries.long() - axis_index(mesh, model_axis) * rows_per
    owned = (li >= 0) & (li < rows_per) & (queries >= 0)
    rows = table_shard[li.clamp(0, rows_per - 1)] + 1
    rows = torch.where(owned[:, :, None], rows, 0).contiguous()
    rows = all_reduce_sum(mesh, rows, model_axis) - 1
    S, U = queries.shape
    return rows.reshape(S, U * table_shard.shape[1])


def pad_table_rows(table: np.ndarray, parts: int) -> np.ndarray:
    """Pad a [n_aids, K] table to a row multiple of ``parts`` with -1 rows."""
    n = table.shape[0]
    n_pad = (-n) % parts
    if n_pad == 0:
        return table
    return np.concatenate([table, np.full((n_pad, table.shape[1]), -1, table.dtype)])


def _over_data(mesh, data_axis: str, local_fn, aids, types, lengths, *args, **kwargs):
    """Run ``local_fn`` on this rank's ``data`` slice of a chunk (padded to
    a multiple of the axis size by repeating its first session) and gather
    its per-type outputs (tensors or tuples of them) over ``data``."""
    n = aids.shape[0]
    sl, n_pad = data_slice(mesh, n, data_axis)
    out = local_fn(*(pad_rows_to(x, n_pad)[sl] for x in (aids, types, lengths)), *args,
                   **kwargs)

    def whole(x):
        return gather_batch(mesh, x.contiguous(), n, data_axis)

    return {e: tuple(whole(x) for x in v) if isinstance(v, tuple) else whole(v)
            for e, v in out.items()}


class ServingLayout:
    """Where a serving call runs: one device (``mesh`` None), or this rank's
    part of a ``data x model`` mesh.  The serving entry points run one path
    through it; the two differ only in how a neighbor table is placed
    (:meth:`table`), how its rows are read (:meth:`gather`), and how a
    chunk's sessions split (:meth:`chunk`, :meth:`over_data`,
    :meth:`host_rows`)."""

    def __init__(self, mesh=None, device=None, data_axis: str = "data",
                 model_axis: str = "model"):
        self.mesh, self.data_axis, self.model_axis = mesh, data_axis, model_axis
        self.device = resolve_device(device) if mesh is None else rank_device(mesh, device)

    def chunk(self, chunk_sessions: int) -> int:
        """``chunk_sessions`` rounded up to a multiple of the ``data`` size."""
        if self.mesh is None:
            return chunk_sessions
        dsize = axis_size(self.mesh, self.data_axis)
        return -(-chunk_sessions // dsize) * dsize

    def table(self, array: np.ndarray) -> torch.Tensor:
        """A neighbor table as this rank holds it: whole on one device; on a
        mesh, its block of the rows padded by :func:`pad_table_rows`."""
        if self.mesh is None:
            return torch.as_tensor(np.ascontiguousarray(array), device=self.device)
        parts = axis_size(self.mesh, self.model_axis)
        return shard_rows(self.mesh, pad_table_rows(array, parts), self.model_axis)

    def gather(self, table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        """Neighbor rows of a table placed by :meth:`table`."""
        if self.mesh is None:
            return gather_neighbors(table, queries)
        return _gather_rows(self.mesh, table, queries, self.model_axis)

    def over_data(self, local_fn):
        """``local_fn(aids, types, lengths, ...)`` over a whole chunk: on a
        mesh each rank runs its ``data`` slice and the slices are
        gathered."""
        if self.mesh is None:
            return local_fn
        return partial(_over_data, self.mesh, self.data_axis, local_fn)

    def host_rows(self, idx: np.ndarray, fn, k: int) -> dict:
        """A host route ``fn(idx)`` (per type, int32 [len(idx), k]); on a
        mesh each rank runs its ``data`` part (:func:`host_rows_over_data`)."""
        if self.mesh is None:
            return fn(idx)
        return host_rows_over_data(self.mesh, idx, fn, k, self.data_axis)


def make_sharded_regular_chunk(mesh, uniq_cap: int, wide_k: int, k_covisit: int, with_ft: bool,
                               vote_cap: int = 32, data_axis: str = "data",
                               model_axis: str = "model"):
    """``_regular_chunk`` over ``mesh`` in the JAX package's calling
    convention: ``fn(aids, types, lengths, t_time, t_clickw, t_cartw,
    t_clickcart, t_cartorder, ft)`` over a whole chunk (the same on every
    rank) returns every type's (candidates, scores) for the whole chunk.
    Tables are placed by :meth:`ServingLayout.table`; ``ft`` is ignored
    without ``with_ft``."""
    from otto_tpu_torch.models.candidates import _regular_chunk

    layout = ServingLayout(mesh, None, data_axis, model_axis)

    def fn(aids, types, lengths, *tables):
        return layout.over_data(_regular_chunk)(
            aids, types, lengths, tables[:5], tables[5] if with_ft else None, uniq_cap, wide_k,
            k_covisit, vote_cap, gather=layout.gather)

    return fn


def make_sharded_heuristic_routes(mesh, uniq_cap: int, narrow_k: int, k: int, with_ft: bool,
                                  data_axis: str = "data", model_axis: str = "model"):
    """The heuristic's two routes (``_covisit_route``, ``_recency_route``)
    over ``mesh`` in the JAX package's calling convention: ``(covisit_fn,
    recency_fn)``, ``covisit_fn(aids, types, lengths, t_time, t_clickw,
    t_cartw, t_clickcart, t_cartorder, ft, stats_clicks, stats_carts,
    stats_orders)`` and ``recency_fn(aids, types, lengths, t_time, t_cartw,
    t_cartorder, ft)`` over a whole chunk, each type's top-``k`` lists.
    Tables are placed by :meth:`ServingLayout.table`; the frequency rows
    are whole."""
    from otto_tpu_torch.models.covisitation import _covisit_route, _recency_route

    layout = ServingLayout(mesh, None, data_axis, model_axis)

    def with_fasttext(tables: dict, ft) -> dict:
        return {**tables, "fasttext": ft} if with_ft else tables

    def covisit_fn(aids, types, lengths, *args):
        tables = with_fasttext(dict(zip(CANDGEN_TABLE_KINDS, args[:5])), args[5])
        stats = dict(zip(EVENT_TYPES, args[6:9]))
        return layout.over_data(_covisit_route)(aids, types, lengths, tables, stats, uniq_cap,
                                                narrow_k, k, gather=layout.gather)

    def recency_fn(aids, types, lengths, t_time, t_cartw, t_cartorder, ft):
        tables = with_fasttext({"time_weighted": t_time, "cart_weighted": t_cartw,
                                "cart_order": t_cartorder}, ft)
        return layout.over_data(_recency_route)(aids, types, lengths, tables, uniq_cap,
                                                narrow_k, k, gather=layout.gather)

    return covisit_fn, recency_fn


def host_rows_over_data(mesh, idx: np.ndarray, fn, k: int, data_axis: str = "data") -> dict:
    """A host route over a mesh: this rank runs ``fn(sub_idx)`` (per type,
    int32 [len(sub_idx), k] numpy) on its contiguous ``data`` part of
    ``idx``; the parts are gathered over ``data`` in order, whole on every
    rank."""
    part = np.array_split(idx, axis_size(mesh, data_axis))[axis_index(mesh, data_axis)]
    mine = fn(part) if len(part) else {e: np.zeros((0, k), np.int32) for e in EVENT_TYPES}
    dev = mesh_device(mesh)
    return {e: torch.cat(all_gather_rows(mesh, torch.as_tensor(mine[e], device=dev),
                                         data_axis)).cpu().numpy()
            for e in EVENT_TYPES}
