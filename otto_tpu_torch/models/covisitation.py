"""Covisitation matrices: construction, persistence, and the heuristic
recommender (the reference's strongest non-ranker model,
src/covisitation/inference.py).

Port of ``otto_tpu/models/covisitation.py``.  Construction (absent from the
reference repo — it consumed external parquet shards) runs the chunked
device pipeline of :mod:`otto_tpu_torch.ops.covisit`: pair stream ->
per-row sort and run-length reduce -> live-row compaction -> host
accumulator merge -> per-aid top-k tables.  The dense ``[n_aids, K]``
neighbor tables replace the reference's dict-of-lists
(covisitation_df_to_dict, src/covisitation/inference.py:19-35) with one
device gather.

What the JAX package does only for the TPU is left out, with results
unchanged: chunks are not padded to a fixed session count, and the
heuristic's chunks are not kept in flight (both exist for XLA's compile
cache and the TPU host link).  The length buckets stay: they shrink the
per-session pair grid on any device.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.config import COVISIT_KINDS, CovisitConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.ops.covisit import (
    PairAccumulator,
    compact_live,
    pair_stream,
    sort_reduce_rows,
    topk_per_source,
)
from otto_tpu_torch.ops.multiset import (
    compact_rows,
    concat_unique_cascade,
    gather_neighbors,
    mask_members,
    row_weight_topk,
    sorted_unique_rows,
)
from otto_tpu_torch.ops.sessions import distinct_recent_first, recency_weights
from otto_tpu_torch.utils.runtime import resolve_device

log = get_logger(__name__)

LONG_WINDOW = 14 * 24 * 60 * 60  # cart_order's pair window


@dataclass
class CovisitationMatrices:
    """Per-kind dense top-k neighbor tables.

    ``tables[kind] = (aids int32 [n_aids, K] padded -1, weights float32)``.
    The "top_15_*" (narrow) and "top_*" (wide) shard families of the reference
    are just different K slices of the same tables."""

    tables: dict[str, tuple[np.ndarray, np.ndarray]]
    n_aids: int

    def neighbors(self, kind: str, k: int | None = None) -> np.ndarray:
        aids, _ = self.tables[kind]
        return aids if k is None else aids[:, :k]

    def save(self, directory: str | Path) -> None:
        """One ``covisit_<kind>.npz`` per kind, as ``otto_tpu`` writes them."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        for kind, (aids, weights) in self.tables.items():
            np.savez_compressed(directory / f"covisit_{kind}.npz", aids=aids, weights=weights)

    @classmethod
    def load(cls, directory: str | Path, kinds=COVISIT_KINDS) -> "CovisitationMatrices":
        directory = Path(directory)
        tables = {}
        n_aids = 0
        for kind in kinds:
            with np.load(directory / f"covisit_{kind}.npz") as z:
                tables[kind] = (z["aids"], z["weights"])
            n_aids = tables[kind][0].shape[0]
        return cls(tables=tables, n_aids=n_aids)


def _empty_matrices(n_aids: int, config: CovisitConfig) -> CovisitationMatrices:
    empty = (np.full((n_aids, config.top_k_wide), -1, np.int32),
             np.zeros((n_aids, config.top_k_wide), np.float32))
    return CovisitationMatrices({k: empty for k in config.kinds}, n_aids)


def build_covisitation(
    store: EventStore,
    n_aids: int,
    config: CovisitConfig = CovisitConfig(),
    chunk_sessions: int = 2048,
    mesh=None,
    budget_rows: int | None = 64_000_000,
    per_aid_cap: int = 128,
    stats_out: dict | None = None,
    progress_cb=None,
    *,
    device: str | torch.device,
) -> CovisitationMatrices:
    """Build all seven matrices in one pass over the event data.

    Sessions go to the device in chunks of ``chunk_sessions``; each chunk's
    pair stream is sorted and run-reduced there, and only its live rows come
    back.  A few chunks stay in flight, so the host merge of one chunk
    overlaps the device work of the next.

    Host memory is bounded by ``budget_rows`` (~36 B/row): the accumulator
    merge-reduces and prunes each aid to its running top ``per_aid_cap``
    co-visitors whenever the buffer exceeds the budget
    (:class:`otto_tpu_torch.ops.covisit.PairAccumulator`).
    ``budget_rows=None`` keeps every distinct pair (exact, unbounded).

    ``progress_cb(events_done, acc)`` fires after every drained chunk.
    ``stats_out`` receives ``dispatch_s`` (host prep and enqueue),
    ``drain_s`` (waiting for the device, the copy to the host and the merge)
    and the accumulator's ``compaction_log``.  ``mesh`` (a sharded build)
    is not ported yet and raises.
    """
    if mesh is not None:
        raise NotImplementedError("build_covisitation: the sharded build (mesh=) is not "
                                  "ported yet (ROADMAP M15)")
    dev = resolve_device(device)
    T = config.session_tail
    if store.n_events == 0:
        return _empty_matrices(n_aids, config)
    t0 = np.int64(store.ts.min())
    t1 = np.int64(store.ts.max())
    type_mult = torch.tensor([config.click_weight, config.cart_weight, config.order_weight],
                             dtype=torch.float32, device=dev)

    acc = PairAccumulator(n_aids, budget_rows=budget_rows, per_aid_cap=per_aid_cap)
    packed = store.pack(max_len=T, keep="last")
    plens = np.minimum(packed.lengths, T).astype(np.int64)
    aids_d = torch.as_tensor(packed.aids, device=dev)
    types_d = torch.as_tensor(packed.types, device=dev)
    rel_ts_d = torch.as_tensor((packed.ts - t0).astype(np.int32), device=dev)  # spans weeks
    mask_d = torch.as_tensor(packed.mask, device=dev)

    # length buckets: a session with <= t events travels as a [chunk, t]
    # slice (pack left-aligns), shrinking the t^2 pair grid by ~(T/t)^2 for
    # the short-session majority.  Chunk order across buckets is irrelevant:
    # the host merge re-reduces by key.
    widths = [t for t in (8, 16) if t < T] + [T]
    bucket_of = np.searchsorted(np.asarray(widths), plens)

    def dispatch(idx: np.ndarray, t: int):
        """Enqueue one chunk's device work (sessions ``idx`` at width ``t``)."""
        sel = torch.as_tensor(idx, device=dev)
        keys, weights = pair_stream(
            aids_d[sel, :t], types_d[sel, :t], rel_ts_d[sel, :t], mask_d[sel, :t], n_aids,
            float(t1 - t0), type_mult, config.window_seconds, LONG_WINDOW)
        sk, totals, live = sort_reduce_rows(keys.reshape(len(idx), t * t),
                                            weights.reshape(len(idx), t * t, -1))
        # a session of packed length l emits at most l*(l-1) ordered pairs,
        # so this host-side bound holds every live row
        lens = plens[idx]
        cap = max(int(np.sum(lens * np.maximum(lens - 1, 0))), 1)
        return int(lens.sum()), compact_live(sk, totals, live, cap)

    events_done = 0

    def drain(item):
        nonlocal events_done
        ev, (keys_c, totals_c, n_live) = item
        n = int(n_live)
        acc.add(keys_c[:n].cpu().numpy(), totals_c[:n].cpu().numpy())
        events_done += ev

    t_dispatch = t_drain = 0.0
    lookahead = 4
    inflight: deque = deque()

    def drain_one():
        nonlocal t_drain
        _t0 = time.perf_counter()
        drain(inflight.popleft())
        t_drain += time.perf_counter() - _t0
        if progress_cb is not None:  # outside the timed section
            progress_cb(events_done, acc)

    for bi, t in enumerate(widths):
        idx_all = np.flatnonzero(bucket_of == bi)
        for start in range(0, len(idx_all), chunk_sessions):
            _t0 = time.perf_counter()
            inflight.append(dispatch(idx_all[start:start + chunk_sessions], t))
            t_dispatch += time.perf_counter() - _t0
            if len(inflight) > lookahead:
                drain_one()
    while inflight:
        drain_one()
    log.info("covisitation build: dispatch %.1fs, drain(fetch+merge) %.1fs",
             t_dispatch, t_drain)
    if stats_out is not None:
        stats_out["dispatch_s"] = round(t_dispatch, 1)
        stats_out["drain_s"] = round(t_drain, 1)
        stats_out["compaction_log"] = list(acc.compaction_log)

    keys, weights = acc.finish()
    if not len(keys):
        return _empty_matrices(n_aids, config)
    log.info(
        "covisitation: %d distinct pairs aggregated (peak buffer %d rows, "
        "%d compactions, %d rows pruned)",
        len(keys), acc.peak_rows, acc.n_compactions, acc.rows_pruned,
    )

    aid_x = (keys // n_aids).astype(np.int64)
    aid_y = (keys % n_aids).astype(np.int32)
    tables = {}
    for i, kind in enumerate(COVISIT_KINDS):
        if kind not in config.kinds:
            continue
        tables[kind] = topk_per_source(aid_x, aid_y, weights[:, i], n_aids, config.top_k_wide)
    return CovisitationMatrices(tables=tables, n_aids=n_aids)


# ---------------------------------------------------------------------------
# Heuristic recommender (reference: src/covisitation/inference.py validation/
# submission bodies).  Sessions with >= 20 distinct aids are scored by typed
# log-recency weights plus neighbor bonuses ("recency_weight" route,
# inference.py:128-133,143-199); the rest are scored by covisitation voting
# ("covisitation" route, :204-247).  Both routes are batched device code; the
# routing itself is a host partition so each branch only processes its own
# sessions.
# ---------------------------------------------------------------------------

# event-type coefficients for the recency route (covisitation/inference.py:72)
RECENCY_TYPE_COEFF = (1.0, 9.0, 6.0)
FT_BONUS = {"clicks": 0.05, "carts": 0.05, "orders": 0.15}
COVISIT_BONUS = {"clicks": 0.05, "carts": 0.05, "orders": 0.15}


def session_unique_counts(store: EventStore) -> np.ndarray:
    """Exact distinct-aid count per session (vectorized host-side)."""
    order = np.lexsort((store.aid, store.session_idx))
    s = store.session_idx[order]
    a = store.aid[order]
    head = np.concatenate([[True], (s[1:] != s[:-1]) | (a[1:] != a[:-1])])
    return np.bincount(s[head], minlength=store.n_sessions).astype(np.int32)


def _derive_mask_last(aids: torch.Tensor, lengths: torch.Tensor):
    """Right-padded packing (EventStore.pack keep='last'): valid columns are
    0..min(len,L)-1 and the last event sits at column min(len,L)-1.  A
    zero-length row has no valid column; its ``last`` is column 0."""
    L = aids.shape[1]
    clipped = lengths.clamp(max=L).to(torch.int64)
    mask = torch.arange(L, device=aids.device)[None, :] < clipped[:, None]
    last = torch.gather(aids, 1, (clipped - 1).clamp(min=0)[:, None])
    return mask, last


def _heur_lists(aids, types, lengths, uniq_cap: int):
    """Per-session source lists shared by both heuristic routes."""
    mask, last_aid = _derive_mask_last(aids, lengths)
    uniq_recent = distinct_recent_first(aids, mask, k=uniq_cap)
    click_uniq = sorted_unique_rows(torch.where(types == 0, aids, -1), mask, uniq_cap)
    clickcart = sorted_unique_rows(torch.where(types <= 1, aids, -1), mask, uniq_cap)
    cartorder = sorted_unique_rows(torch.where(types >= 1, aids, -1), mask, uniq_cap)
    return mask, last_aid, uniq_recent, click_uniq, clickcart, cartorder


def _vote_cascade(vals, uniq_recent, stats_row, k: int):
    """Vote-count top-k, session-aid exclusion, compaction, and the
    reference's padding cascade (session aids -> covisit votes -> global
    frequency, inference.py:238-243) for one event type."""
    top, _ = row_weight_topk(vals, torch.ones(vals.shape, dtype=torch.float32,
                                              device=vals.device), vals >= 0, k)
    filtered = compact_rows(mask_members(top, uniq_recent))
    return concat_unique_cascade(uniq_recent[:, :k], filtered, stats_row, k)


def _ft_list(tables, last_aid, n_rows: int, device):
    fts = tables.get("fasttext")
    if fts is None:
        return torch.full((n_rows, 0), -1, dtype=torch.int32, device=device)
    return gather_neighbors(fts, last_aid)


def _covisit_route(aids, types, lengths, tables, stats_top, uniq_cap: int, narrow_k: int,
                   k: int):
    """Batched covisitation-vote route for one chunk of sessions.

    List concatenation order matches the reference exactly (it sets the
    Counter tie-break): time + click_w + cart_w + click_cart + cart_order +
    fasttext for clicks; time + cart_w + cart_order + fasttext for carts and
    orders (inference.py:215-236).  The fasttext neighbor list arrives via
    ``tables['fasttext']`` when an embedding model is attached.
    """
    _, last_aid, uniq_recent, _, clickcart, _ = _heur_lists(aids, types, lengths, uniq_cap)

    g_time = gather_neighbors(tables["time_weighted"][:, :narrow_k], uniq_recent)
    g_clickw = gather_neighbors(tables["click_weighted"][:, :narrow_k], clickcart)
    g_cartw = gather_neighbors(tables["cart_weighted"][:, :narrow_k], clickcart)
    g_clickcart = gather_neighbors(tables["click_cart"][:, :narrow_k], clickcart)
    g_cartorder = gather_neighbors(tables["cart_order"][:, :narrow_k], clickcart)
    ft_list = _ft_list(tables, last_aid, aids.shape[0], aids.device)

    lists = {
        "clicks": torch.cat([g_time, g_clickw, g_cartw, g_clickcart, g_cartorder, ft_list], 1),
        "carts": torch.cat([g_time, g_cartw, g_cartorder, ft_list], 1),
        "orders": torch.cat([g_time, g_cartw, g_cartorder, ft_list], 1),
    }
    return {etype: _vote_cascade(lists[etype], uniq_recent, stats_top[etype][:k], k)
            for etype in EVENT_TYPES}


def _recency_route(aids, types, lengths, tables, uniq_cap: int, narrow_k: int, k: int):
    """Batched typed-recency route (inference.py:143-199): per-type log-recency
    weights x coefficients {1,9,6}, +bonus votes from fastText neighbors of the
    last aid and one covisitation table per type."""
    mask, last_aid, _, click_uniq, clickcart, cartorder = _heur_lists(
        aids, types, lengths, uniq_cap)
    ft_list = _ft_list(tables, last_aid, aids.shape[0], aids.device)
    bonus_lists = {
        "clicks": gather_neighbors(tables["time_weighted"][:, :narrow_k], click_uniq),
        "carts": gather_neighbors(tables["cart_weighted"][:, :narrow_k], clickcart),
        "orders": gather_neighbors(tables["cart_order"][:, :narrow_k], cartorder),
    }
    lo = {"clicks": 0.1, "carts": 0.5, "orders": 0.5}
    return {etype: _recency_scored_top(aids, types, lengths, mask, ft_list, bonus_lists[etype],
                                       FT_BONUS[etype], COVISIT_BONUS[etype], lo[etype], k)
            for etype in EVENT_TYPES}


def _recency_scored_top(aids, types, lengths, mask, ft_list, bonus_list,
                        ft_bonus: float, cv_bonus: float, lo: float, k: int):
    """One event type of the recency route: log-recency event weights x type
    coefficients {1,9,6} plus flat neighbor bonuses, weighted multiset top-k."""
    L = aids.shape[1]
    clipped = mask.sum(dim=1)
    offset = (lengths - clipped)[:, None].to(torch.float32)
    true_pos = offset + torch.arange(L, dtype=torch.float32, device=aids.device)[None, :]
    coeff = torch.tensor(RECENCY_TYPE_COEFF, dtype=torch.float32, device=aids.device)[types.long()]
    w_events = recency_weights(lengths, true_pos, mask, lo=lo, hi=1.0) * coeff
    vals = torch.cat([aids, ft_list, bonus_list], 1)
    ws = torch.cat([w_events,
                    torch.full(ft_list.shape, ft_bonus, dtype=torch.float32, device=aids.device),
                    torch.full(bonus_list.shape, cv_bonus, dtype=torch.float32,
                               device=aids.device)], 1)
    valid = torch.cat([mask, ft_list >= 0, bonus_list >= 0], 1)
    top, _ = row_weight_topk(vals, ws, valid, k)
    return top


def covisit_heuristic_predictions(
    store: EventStore,
    matrices: CovisitationMatrices,
    stats_top: dict[str, np.ndarray],
    ft_neighbors: np.ndarray | None = None,
    narrow_k: int = 15,
    k: int = TOP_K,
    max_len: int = 256,
    unique_cap: int = 64,
    chunk_sessions: int = 2048,
    mesh=None,
    recency_host_f64: bool = False,
    covisit_host: bool = False,
    *,
    device: str | torch.device,
) -> dict[str, np.ndarray]:
    """Full heuristic recommender over all sessions of ``store``.

    ``recency_host_f64`` routes the >=20-unique-aid sessions through the
    vectorized host float64 accumulator
    (:mod:`otto_tpu_torch.models.heuristic_host`) instead of the float32
    device route — exact reference tie-break semantics.  ``covisit_host``
    does the same for the covisitation-vote route (unit votes — exact by
    construction); with both set the whole heuristic serves host-side.

    stats_top: per-type global top-20 aids (frequency fill).
    ft_neighbors: optional [n_aids, NN] nearest-neighbor table from the
    embedding model (replaces the reference's Annoy index; neighbors must
    already exclude the query aid itself).
    ``mesh`` (sharded serving) is not ported yet and raises.
    """
    if mesh is not None:
        raise NotImplementedError("covisit_heuristic_predictions: sharded serving (mesh=) is "
                                  "not ported yet (ROADMAP M15)")
    dev = resolve_device(device)
    counts = session_unique_counts(store)
    packed = store.pack(max_len=max_len, keep="last")
    S = store.n_sessions
    preds = {etype: np.full((S, k), -1, np.int32) for etype in EVENT_TYPES}

    cov_idx = np.flatnonzero(counts < 20)
    rec_idx = np.flatnonzero(counts >= 20)
    log.info("heuristic routing: %d covisitation, %d recency-weight sessions",
             len(cov_idx), len(rec_idx))

    device_routes = (len(cov_idx) and not covisit_host) or (len(rec_idx) and not recency_host_f64)
    if device_routes:
        tables = {kind: torch.as_tensor(t[0], device=dev) for kind, t in matrices.tables.items()}
        if ft_neighbors is not None:
            tables["fasttext"] = torch.as_tensor(ft_neighbors, device=dev)
        stats_dev = {etype: torch.tensor(stats_top[etype][:k], device=dev)
                     for etype in EVENT_TYPES}
        aids_d = torch.as_tensor(packed.aids, device=dev)
        types_d = torch.as_tensor(packed.types, device=dev)
        lengths_d = torch.as_tensor(packed.lengths, device=dev)

    # Length-bucketed chunks: sessions whose (clipped) length fits in 32
    # columns run as [chunk, 32] slices (the keep='last' layout is
    # left-aligned, so column-slicing is exact for them), which cuts the
    # O(L^2) session work for the short-session majority.
    widths = tuple(w for w in (32, packed.max_len) if w <= packed.max_len)

    def run_route(route_fn, idx):
        clens = np.minimum(store.lengths[idx], packed.max_len)
        lo = 0
        for width in widths:
            sub = idx[(clens > lo) & (clens <= width)]
            lo = width
            cap = min(unique_cap, width)
            for start in range(0, len(sub), chunk_sessions):
                sel = sub[start:start + chunk_sessions]
                sel_d = torch.as_tensor(sel, device=dev)
                lens = lengths_d[sel_d]
                res = route_fn(aids_d[sel_d, :width], types_d[sel_d, :width],
                               lens.clamp(max=width) if width < packed.max_len else lens, cap)
                for etype in EVENT_TYPES:
                    preds[etype][sel] = res[etype].cpu().numpy()

    if len(cov_idx):
        if covisit_host:
            from otto_tpu_torch.models.heuristic_host import covisit_route_host

            narrow5 = {kind: np.asarray(matrices.tables[kind][0][:, :narrow_k])
                       for kind in matrices.tables}
            host_cov = covisit_route_host(store, cov_idx, narrow5,
                                          {t: np.asarray(stats_top[t]) for t in EVENT_TYPES},
                                          ft_neighbors, k=k)
            for etype in EVENT_TYPES:
                preds[etype][cov_idx] = host_cov[etype]
        else:
            run_route(lambda a, t, lens, cap: _covisit_route(
                a, t, lens, tables, stats_dev, cap, narrow_k, k), cov_idx)
    if len(rec_idx):
        if recency_host_f64:
            from otto_tpu_torch.models.heuristic_host import recency_route_host_f64

            narrow_np = {kind: np.asarray(matrices.tables[kind][0][:, :narrow_k])
                         for kind in ("time_weighted", "cart_weighted", "cart_order")}
            host_preds = recency_route_host_f64(store, rec_idx, narrow_np, ft_neighbors, k=k)
            for etype in EVENT_TYPES:
                preds[etype][rec_idx] = host_preds[etype]
        else:
            run_route(lambda a, t, lens, cap: _recency_route(
                a, t, lens, tables, cap, narrow_k, k), rec_idx)
    return preds
