"""Candidate generation for the two-stage ranker (reference L6a).

Port of ``otto_tpu/models/candidates.py``.  Four generators mirroring
src/ranker/:

- :func:`regular_candidates` — the production generator
  (regular_candidate_generation.py:138-197): session unique aids
  (recency-ordered, scores = descending ranks) + covisitation-vote top-100
  (vote counts as scores) + embedding kNN of the last aid, with binary labels
  and a max-recall ceiling report.
- :func:`covisit_candidates` — covisitation votes only
  (covisitation_candidate_generation.py:108-157).
- :func:`recency_candidates` — session-history-only recency weights with
  type coefficients {click:1, cart:6, order:1}
  (recency_weighted_candidate_generator.py:24,61-105), through
  :func:`otto_tpu_torch.ops.sessions.recency_weighted_top_aids` (the session
  vote kernel on the card).
- :func:`embedding_candidates` — kNN of the last session aid with distances
  as scores (fasttext_candidate_generator.py:36-48).

Candidates are fixed-shape ``[S, C]`` padded arrays; :meth:`CandidateSet.flatten`
recovers the reference's flat (session, candidate, score, label) layout.
The device work runs on the ``device`` each generator is given.  What the
JAX package does only for the TPU is left out, with results unchanged:
chunks are not padded to ``chunk_sessions`` rows (a fixed shape for XLA's
compile cache) and no dispatch lookahead keeps chunks in flight (the TPU
host link).  The length buckets stay: short sessions run as [chunk, 32]
slices on any device.  ``mesh=`` serves sharded over a process mesh
(:mod:`otto_tpu_torch.parallel.serving`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.labels import SessionLabels
from otto_tpu_torch.eval.metrics import corpus_recall_at_k, weighted_recall
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.models.covisitation import CovisitationMatrices
from otto_tpu_torch.ops.multiset import (
    gather_neighbors,
    mask_members,
    row_weight_topk,
    sorted_unique_rows,
)
from otto_tpu_torch.ops.sessions import distinct_recent_first, recency_weighted_top_aids
from otto_tpu_torch.parallel.serving import CANDGEN_TABLE_KINDS, ServingLayout
from otto_tpu_torch.utils.runtime import resolve_device

log = get_logger(__name__)

RECENCY_CANDGEN_COEFF = (1.0, 6.0, 1.0)


@dataclass
class CandidateSet:
    """Per-event-type candidate lists for a batch of sessions."""

    session_ids: np.ndarray  # [S]
    candidates: dict[str, np.ndarray]  # etype -> int32 [S, C] padded -1
    scores: dict[str, np.ndarray]  # etype -> float32 [S, C]
    labels: dict[str, np.ndarray] | None = None  # etype -> int8 [S, C]

    @property
    def n_sessions(self) -> int:
        return len(self.session_ids)

    def width(self, etype: str) -> int:
        return self.candidates[etype].shape[1]

    def flatten(self, etype: str):
        """Reference-style flat arrays (session, candidate, score[, label])."""
        cands = self.candidates[etype]
        valid = cands >= 0
        sess = np.repeat(self.session_ids, valid.sum(axis=1))
        flat_c = cands[valid]
        flat_s = self.scores[etype][valid]
        if self.labels is not None:
            return sess, flat_c, flat_s, self.labels[etype][valid]
        return sess, flat_c, flat_s

    def max_recall_report(self, labels: SessionLabels, *,
                          device: str | torch.device) -> dict[str, float]:
        """Candidate max-recall ceiling (corpus-level, clip-20 denominator) —
        the bound any reranker can achieve
        (regular_candidate_generation.py:203-223)."""
        dev = resolve_device(device)
        out = {}
        for etype in EVENT_TYPES:
            r = corpus_recall_at_k(torch.as_tensor(self.candidates[etype], device=dev),
                                   torch.as_tensor(labels.padded(etype), device=dev), k=TOP_K)
            out[etype] = float(r)
        out["weighted"] = weighted_recall(out["clicks"], out["carts"], out["orders"])
        log.info(
            "candidate max recalls: clicks %.6f carts %.6f orders %.6f weighted %.6f",
            out["clicks"], out["carts"], out["orders"], out["weighted"],
        )
        return out


def _compact_two(values: torch.Tensor, scores: torch.Tensor):
    """Left-compact (value, score) pairs where value >= 0, preserving order."""
    order = torch.sort((values < 0).to(torch.int8), dim=1, stable=True).indices
    v = torch.gather(values, 1, order)
    s = torch.gather(scores, 1, order)
    return v, torch.where(v >= 0, s, 0.0)


def _attach_labels(candidates: torch.Tensor, click_label: torch.Tensor,
                   cart_padded: torch.Tensor, order_padded: torch.Tensor):
    click = (candidates == click_label[:, None]) & (candidates >= 0)
    cart = ((candidates[:, :, None] == cart_padded[:, None, :])
            & (cart_padded >= 0)[:, None, :]).any(dim=2)
    order = ((candidates[:, :, None] == order_padded[:, None, :])
             & (order_padded >= 0)[:, None, :]).any(dim=2)
    return click.to(torch.int8), cart.to(torch.int8), order.to(torch.int8)


def _label_dict(cand_dict, labels: SessionLabels, *, device: str | torch.device):
    """Binary labels int8 [S, C] of each type's candidates (click: the
    session's click label; carts/orders: membership in the label lists)."""
    dev = resolve_device(device)
    cart_p = torch.as_tensor(labels.padded("carts"), device=dev)
    order_p = torch.as_tensor(labels.padded("orders"), device=dev)
    click = torch.as_tensor(labels.click, device=dev)
    out = {}
    for i, etype in enumerate(EVENT_TYPES):
        lab = _attach_labels(torch.as_tensor(cand_dict[etype], device=dev), click, cart_p,
                             order_p)
        out[etype] = lab[i].cpu().numpy()
    return out


def _vote_block(vals: torch.Tensor, uniq_recent: torch.Tensor, k_covisit: int):
    """Vote-count top-k + session-aid exclusion + compaction for one list."""
    top, votes = row_weight_topk(vals, torch.ones(vals.shape, dtype=torch.float32,
                                                  device=vals.device), vals >= 0, k_covisit)
    return _compact_two(mask_members(top, uniq_recent), votes)


def _session_lists(aids, types, lengths, uniq_cap: int, vote_cap: int):
    """Validity mask and last aid derived from the packing (pack keep='last'
    left-aligns short sessions: valid cols 0..min(len,L)-1, last event at
    column min(len,L)-1 — column -1 would read padding); then the distinct
    aids most recent first with their history scores (count - rank), and the
    ascending distinct click/cart aids."""
    L = aids.shape[1]
    clipped = lengths.clamp(max=L).to(torch.int64)
    mask = torch.arange(L, device=aids.device)[None, :] < clipped[:, None]
    last_aid = torch.gather(aids, 1, (clipped - 1).clamp(min=0)[:, None])
    uniq_recent = distinct_recent_first(aids, mask, k=uniq_cap)
    clickcart = sorted_unique_rows(torch.where(types <= 1, aids, -1), mask,
                                   min(vote_cap, uniq_cap))
    n_uniq = (uniq_recent >= 0).sum(dim=1)
    col = torch.arange(uniq_cap, dtype=torch.float32, device=aids.device)[None, :]
    hist_scores = torch.where(uniq_recent >= 0, n_uniq[:, None].to(torch.float32) - col, 0.0)
    return uniq_recent, clickcart, hist_scores, last_aid


def _regular_chunk(aids, types, lengths, tables_tuple, ft_table, uniq_cap: int, wide_k: int,
                   k_covisit: int, vote_cap: int = 32, gather=gather_neighbors):
    """One chunk of the regular generator: returns per-type (candidates,
    scores) of width uniq_cap + k_covisit regardless of the chunk's packed
    width L (narrow chunks pad their history section with -1 columns).

    ``vote_cap`` bounds the per-session source lists feeding the vote gathers
    (sessions with more than vote_cap distinct source aids are rare and lose
    only their least-recent vote sources).  ``ft_table`` (the kNN neighbor
    table) may be None.  ``gather(table, queries)`` reads the neighbor rows
    (the row-sharded tables' collective gather on a mesh)."""
    t_time, t_clickw, t_cartw, t_clickcart, t_cartorder = tables_tuple
    S, L = aids.shape
    list_cap = min(uniq_cap, L)  # a session of <= L events has <= L distinct aids
    uniq_recent, clickcart, hist_scores, last_aid = _session_lists(
        aids, types, lengths, list_cap, vote_cap)
    vote_src = uniq_recent[:, : min(vote_cap, list_cap)]

    g_time = gather(t_time[:, :wide_k], vote_src)
    g_clickw = gather(t_clickw[:, :wide_k], clickcart)
    g_cartw = gather(t_cartw[:, :wide_k], clickcart)
    g_clickcart = gather(t_clickcart[:, :wide_k], clickcart)
    g_cartorder = gather(t_cartorder[:, :wide_k], clickcart)
    if ft_table is not None:
        ft_list = gather(ft_table, last_aid)
    else:
        ft_list = torch.full((S, 0), -1, dtype=torch.int32, device=aids.device)

    lists = {
        "clicks": torch.cat([g_time, g_clickw, g_cartw, g_clickcart, g_cartorder, ft_list], 1),
        "carts": torch.cat([g_time, g_cartw, g_cartorder, ft_list], 1),
        "orders": torch.cat([g_time, g_cartw, g_cartorder, ft_list], 1),
    }

    # pad the history section to uniq_cap so the [history | covisit] column
    # layout is identical for every packed width (the history section is
    # already -1-padded internally, so extra -1 columns are transparent)
    pad_cols = uniq_cap - list_cap
    uniq_hist = uniq_recent
    if pad_cols:
        uniq_hist = torch.nn.functional.pad(uniq_recent, (0, pad_cols), value=-1)
        hist_scores = torch.nn.functional.pad(hist_scores, (0, pad_cols))

    out = {}
    for etype in EVENT_TYPES:
        filt, filt_scores = _vote_block(lists[etype], uniq_recent, k_covisit)
        out[etype] = (torch.cat([uniq_hist, filt], 1), torch.cat([hist_scores, filt_scores], 1))
    return out


def _bucketed(store: EventStore, max_len: int, chunk_sessions: int, fn, width_out: int,
              dev: torch.device):
    """Run ``fn(aids, types, lengths)`` over length-bucketed session chunks
    (sessions of <= 32 events as [chunk, 32] slices: exact under the
    left-aligned keep='last' layout) and gather its per-type (candidates,
    scores) into [S, width_out] host arrays."""
    packed = store.pack(max_len=max_len, keep="last")
    S = store.n_sessions
    cands = {t: np.full((S, width_out), -1, np.int32) for t in EVENT_TYPES}
    scores = {t: np.zeros((S, width_out), np.float32) for t in EVENT_TYPES}
    clens = np.minimum(store.lengths, packed.max_len)
    lo = 0
    for width in (w for w in (32, packed.max_len) if w <= packed.max_len):
        idx = np.flatnonzero((clens > lo) & (clens <= width))
        lo = width
        for start in range(0, len(idx), chunk_sessions):
            sel = idx[start:start + chunk_sessions]
            res = fn(torch.as_tensor(packed.aids[sel, :width], device=dev),
                     torch.as_tensor(packed.types[sel, :width], device=dev),
                     torch.as_tensor(np.minimum(packed.lengths[sel], width), device=dev))
            for t in EVENT_TYPES:
                c, s = res[t]
                cands[t][sel] = c.cpu().numpy()
                scores[t][sel] = s.cpu().numpy()
    return cands, scores


def _candidate_set(store: EventStore, cands, scores, labels, dev) -> CandidateSet:
    lab = _label_dict(cands, labels, device=dev) if labels is not None else None
    cs = CandidateSet(store.session_ids.copy(), cands, scores, lab)
    if labels is not None:
        cs.max_recall_report(labels, device=dev)
    return cs


def regular_candidates(
    store: EventStore,
    matrices: CovisitationMatrices,
    ft_neighbors: np.ndarray | None = None,
    labels: SessionLabels | None = None,
    uniq_cap: int = 64,
    wide_k: int = 20,
    k_covisit: int = 100,
    max_len: int = 256,
    chunk_sessions: int = 2048,
    vote_cap: int = 32,
    mesh=None,
    *,
    device: str | torch.device | None,
) -> CandidateSet:
    """The production candidate generator, on ``device``: per type
    ``[S, uniq_cap + k_covisit]`` candidates and scores (and labels when
    ``labels`` is given).

    With ``mesh`` (a :func:`otto_tpu_torch.parallel.make_mesh` mesh; every
    rank calls with the same arguments and ``device`` its own or None),
    sessions split over the mesh's ``data`` axis and the covisitation and
    kNN tables row-wise over ``model`` (:mod:`otto_tpu_torch.parallel.
    serving`); every rank returns the single-device result."""
    layout = ServingLayout(mesh, device)
    tt = tuple(layout.table(matrices.tables[k][0][:, :wide_k]) for k in CANDGEN_TABLE_KINDS)
    ft = layout.table(ft_neighbors) if ft_neighbors is not None else None
    fn = layout.over_data(partial(_regular_chunk, tables_tuple=tt, ft_table=ft,
                                  uniq_cap=uniq_cap, wide_k=wide_k, k_covisit=k_covisit,
                                  vote_cap=vote_cap, gather=layout.gather))
    dev = layout.device
    chunk_sessions = layout.chunk(chunk_sessions)
    cands, scores = _bucketed(store, max_len, chunk_sessions, fn, uniq_cap + k_covisit, dev)
    return _candidate_set(store, cands, scores, labels, dev)


def recency_candidates(
    store: EventStore,
    labels: SessionLabels | None = None,
    uniq_cap: int = 64,
    max_len: int = 256,
    chunk_sessions: int = 4096,
    *,
    device: str | torch.device,
) -> CandidateSet:
    """Session-history-only recency-weighted candidates, on ``device`` (the
    per-aid sums through the session vote)."""
    dev = resolve_device(device)
    packed = store.pack(max_len=max_len, keep="last")
    coeff = torch.tensor(RECENCY_CANDGEN_COEFF, dtype=torch.float32, device=dev)
    lo = {"clicks": 0.1, "carts": 0.5, "orders": 0.5}
    S = store.n_sessions
    k = min(uniq_cap, packed.max_len)  # _rank_select keeps at most L columns
    cands = {t: np.full((S, k), -1, np.int32) for t in EVENT_TYPES}
    scores = {t: np.zeros((S, k), np.float32) for t in EVENT_TYPES}
    for start in range(0, S, chunk_sessions):
        sel = slice(start, start + chunk_sessions)
        a, ty, m, lens = (torch.as_tensor(x[sel], device=dev) for x in (
            packed.aids, packed.types, packed.mask, packed.lengths))
        for etype in EVENT_TYPES:
            c, w = recency_weighted_top_aids(a, ty, m, lens, coeff, k=uniq_cap, lo=lo[etype],
                                             hi=1.0)
            cands[etype][sel] = c.cpu().numpy()
            scores[etype][sel] = torch.where(c >= 0, w, 0.0).cpu().numpy()
    return _candidate_set(store, cands, scores, labels, dev)


def covisit_candidates(
    store: EventStore,
    matrices: CovisitationMatrices,
    labels: SessionLabels | None = None,
    uniq_cap: int = 64,
    wide_k: int = 15,
    k_covisit: int = 100,
    max_len: int = 256,
    chunk_sessions: int = 2048,
    *,
    device: str | torch.device,
) -> CandidateSet:
    """Covisitation-votes-only candidates (no history, no embeddings), on
    ``device``."""
    layout = ServingLayout(None, device)
    dev = layout.device
    tt = tuple(layout.table(matrices.tables[k][0][:, :wide_k]) for k in CANDGEN_TABLE_KINDS)

    def fn(a, t, lens):
        res = _regular_chunk(a, t, lens, tt, None, uniq_cap, wide_k, k_covisit)
        # drop the history prefix: keep only the covisitation block
        return {k: (c[:, uniq_cap:], s[:, uniq_cap:]) for k, (c, s) in res.items()}

    cands, scores = _bucketed(store, max_len, chunk_sessions, fn, k_covisit, dev)
    return _candidate_set(store, cands, scores, labels, dev)


def embedding_candidates(
    store: EventStore,
    ft_neighbors: np.ndarray,
    ft_scores: np.ndarray,
    labels: SessionLabels | None = None,
    *,
    device: str | torch.device,
) -> CandidateSet:
    """kNN-of-last-aid candidates with similarity scores
    (fasttext_candidate_generator.py:75-98); labels on ``device``."""
    dev = resolve_device(device)
    last = store.last_aid()
    cands_row = ft_neighbors[last].astype(np.int32)
    scores_row = ft_scores[last].astype(np.float32)
    cands = {etype: cands_row for etype in EVENT_TYPES}
    scores = {etype: scores_row for etype in EVENT_TYPES}
    return _candidate_set(store, cands, scores, labels, dev)
