"""Wide-row multiset ops: sort-based per-row value counting and top-k.

Port of ``otto_tpu/ops/multiset.py``.  The covisitation recommender
concatenates per-session neighbor lists (hundreds to thousands of entries)
and takes ``Counter(...).most_common(k)`` (reference:
src/covisitation/inference.py:227-236,
src/ranker/regular_candidate_generation.py:162-176).  Rows are counted by
sorting: sort each row, detect run boundaries, run-length-sum the weights,
and rank by (weight desc, first-occurrence asc) — the exact
``Counter.most_common`` ordering.

The reference's two-key variadic sorts become stable sorts: a stable sort
by value keeps equal values in position order, which is the (value,
position) order; a lexicographic (a, b) order is a stable sort by ``b``
followed by a stable sort by ``a``.
"""

from __future__ import annotations

import torch

from otto_tpu_torch.ops.scan import run_totals

NEG = -3.4e38
_BIG = 2147483647


def lexsort_rows(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    """Row-wise permutation that sorts by (major, minor) ascending, ties in
    position order (``jnp.lexsort((minor, major), axis=-1)``)."""
    order = torch.sort(minor, dim=1, stable=True).indices
    return torch.gather(order, 1, torch.sort(torch.gather(major, 1, order), dim=1,
                                             stable=True).indices)


def row_weight_topk(values: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor, k: int):
    """Per-row weighted multiset top-k.

    values: int32 [S, M] (entries < 0 or with valid=False are ignored)
    weights: float32 [S, M] per-entry votes (Counter semantics: all ones)
    valid: bool [S, M]
    returns (top_values int32 [S, k] padded -1, top_weights float32 [S, k])
    ordered by (summed weight desc, first-occurrence position asc).
    """
    S, M = values.shape
    ok = valid & (values >= 0)
    v = torch.where(ok, values, _BIG)
    sv, sp = torch.sort(v, dim=1, stable=True)  # (value, position) order
    sw = torch.gather(torch.where(ok, weights, 0.0), 1, sp)

    head = torch.ones_like(sv, dtype=torch.bool)
    head[:, 1:] = sv[:, 1:] != sv[:, :-1]
    run_total = run_totals(sw, head, axis=1)

    valid_head = head & (sv < _BIG)
    neg_rt = torch.where(valid_head, -run_total, float("inf"))
    order = lexsort_rows(neg_rt, sp)[:, :k]
    live = torch.isfinite(torch.gather(neg_rt, 1, order))
    top_vals = torch.where(live, torch.gather(sv, 1, order), -1)
    top_w = torch.where(live, torch.gather(run_total, 1, order), 0.0)
    return top_vals.to(torch.int32), top_w


def row_count_topk(values: torch.Tensor, valid: torch.Tensor, k: int):
    """``Counter(values).most_common(k)`` per row (unit votes)."""
    return row_weight_topk(values, torch.ones_like(values, dtype=torch.float32), valid, k)


def mask_members(candidates: torch.Tensor, members: torch.Tensor) -> torch.Tensor:
    """Set candidate entries that appear in ``members`` to -1.

    candidates: int32 [S, K] padded -1; members: int32 [S, U] padded -1.
    Mirrors ``if aid not in session_unique_aids`` filters
    (src/covisitation/inference.py:229)."""
    is_member = ((candidates[:, :, None] == members[:, None, :])
                 & (members >= 0)[:, None, :]).any(dim=2)
    return torch.where(is_member, -1, candidates)


def compact_rows(arr: torch.Tensor) -> torch.Tensor:
    """Stable left-compaction of valid (>=0) entries, padding with -1."""
    order = torch.sort((arr < 0).to(torch.int8), dim=1, stable=True).indices
    return torch.gather(arr, 1, order)


def concat_unique_cascade(primary: torch.Tensor, secondary: torch.Tensor,
                          filler: torch.Tensor, k: int) -> torch.Tensor:
    """The reference's prediction padding cascade
    (src/covisitation/inference.py:238-243):

    ``out = primary + secondary[: k - len(primary)]``, then
    ``out = out + filler[: k - len(out)]``  (no dedup between stages beyond
    what the caller already applied).

    primary [S, P] / secondary [S, Q] padded -1 (left-compacted);
    filler [k] global aids.  Returns [S, k] int32 padded -1.
    """
    n_p = (primary >= 0).sum(dim=1)[:, None]
    n_q = (secondary >= 0).sum(dim=1)[:, None]
    col = torch.arange(k, device=primary.device)[None, :]

    from_p = torch.gather(primary, 1, col.clamp(0, primary.shape[1] - 1).expand(len(primary), k))
    use_p = col < n_p

    q_col = col - n_p
    from_q = torch.gather(secondary, 1, q_col.clamp(0, secondary.shape[1] - 1))
    use_q = ~use_p & (q_col < n_q)

    f_col = (col - n_p - torch.minimum(n_q, (k - n_p).clamp(min=0))).clamp(0, k - 1)
    from_f = filler[f_col]

    out = torch.where(use_p, from_p, torch.where(use_q, from_q, from_f))
    return out.to(torch.int32)


def sorted_unique_rows(values: torch.Tensor, valid: torch.Tensor, u: int) -> torch.Tensor:
    """Per-row ascending unique values (``np.unique`` semantics, reference's
    typed aid subsets — src/covisitation/inference.py:148-151), padded with -1
    to width ``u``."""
    v = torch.where(valid & (values >= 0), values, _BIG)
    sv = torch.sort(v, dim=1).values
    head = torch.ones_like(sv, dtype=torch.bool)
    head[:, 1:] = sv[:, 1:] != sv[:, :-1]
    out = torch.where(head & (sv < _BIG), sv, _BIG)
    out = torch.sort(out, dim=1).values[:, :u]
    return torch.where(out < _BIG, out, -1).to(torch.int32)


def gather_neighbors(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Gather neighbor rows for per-session query aids.

    table: int32 [n_aids, K] padded -1; queries: int32 [S, U] padded -1.
    Returns int32 [S, U*K]: table[q] flattened per row, -1 where the query was
    padding.  Replaces the reference's per-aid dict lookups + list chaining
    (``itertools.chain(*[covisit[aid] for aid in ...])``)."""
    S, U = queries.shape
    rows = table[queries.clamp(0, table.shape[0] - 1).long()]  # [S, U, K]
    rows = torch.where((queries >= 0)[:, :, None], rows, -1)
    return rows.reshape(S, U * table.shape[1])
