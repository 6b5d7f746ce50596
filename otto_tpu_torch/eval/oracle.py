"""Reference-semantics oracle (host-side, per-session Python loops).

Port of ``otto_tpu/eval/oracle.py`` (Python lists and ``Counter``, copied).

A deliberate, literal re-implementation of the reference pipeline's scoring
logic — NOT the device path — used to *measure* (rather than assert) parity of
the framework's batched kernels:

- :func:`oracle_heuristic` re-implements the covisitation heuristic
  recommender, both routes (src/covisitation/inference.py:128-247): the
  >=20-distinct-aid routing, the typed log-recency Counter with fastText and
  covisitation bonuses (+0.05/+0.15), the covisitation vote Counter with the
  reference's exact list concatenation order, the top-20-then-exclude filter,
  and the session->votes->global-frequency padding cascade (:238-243).
- :func:`oracle_regular_candidates` re-implements the production candidate
  generator (src/ranker/regular_candidate_generation.py:138-197): recency
  dedup of session aids with descending-rank scores, 7-list covisitation
  votes, ``Counter.most_common(100)`` then session-aid exclusion, kNN of the
  last aid.
- :func:`corpus_recall` re-implements the vectorized corpus-level recall with
  the clip(0,20) denominator (src/covisitation/inference.py:251-257).

Everything runs on Python lists + ``collections.Counter`` so tie-breaking
matches CPython's insertion-order semantics exactly (the subtle part:
``Counter.most_common`` is a stable sort by count, so ties keep first-insertion
order).  Weights are float64, as in the reference's numpy code.

Held equal to the JAX package's copy by ``tests/test_torch_utils.py``.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from otto_tpu_torch import EVENT_TYPES
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.labels import SessionLabels

EVENT_TYPE_COEFFICIENT = {0: 1, 1: 9, 2: 6}  # covisitation/inference.py:72


# --------------------------------------------------------------------- inputs
def store_to_lists(store: EventStore) -> tuple[list[list[int]], list[list[int]]]:
    """Per-session (aids, types) Python lists — the reference's
    ``groupby('session').agg(list)`` view."""
    aids = store.aid.tolist()
    types = store.type.tolist()
    off = store.offsets.tolist()
    aid_lists = [aids[off[i] : off[i + 1]] for i in range(store.n_sessions)]
    type_lists = [types[off[i] : off[i + 1]] for i in range(store.n_sessions)]
    return aid_lists, type_lists


def table_to_dict(table: np.ndarray, k: int | None = None) -> dict[int, list[int]]:
    """Dense [n_aids, K] neighbor table -> the reference's dict-of-lists
    (covisitation_df_to_dict, src/covisitation/inference.py:19-35).  Rows with
    no neighbors are absent from the dict (the reference's ``if aid in ...``
    membership test)."""
    if k is not None:
        table = table[:, :k]
    out: dict[int, list[int]] = {}
    nz = np.flatnonzero((table >= 0).any(axis=1))
    for a in nz.tolist():
        row = [int(x) for x in table[a] if x >= 0]
        if row:
            out[a] = row
    return out


def neighbor_lists(ft_table: np.ndarray) -> list[list[int]]:
    """[n_aids, NN] kNN table -> per-aid neighbor lists (query excluded
    upstream, mirroring ``get_nns_by_item(...)[1:]``)."""
    return [[int(x) for x in row if x >= 0] for row in ft_table]


def labels_to_lists(labels: SessionLabels):
    """(click scalar, cart list, order list) per session."""
    S = labels.n_sessions
    cf, co = labels.cart_flat.tolist(), labels.cart_offsets.tolist()
    of, oo = labels.order_flat.tolist(), labels.order_offsets.tolist()
    click = labels.click.tolist()
    return (
        [[click[i]] if click[i] >= 0 else [] for i in range(S)],
        [cf[co[i] : co[i + 1]] for i in range(S)],
        [of[oo[i] : oo[i + 1]] for i in range(S)],
    )


# ------------------------------------------------------------------ heuristic
def _typed_subsets(session_aids, session_types):
    """The reference's per-session aid subsets (inference.py:147-151,208-213):
    recency-first dedup of all aids, and ``np.unique`` (ascending) typed sets."""
    unique_recency = list(dict.fromkeys(session_aids[::-1]))
    clicks = sorted({a for a, t in zip(session_aids, session_types) if t == 0})
    click_cart = sorted({a for a, t in zip(session_aids, session_types) if t <= 1})
    cart_order = sorted({a for a, t in zip(session_aids, session_types) if t >= 1})
    return unique_recency, clicks, click_cart, cart_order


def _chain(table: dict[int, list[int]], aids: list[int]) -> list[int]:
    """``itertools.chain(*[table[aid] for aid in aids if aid in table])``."""
    out: list[int] = []
    for a in aids:
        row = table.get(a)
        if row is not None:
            out.extend(row)
    return out


def oracle_heuristic(
    aid_lists: list[list[int]],
    type_lists: list[list[int]],
    tables: dict[str, dict[int, list[int]]],
    freq_top: dict[str, list[int]],
    ft_neighbors: list[list[int]] | None,
) -> dict[str, list[list[int]]]:
    """The full covisitation heuristic recommender
    (src/covisitation/inference.py:128-247 semantics).

    ``tables`` holds the seven narrow (top-15) covisitation dicts;
    ``ft_neighbors[aid]`` is the 45-neighbor kNN list of ``aid`` (the
    reference's ``get_nns_by_item(last_aid, n=46)[1:]``), or None to run
    without the embedding bonuses.
    """
    preds = {etype: [] for etype in EVENT_TYPES}
    t_time = tables["time_weighted"]
    t_clickw = tables["click_weighted"]
    t_cartw = tables["cart_weighted"]
    t_clickcart = tables["click_cart"]
    t_cartorder = tables["cart_order"]

    for session_aids, session_types in zip(aid_lists, type_lists):
        uniq, uniq_click, uniq_clickcart, uniq_cartorder = _typed_subsets(
            session_aids, session_types
        )
        similar = ft_neighbors[session_aids[-1]] if ft_neighbors is not None else []

        if len(set(session_aids)) >= 20:
            # ---- recency-weight route (inference.py:143-199) -------------
            n = len(session_aids)
            w_click = np.logspace(0.1, 1, n, base=2, endpoint=True) - 1
            w_cartorder = np.logspace(0.5, 1, n, base=2, endpoint=True) - 1
            c_click: Counter = Counter()
            c_cart: Counter = Counter()
            c_order: Counter = Counter()
            for a, t, wc, wco in zip(session_aids, session_types, w_click, w_cartorder):
                coeff = EVENT_TYPE_COEFFICIENT[t]
                c_click[a] += wc * coeff
                c_cart[a] += wco * coeff
                c_order[a] += wco * coeff
            for a in similar:
                c_click[a] += 0.05
                c_cart[a] += 0.05
                c_order[a] += 0.15
            for a in _chain(t_time, uniq_click):
                c_click[a] += 0.05
            for a in _chain(t_cartw, uniq_clickcart):
                c_cart[a] += 0.05
            for a in _chain(t_cartorder, uniq_cartorder):
                c_order[a] += 0.15
            preds["clicks"].append([a for a, _ in c_click.most_common(20)])
            preds["carts"].append([a for a, _ in c_cart.most_common(20)])
            preds["orders"].append([a for a, _ in c_order.most_common(20)])
        else:
            # ---- covisitation-vote route (inference.py:204-247) ----------
            l_time = _chain(t_time, uniq)
            l_clickw = _chain(t_clickw, uniq_clickcart)
            l_cartw = _chain(t_cartw, uniq_clickcart)
            l_clickcart = _chain(t_clickcart, uniq_clickcart)
            l_cartorder = _chain(t_cartorder, uniq_clickcart)

            votes = {
                "clicks": l_time + l_clickw + l_cartw + l_clickcart + l_cartorder + similar,
                "carts": l_time + l_cartw + l_cartorder + similar,
                "orders": l_time + l_cartw + l_cartorder + similar,
            }
            uniq_set = set(uniq)
            for etype in EVENT_TYPES:
                top = [a for a, _ in Counter(votes[etype]).most_common(20) if a not in uniq_set]
                p = uniq + top[: 20 - len(uniq)]
                p = p + freq_top[etype][: 20 - len(p)]
                preds[etype].append(p)
    return preds


# ----------------------------------------------------------- regular candgen
def oracle_regular_candidates(
    aid_lists: list[list[int]],
    type_lists: list[list[int]],
    tables: dict[str, dict[int, list[int]]],
    ft_neighbors: list[list[int]] | None,
    top_n: int = 100,
) -> dict[str, tuple[list[list[int]], list[list[float]]]]:
    """The production candidate generator
    (src/ranker/regular_candidate_generation.py:138-197 semantics): per event
    type, candidates = session unique aids (recency order, scores = descending
    ranks) + covisitation-vote ``most_common(top_n)`` excluding session aids
    (scores = vote counts).  ``tables`` holds the *wide* covisitation dicts;
    ``ft_neighbors`` the 20-neighbor kNN lists (``n=21`` in validation mode).
    """
    out = {etype: ([], []) for etype in EVENT_TYPES}
    t_time = tables["time_weighted"]
    t_clickw = tables["click_weighted"]
    t_cartw = tables["cart_weighted"]
    t_clickcart = tables["click_cart"]
    t_cartorder = tables["cart_order"]

    for session_aids, session_types in zip(aid_lists, type_lists):
        uniq, _, uniq_clickcart, uniq_cartorder = _typed_subsets(session_aids, session_types)
        similar = ft_neighbors[session_aids[-1]] if ft_neighbors is not None else []

        l_time = _chain(t_time, uniq)
        l_clickw = _chain(t_clickw, uniq_clickcart)
        l_cartw = _chain(t_cartw, uniq_clickcart)
        l_clickcart = _chain(t_clickcart, uniq_clickcart)
        l_cartorder = _chain(t_cartorder, uniq_clickcart)

        votes = {
            "clicks": l_time + l_clickw + l_cartw + l_clickcart + l_cartorder + similar,
            "carts": l_time + l_cartw + l_cartorder + similar,
            "orders": l_time + l_cartw + l_cartorder + similar,
        }
        uniq_set = set(uniq)
        hist_scores = list(range(len(uniq), 0, -1))  # np.arange(1,n+1)[::-1]
        for etype in EVENT_TYPES:
            pairs = [
                (a, w) for a, w in Counter(votes[etype]).most_common(top_n) if a not in uniq_set
            ]
            out[etype][0].append(uniq + [a for a, _ in pairs])
            out[etype][1].append(hist_scores + [float(w) for _, w in pairs])
    return out


# -------------------------------------------------------------------- metric
def corpus_recall(preds: list[list[int]], labels: list[list[int]]) -> float:
    """Corpus-level recall@20 with the clip(0,20) denominator
    (src/covisitation/inference.py:251-257)."""
    hits = 0
    denom = 0
    for p, l in zip(preds, labels):
        if not l:
            continue
        hits += len(set(p) & set(l))
        denom += min(len(l), 20)
    return hits / max(denom, 1)


def weighted_corpus_recall(preds: dict[str, list[list[int]]], label_lists) -> dict[str, float]:
    click_l, cart_l, order_l = label_lists
    r = {
        "clicks": corpus_recall(preds["clicks"], click_l),
        "carts": corpus_recall(preds["carts"], cart_l),
        "orders": corpus_recall(preds["orders"], order_l),
    }
    r["weighted"] = 0.1 * r["clicks"] + 0.3 * r["carts"] + 0.6 * r["orders"]
    return r
