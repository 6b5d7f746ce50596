"""The traffic generator: a frozen copy of the port's ``synthetic_events_v2``
(``otto_tpu_torch/data/synthetic.py``), numpy only.

The copy is the yardstick's: a later change to the program's generator does
not change the benchmark's inputs.  It returns the flat event columns
``(session, aid, ts, type)``, sorted by session and time, which the drivers
hand to the port's ``EventStore.from_flat``.  The body is the original's
line for line; only the return differs.
"""

from __future__ import annotations

import numpy as np


def events_v2(
    n_sessions: int = 1_000_000,
    n_aids: int = 100_000,
    mean_length: float = 11.0,
    max_length: int = 200,
    n_clusters: int | None = None,
    weeks: float = 4.0,
    start_ts: int = 1_659_304_800,
    drift_sigma: float = 0.35,
    burst_fraction: float = 0.05,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Realistic-scale OTTO-like generator (round-2 parity/bench substrate).

    Adds the structure the v1 generator lacked, so that (a) oracle-parity runs
    exercise every heuristic branch at scale and (b) a reranker has residual
    signal beyond the candidate prior (VERDICT.md items 1 and 4):

    - **power-law popularity**: global Zipf(~1.05) item weights;
    - **temporal drift**: per-aid weekly log-trend plus a ``burst_fraction``
      of items that spike 8x for one random week — last-week / weekly-ratio
      aid features carry real click signal;
    - **per-aid conversion propensity** (heavy-tailed, independent of
      popularity): items' cart/order rates are stable traits observable in the
      training window as cart/click ratios — aid-FE reranking signal;
    - **per-session buyer propensity**: lognormal multiplier on cart/order
      rates — session-FE signal;
    - **interaction structure**: carts echo earlier session events, orders
      preferentially echo a uniformly-random earlier *carted* aid — the
      classic "was carted in this session => will be ordered" interaction-FE
      signal, deliberately decoupled from recency so it is invisible to the
      candidate generator's recency prior (a reranker must use the cart
      features to capture it);
    - **chronological session ids**: ids are assigned in session-start order
      so the reference's id-cutoff validation protocol (src/validation.py:61)
      is a genuine temporal split here too.

    Cluster-walk co-visitation structure is kept from v1 (covisitation and
    embedding models need it).
    """
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(20, n_aids // 50)
    horizon = int(weeks * 7 * 24 * 3600)
    n_days = int(np.ceil(weeks * 7)) + 1

    # ---------------------------------------------------------------- items
    # Zipf-ish base popularity, assigned to aids in random order so aid id
    # carries no information.
    ranks = rng.permutation(n_aids)
    base_pop = (ranks + 10.0) ** -1.05

    # per-aid weekly log-trend + one-week bursts
    trend = rng.normal(0.0, drift_sigma, size=n_aids)  # log-mult per week
    burst_aids = rng.random(n_aids) < burst_fraction
    burst_week = rng.integers(0, max(int(weeks), 1), size=n_aids)

    # conversion traits: heavy-tailed, independent of popularity
    conv = rng.beta(1.2, 8.0, size=n_aids)  # mean ~0.13
    order_bias = rng.beta(2.0, 2.0, size=n_aids)  # how order-y conversions are

    # clusters: aids sorted by cluster so each cluster is a contiguous slice
    aid_cluster = rng.integers(0, n_clusters, size=n_aids)
    order = np.argsort(aid_cluster, kind="stable")
    cluster_starts = np.searchsorted(aid_cluster[order], np.arange(n_clusters + 1))
    pop_sorted = base_pop[order]  # popularity in cluster-sorted aid order

    # ------------------------------------------------------------- sessions
    lengths = np.minimum(
        2 + rng.geometric(1.0 / mean_length, size=n_sessions), max_length
    ).astype(np.int64)
    session_start = start_ts + np.sort(rng.integers(0, horizon, size=n_sessions))
    total = int(lengths.sum())
    sess_first = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    session_of = np.repeat(np.arange(n_sessions, dtype=np.int64), lengths)
    pos = np.arange(total, dtype=np.int64) - sess_first[session_of]

    gaps = rng.integers(1, 600, size=total)
    gaps[pos == 0] = 0
    gap_cum = np.cumsum(gaps)
    ts = np.repeat(session_start, lengths) + (gap_cum - gap_cum[sess_first[session_of]])
    day = np.minimum((ts - start_ts) // 86400, n_days - 1).astype(np.int64)

    def day_weights(d: int) -> np.ndarray:
        """Cluster-sorted item weights effective on day ``d``."""
        week = d / 7.0
        w = pop_sorted * np.exp(trend[order] * (week - weeks / 2.0) / max(weeks, 1.0))
        in_burst = burst_aids[order] & (burst_week[order] == min(int(week), max(int(weeks) - 1, 0)))
        return np.where(in_burst, w * 8.0, w)

    # cluster walk: stay with p=0.85, jump to a popularity-weighted cluster
    jump = (rng.random(total) < 0.15) | (pos == 0)
    cluster_draw = np.zeros(total, dtype=np.int64)
    u_cluster = rng.random(total)
    day_of_event = day
    for d in range(n_days):
        sel = np.flatnonzero(jump & (day_of_event == d))
        if not len(sel):
            continue
        w_d = day_weights(d)
        cw = np.add.reduceat(w_d, cluster_starts[:-1])
        ccdf = np.cumsum(cw)
        cluster_draw[sel] = np.searchsorted(ccdf, u_cluster[sel] * ccdf[-1], side="right")
    cluster_draw = np.minimum(cluster_draw, n_clusters - 1)
    # forward-fill jump clusters within sessions (jump at pos 0 guarantees a
    # defined value for every event)
    ff = np.maximum.accumulate(np.where(jump, np.arange(total), -1))
    ev_cluster = cluster_draw[ff]

    # within-cluster popularity draw under that day's weights (segment CDF)
    aid = np.zeros(total, dtype=np.int32)
    u_aid = rng.random(total)
    for d in range(n_days):
        sel = np.flatnonzero(day_of_event == d)
        if not len(sel):
            continue
        cdf = np.cumsum(day_weights(d))
        c = ev_cluster[sel]
        lo = np.where(cluster_starts[c] > 0, cdf[cluster_starts[c] - 1], 0.0)
        hi = cdf[cluster_starts[c + 1] - 1]
        u = lo + u_aid[sel] * np.maximum(hi - lo, 1e-12)
        idx = np.clip(
            np.searchsorted(cdf, u, side="left"), cluster_starts[c], cluster_starts[c + 1] - 1
        )
        aid[sel] = order[idx]

    # ---------------------------------------------------------------- types
    buyer = np.minimum(rng.lognormal(0.0, 0.6, size=n_sessions), 3.0)
    buyer_ev = buyer[session_of]
    p_cart = np.minimum(0.50 * conv[aid] * buyer_ev, 0.6)
    p_order = np.minimum(0.28 * conv[aid] * order_bias[aid] * buyer_ev, 0.4)
    draw = rng.random(total)
    types = np.zeros(total, dtype=np.int8)
    types[draw < p_cart + p_order] = 1
    types[draw < p_order] = 2
    types[pos == 0] = 0

    # ------------------------------------------------------------- echoes
    # carts echo a uniformly random earlier event of the session (p=.5)
    cart_echo = (types == 1) & (pos > 0) & (rng.random(total) < 0.5)
    j = sess_first[session_of] + np.floor(rng.random(total) * np.maximum(pos, 1)).astype(np.int64)
    aid[cart_echo] = aid[j[cart_echo]]

    # orders echo a uniformly-random earlier *carted* aid (p=.45), else an
    # earlier event.  Uniform (not most-recent) cart choice matters: a
    # most-recent-cart echo makes recency a sufficient statistic, leaving a
    # reranker nothing the candidate prior doesn't already order correctly;
    # a uniform cart echo makes in-session carted-ness (an interaction
    # feature) discriminative where recency is not.  Selection runs as a
    # running max of iid keys over the prefix carts (reservoir property:
    # the argmax of iid keys is uniform among them), packed per session as
    # session_id + (key<<8 | position)/2^28 — exact in float64 for
    # n_sessions < 2^24, positions < 256 (max_length <= 200).
    if n_sessions >= 1 << 24:
        raise ValueError("v2 generator supports < 2^24 sessions")
    rand20 = rng.integers(0, 1 << 20, size=total).astype(np.int64)
    key = ((rand20 << 8) | np.minimum(pos, 255)) / float(1 << 28)
    packed = np.where(types == 1, session_of + key, session_of.astype(np.float64))
    acc_excl = np.concatenate([[0.0], np.maximum.accumulate(packed)[:-1]])
    frac = acc_excl - session_of
    has_prior_cart = frac > 0
    cart_src = sess_first[session_of] + (
        np.round(frac * (1 << 28)).astype(np.int64) & 0xFF
    )
    r = rng.random(total)
    order_echo_cart = (types == 2) & has_prior_cart & (r < 0.45)
    aid[order_echo_cart] = aid[cart_src[order_echo_cart]]
    order_echo_any = (types == 2) & ~order_echo_cart & (pos > 0) & (r < 0.70)
    aid[order_echo_any] = aid[j[order_echo_any]]

    # session ids are chronological by construction; events sorted by (session, ts)
    return session_of, aid, ts, types
