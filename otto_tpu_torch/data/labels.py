"""Ground-truth label construction.

Copied from ``otto_tpu/data/labels.py`` (numpy only); imports name this package.

Reproduces the reference's label semantics (src/validation.py:9-52) without
the per-session Python reversed scan: for a session cut at event index ``k``
(events ``0..k`` are the model input),

- the **click label** is the aid of the *first* click event strictly after ``k``
  (the reversed scan's ``previous_click`` at position ``k`` — the earliest
  later event wins because it overwrites last),
- the **cart labels** are all distinct aids carted strictly after ``k``,
- the **order labels** are all distinct aids ordered strictly after ``k``.

Cutoff sampling mirrors src/validation.py:71-90: 2-event sessions split in the
middle; otherwise a uniform cutoff in ``[0, last_click_idx)`` so at least one
trailing click remains.

Everything is vectorized numpy over the flat event columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from otto_tpu_torch.data.events import EventStore


@dataclass
class SessionLabels:
    """Per-session ground truth, ragged storage.

    ``click`` is ``-1`` when a session has no click label (then the session is
    excluded from the click metric — NaN semantics of src/metrics.py:23).
    Cart/order labels are CSR flat+offsets over the same session ordering as
    the originating :class:`EventStore`.
    """

    session_ids: np.ndarray  # int64 [S]
    click: np.ndarray  # int32 [S], -1 = no label
    cart_flat: np.ndarray  # int32 [nnz_cart]
    cart_offsets: np.ndarray  # int64 [S+1]
    order_flat: np.ndarray  # int32 [nnz_order]
    order_offsets: np.ndarray  # int64 [S+1]

    @property
    def n_sessions(self) -> int:
        return len(self.session_ids)

    @property
    def cart_counts(self) -> np.ndarray:
        return np.diff(self.cart_offsets).astype(np.int32)

    @property
    def order_counts(self) -> np.ndarray:
        return np.diff(self.order_offsets).astype(np.int32)

    def padded(self, kind: str, max_labels: int | None = None) -> np.ndarray:
        """Dense ``[S, M]`` int32 label matrix padded with -1 (device-friendly)."""
        if kind == "carts":
            flat, offsets = self.cart_flat, self.cart_offsets
        elif kind == "orders":
            flat, offsets = self.order_flat, self.order_offsets
        elif kind == "clicks":
            return self.click.reshape(-1, 1)
        else:
            raise ValueError(kind)
        counts = np.diff(offsets)
        M = int(max_labels if max_labels is not None else max(int(counts.max(initial=0)), 1))
        S = self.n_sessions
        out = np.full((S, M), -1, dtype=np.int32)
        pos = np.arange(len(flat), dtype=np.int64) - offsets[:-1].repeat(counts)
        keep = pos < M
        rows = np.repeat(np.arange(S, dtype=np.int64), counts)[keep]
        out[rows, pos[keep]] = flat[keep]
        return out

    def take(self, idx: np.ndarray) -> "SessionLabels":
        """Row-subset of the labels (vectorized CSR gather) — used to score
        disjoint session halves (e.g. the two-stage report sessions held out
        from alpha/early-stop selection, twostage.run_two_stage)."""
        idx = np.asarray(idx, dtype=np.int64)

        def sub(flat, offsets):
            counts = np.diff(offsets)[idx]
            new_off = np.zeros(len(idx) + 1, dtype=np.int64)
            np.cumsum(counts, out=new_off[1:])
            total = int(new_off[-1])
            starts = offsets[idx]
            pos = np.arange(total, dtype=np.int64) - new_off[:-1].repeat(counts)
            gather = starts.repeat(counts) + pos
            return flat[gather], new_off

        cart_flat, cart_off = sub(self.cart_flat, self.cart_offsets)
        order_flat, order_off = sub(self.order_flat, self.order_offsets)
        return SessionLabels(
            session_ids=self.session_ids[idx],
            click=self.click[idx],
            cart_flat=cart_flat,
            cart_offsets=cart_off,
            order_flat=order_flat,
            order_offsets=order_off,
        )

    def labels_for(self, kind: str):
        """(flat, offsets) pair for carts/orders, or click array."""
        if kind == "clicks":
            return self.click
        if kind == "carts":
            return self.cart_flat, self.cart_offsets
        if kind == "orders":
            return self.order_flat, self.order_offsets
        raise ValueError(kind)


def random_cutoffs(store: EventStore, rng: np.random.Generator) -> np.ndarray:
    """Sample per-session cutoff indices (reference: src/validation.py:71-90).

    Sessions with no click at all (absent from real OTTO data, possible in
    synthetic data) fall back to ``max(len-2, 0)``.
    """
    lengths = store.lengths
    is_click = store.type == 0
    pos = store.position_in_session
    # last click position per session: max over click events, -1 if none
    last_click = np.full(store.n_sessions, -1, dtype=np.int64)
    np.maximum.at(last_click, store.session_idx[is_click], pos[is_click])

    cutoffs = np.zeros(store.n_sessions, dtype=np.int64)
    # default branch: uniform in [0, last_click_idx)
    high = np.maximum(last_click, 1)
    u = rng.random(store.n_sessions)
    cutoffs = np.floor(u * high).astype(np.int64)
    cutoffs[last_click == 0] = 0
    cutoffs[lengths == 2] = 0
    no_click = last_click < 0
    cutoffs[no_click] = np.maximum(lengths[no_click] - 2, 0)
    return cutoffs


def build_labels(store: EventStore, cutoff_idx: np.ndarray) -> SessionLabels:
    """Vectorized ground truth at the given per-session cutoffs."""
    sidx = store.session_idx
    pos = store.position_in_session
    after = pos > cutoff_idx[sidx]
    S = store.n_sessions

    # --- click: first type-0 event after the cutoff ------------------------
    click_mask = after & (store.type == 0)
    click = np.full(S, -1, dtype=np.int32)
    # events are sorted by (session, ts); first occurrence per session wins
    first_sessions, first_idx = np.unique(sidx[click_mask], return_index=True)
    click[first_sessions] = store.aid[click_mask][first_idx]

    # --- carts / orders: distinct aids after the cutoff ---------------------
    def distinct_after(type_value: int):
        m = after & (store.type == type_value)
        pairs = np.stack([sidx[m].astype(np.int64), store.aid[m].astype(np.int64)], axis=1)
        if len(pairs) == 0:
            return np.empty(0, dtype=np.int32), np.zeros(S + 1, dtype=np.int64)
        uniq = np.unique(pairs, axis=0)
        counts = np.bincount(uniq[:, 0], minlength=S)
        offsets = np.zeros(S + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return uniq[:, 1].astype(np.int32), offsets

    cart_flat, cart_offsets = distinct_after(1)
    order_flat, order_offsets = distinct_after(2)

    return SessionLabels(
        session_ids=store.session_ids.copy(),
        click=click,
        cart_flat=cart_flat,
        cart_offsets=cart_offsets,
        order_flat=order_flat,
        order_offsets=order_offsets,
    )
