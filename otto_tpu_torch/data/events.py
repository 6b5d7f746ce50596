"""Columnar event store.

Copied from ``otto_tpu/data/events.py`` (numpy only); imports name this package.
:meth:`EventStore.select_sessions` and :meth:`EventStore.pack` open the
profiler spans ``otto::sessions.select`` and ``otto::sessions.pack``
(:func:`otto_tpu_torch.utils.profiling.span`).

The reference represents OTTO data as pandas DataFrames of event rows
``(session: uint32, aid: uint32, ts: uint64, type: uint8)`` (reference:
src/utilities/dataset_writer_pickle.py:29-60) and re-aggregates them into
per-session Python lists at every consumer (``groupby('session').agg(list)``).

Here the canonical representation is TPU-shaped from the start:

- flat, dtype-tight numpy columns sorted by ``(session, ts, arrival order)``
- a CSR ``offsets`` array delimiting sessions (no per-session Python objects)
- :meth:`EventStore.pack` produces fixed-shape ``[n_sessions, max_len]``
  padded+masked arrays that jit-compiled kernels consume directly

All host-side preparation is vectorized numpy; nothing iterates per session.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from otto_tpu_torch.utils.profiling import span


@dataclass
class PackedSessions:
    """Dense ``[n_sessions, max_len]`` view of ragged sessions.

    ``keep='last'`` keeps the most recent ``max_len`` events (retrieval-style
    consumers care about recency); ``keep='first'`` keeps the earliest.
    Padding positions have ``mask == False`` and ``aid == 0``.
    """

    aids: np.ndarray  # int32 [S, L]
    types: np.ndarray  # int8  [S, L]
    ts: np.ndarray  # int64 [S, L]
    mask: np.ndarray  # bool  [S, L]
    lengths: np.ndarray  # int32 [S] true (unclipped) session lengths
    session_ids: np.ndarray  # int64 [S] original session ids

    @property
    def n_sessions(self) -> int:
        return self.aids.shape[0]

    @property
    def max_len(self) -> int:
        return self.aids.shape[1]


class EventStore:
    """Flat (session_idx, aid, ts, type) columns + CSR session offsets."""

    __slots__ = ("session_idx", "aid", "ts", "type", "offsets", "session_ids")

    def __init__(self, session_idx, aid, ts, type_, offsets, session_ids):
        self.session_idx = session_idx
        self.aid = aid
        self.ts = ts
        self.type = type_
        self.offsets = offsets
        self.session_ids = session_ids

    # ------------------------------------------------------------------ build
    @classmethod
    def from_flat(cls, session: np.ndarray, aid: np.ndarray, ts: np.ndarray,
                  type_: np.ndarray, assume_sorted: bool = False) -> "EventStore":
        """Build from flat event columns keyed by raw session id.

        Events are stably sorted by ``(session, ts)`` — the ordering every
        reference consumer establishes with ``sort_values(['session','ts'])``
        (e.g. src/ranker/aid_feature_engineering.py:40).
        """
        session = np.asarray(session, dtype=np.int64)
        aid = np.asarray(aid, dtype=np.int32)
        ts = np.asarray(ts, dtype=np.int64)
        type_ = np.asarray(type_, dtype=np.int8)
        if not assume_sorted:
            order = np.lexsort((ts, session))
            session, aid, ts, type_ = session[order], aid[order], ts[order], type_[order]
        session_ids, session_idx, counts = np.unique(session, return_inverse=True, return_counts=True)
        offsets = np.zeros(len(session_ids) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return cls(session_idx.astype(np.int32), aid, ts, type_, offsets, session_ids)

    def save_npz(self, path) -> None:
        """Raw column dump (uncompressed: ~17 B/event, reload is a mmap-speed
        read).  For caching multi-hundred-million-event synthetic corpora
        across tools — the 216.7M-event datagen costs ~12 min of 2-core CPU."""
        np.savez(path, session_idx=self.session_idx, aid=self.aid, ts=self.ts,
                 type=self.type, offsets=self.offsets,
                 session_ids=self.session_ids)

    @classmethod
    def load_npz(cls, path) -> "EventStore":
        z = np.load(path)
        return cls(z["session_idx"], z["aid"], z["ts"], z["type"],
                   z["offsets"], z["session_ids"])

    @classmethod
    def from_parquet(cls, path) -> "EventStore":
        import pyarrow.parquet as pq

        t = pq.read_table(path, columns=["session", "aid", "ts", "type"])
        return cls.from_flat(
            t["session"].to_numpy(), t["aid"].to_numpy(), t["ts"].to_numpy(), t["type"].to_numpy()
        )

    def to_parquet(self, path) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        pq.write_table(
            pa.table(
                {
                    "session": self.session_ids[self.session_idx],
                    "aid": self.aid,
                    "ts": self.ts,
                    "type": self.type.astype(np.int8),
                }
            ),
            path,
        )

    # ------------------------------------------------------------- properties
    @property
    def n_events(self) -> int:
        return len(self.aid)

    @property
    def n_sessions(self) -> int:
        return len(self.session_ids)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    @property
    def position_in_session(self) -> np.ndarray:
        """0-based event position within its session."""
        return (np.arange(self.n_events, dtype=np.int64) - self.offsets[self.session_idx]).astype(
            np.int32
        )

    # ------------------------------------------------------------- selection
    def select_sessions(self, keep: np.ndarray) -> "EventStore":
        """Subset sessions by boolean mask or index array over session axis."""
        with span("otto::sessions.select"):
            keep = np.asarray(keep)
            if keep.dtype == bool:
                keep = np.flatnonzero(keep)
            event_mask = np.isin(self.session_idx, keep)
            # Re-index sessions compactly while preserving order.
            return EventStore.from_flat(
                self.session_ids[self.session_idx[event_mask]],
                self.aid[event_mask],
                self.ts[event_mask],
                self.type[event_mask],
                assume_sorted=True,
            )

    def sessions_between(self, lo: int | None = None, hi: int | None = None) -> "EventStore":
        """Sessions with ``lo <= session_id < hi`` (either bound optional)."""
        m = np.ones(self.n_sessions, dtype=bool)
        if lo is not None:
            m &= self.session_ids >= lo
        if hi is not None:
            m &= self.session_ids < hi
        return self.select_sessions(m)

    def truncate(self, cutoff_idx: np.ndarray) -> "EventStore":
        """Keep events with position <= per-session ``cutoff_idx`` (inclusive),
        mirroring the reference's input construction
        ``row['aid'][:cutoff+1]`` (src/baseline/aid_weight.py:38)."""
        keep = self.position_in_session <= cutoff_idx[self.session_idx]
        return EventStore.from_flat(
            self.session_ids[self.session_idx[keep]],
            self.aid[keep],
            self.ts[keep],
            self.type[keep],
            assume_sorted=True,
        )

    def tail_after(self, cutoff_idx: np.ndarray) -> "EventStore":
        """Events strictly after the per-session cutoff (the label side).
        Sessions whose tail is empty are dropped."""
        keep = self.position_in_session > cutoff_idx[self.session_idx]
        return EventStore.from_flat(
            self.session_ids[self.session_idx[keep]],
            self.aid[keep],
            self.ts[keep],
            self.type[keep],
            assume_sorted=True,
        )

    # --------------------------------------------------------------- packing
    def pack(self, max_len: int, keep: str = "last") -> PackedSessions:
        with span("otto::sessions.pack"):
            lengths = self.lengths
            L = int(max_len)
            S = self.n_sessions
            clipped = np.minimum(lengths, L)
            pos = self.position_in_session
            if keep == "last":
                # shift each session so its last event lands at column clipped-1
                col = pos - (lengths[self.session_idx] - clipped[self.session_idx])
            elif keep == "first":
                col = pos
            else:
                raise ValueError(f"keep must be 'last' or 'first', got {keep!r}")
            sel = (col >= 0) & (col < L)
            rows = self.session_idx[sel].astype(np.int64)
            cols = col[sel].astype(np.int64)
            flat = rows * L + cols

            aids = np.zeros(S * L, dtype=np.int32)
            types = np.zeros(S * L, dtype=np.int8)
            ts = np.zeros(S * L, dtype=np.int64)
            mask = np.zeros(S * L, dtype=bool)
            aids[flat] = self.aid[sel]
            types[flat] = self.type[sel]
            ts[flat] = self.ts[sel]
            mask[flat] = True
            return PackedSessions(
                aids=aids.reshape(S, L),
                types=types.reshape(S, L),
                ts=ts.reshape(S, L),
                mask=mask.reshape(S, L),
                lengths=lengths,
                session_ids=self.session_ids,
            )

    def length_buckets(self, edges=(16, 64, 256)) -> list[np.ndarray]:
        """Session index groups by length for bucketed fixed-shape kernels.
        Returns one index array per bucket; bucket i holds sessions with
        ``edges[i-1] < len <= edges[i]`` (last bucket unbounded)."""
        lengths = self.lengths
        groups = []
        lo = 0
        for e in edges:
            groups.append(np.flatnonzero((lengths > lo) & (lengths <= e)))
            lo = e
        groups.append(np.flatnonzero(lengths > lo))
        return groups

    # ------------------------------------------------------------------ misc
    def last_aid(self) -> np.ndarray:
        """Most recent aid of each session (fastText kNN anchor in the
        reference, e.g. src/covisitation/inference.py:166)."""
        return self.aid[self.offsets[1:] - 1]

    def __repr__(self) -> str:
        return f"EventStore(n_events={self.n_events}, n_sessions={self.n_sessions})"
