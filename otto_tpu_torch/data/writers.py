"""Chunked dataset writers.

Copied from ``otto_tpu/data/writers.py`` (numpy, pyarrow).  They replace
src/utilities/train_dataset_writer_parquet.py and
split_dataset_writer_parquet.py: write an EventStore as parquet chunks of
``chunk_sessions`` sessions (the reference's 100k-session chunking,
train_dataset_writer_parquet.py:42-50), and build the truncated-train dataset
(last-week sessions cut at their sampled cutoff, concatenated with the
earlier weeks).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.labels import random_cutoffs
from otto_tpu_torch.logging_utils import get_logger

log = get_logger(__name__)


def write_chunked_parquet(
    store: EventStore, directory: str | Path, prefix: str = "events",
    chunk_sessions: int = 100_000,
) -> list[Path]:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, start in enumerate(range(0, store.n_sessions, chunk_sessions)):
        sub = store.select_sessions(
            np.arange(start, min(start + chunk_sessions, store.n_sessions))
        )
        p = directory / f"{prefix}_{i}.parquet"
        sub.to_parquet(p)
        paths.append(p)
    log.info("wrote %d parquet chunks to %s", len(paths), directory)
    return paths


def read_chunked_parquet(directory: str | Path, prefix: str = "events") -> EventStore:
    import pyarrow.parquet as pq

    directory = Path(directory)
    paths = sorted(directory.glob(f"{prefix}_*.parquet"),
                   key=lambda p: int(p.stem.rsplit("_", 1)[1]))
    cols = {"session": [], "aid": [], "ts": [], "type": []}
    for p in paths:
        t = pq.read_table(p)
        for c in cols:
            cols[c].append(t[c].to_numpy())
    return EventStore.from_flat(
        np.concatenate(cols["session"]),
        np.concatenate(cols["aid"]),
        np.concatenate(cols["ts"]),
        np.concatenate(cols["type"]),
    )


def truncated_train_store(
    store: EventStore, validation_session_cutoff: int, seed: int = 42
) -> EventStore:
    """The reference's truncated training dataset: last-week sessions cut at
    the sampled cutoff, earlier weeks kept whole
    (train_dataset_writer_parquet.py:10-40)."""
    early = store.sessions_between(hi=validation_session_cutoff)
    late = store.sessions_between(lo=validation_session_cutoff)
    rng = np.random.default_rng(seed)
    cut = late.truncate(random_cutoffs(late, rng))
    return EventStore.from_flat(
        np.concatenate([early.session_ids[early.session_idx], cut.session_ids[cut.session_idx]]),
        np.concatenate([early.aid, cut.aid]),
        np.concatenate([early.ts, cut.ts]),
        np.concatenate([early.type, cut.type]),
    )
