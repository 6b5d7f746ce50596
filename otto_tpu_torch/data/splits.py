"""Train / validation split construction.

Copied from ``otto_tpu/data/splits.py`` (numpy only); imports name this package.

Mirrors the reference's protocol: the last train week (sessions with id >=
``validation_session_cutoff``) is carved out as local validation
(src/validation.py:61, src/utilities/train_dataset_writer_parquet.py:14);
validation sessions are truncated at a random cutoff (keeping >=1 trailing
click) and the tail becomes the ground truth.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.labels import SessionLabels, build_labels, random_cutoffs


@dataclass
class ValidationSplit:
    train: EventStore  # first weeks, full sessions
    val_input: EventStore  # truncated last-week sessions (model input)
    val_labels: SessionLabels  # ground truth from the truncated tails
    cutoffs: np.ndarray  # per-val-session cutoff indices


def make_validation_split(
    store: EventStore, validation_session_cutoff: int, seed: int = 42
) -> ValidationSplit:
    rng = np.random.default_rng(seed)
    train = store.sessions_between(hi=validation_session_cutoff)
    val_full = store.sessions_between(lo=validation_session_cutoff)
    cutoffs = random_cutoffs(val_full, rng)
    val_input = val_full.truncate(cutoffs)
    labels = build_labels(val_full, cutoffs)
    return ValidationSplit(train=train, val_input=val_input, val_labels=labels, cutoffs=cutoffs)


def split_by_fraction(store: EventStore, val_fraction: float = 0.1, seed: int = 42) -> ValidationSplit:
    """Synthetic-data helper: the session-id cutoff that leaves ~val_fraction
    of sessions in validation.

    .. warning:: This splits by **session-id order**, mirroring the reference's
       ``session >= 11098528`` convention (src/validation.py:61), which is only
       a *temporal* split when session ids were assigned chronologically (true
       for OTTO; true for :func:`otto_tpu_torch.data.synthetic.synthetic_events_v2`
       with its id/time alignment; NOT true for arbitrary shuffled inputs).
       For data without that guarantee use :func:`split_by_time`, which splits
       on session start timestamps directly.
    """
    k = int(store.n_sessions * (1 - val_fraction))
    cutoff = int(store.session_ids[min(k, store.n_sessions - 1)])
    return make_validation_split(store, cutoff, seed=seed)


def split_by_time(store: EventStore, val_fraction: float = 0.1, seed: int = 42) -> ValidationSplit:
    """Temporal split on session **start timestamps**: the most recent
    ``val_fraction`` of sessions (by first-event time) become validation,
    regardless of how session ids were assigned.  This is the semantically
    faithful version of the reference's last-week carve-out
    (src/utilities/train_dataset_writer_parquet.py:14) for inputs whose ids
    are not chronological."""
    rng = np.random.default_rng(seed)
    start_ts = store.ts[store.offsets[:-1]]
    threshold = np.quantile(start_ts, 1.0 - val_fraction, method="higher")
    val_mask = start_ts >= threshold
    train = store.select_sessions(~val_mask)
    val_full = store.select_sessions(val_mask)
    cutoffs = random_cutoffs(val_full, rng)
    val_input = val_full.truncate(cutoffs)
    labels = build_labels(val_full, cutoffs)
    return ValidationSplit(train=train, val_input=val_input, val_labels=labels, cutoffs=cutoffs)
