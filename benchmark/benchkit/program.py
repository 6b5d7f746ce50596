"""What the drivers take from the program: its configuration object and its
event store, built from the benchmark's own inputs."""

from __future__ import annotations

import numpy as np

from benchkit.generator import events_v2


def sequence_config(cfg: dict, seed: int, epochs: int = 1):
    """The port's ``SequenceModelConfig`` for a configuration file."""
    from otto_tpu_torch.config import SequenceModelConfig

    if cfg["architecture"] == "transformer" and cfg["ffn_dim"] != 4 * cfg["dim"]:
        raise ValueError("the port's transformer FFN is 4 * dim wide")
    return SequenceModelConfig(
        n_aids=cfg["n_aids"], dim=cfg["dim"], hidden=cfg.get("hidden", 128),
        max_len=cfg["max_len"], batch_size=cfg["batch_size"],
        learning_rate=cfg["learning_rate"], epochs=epochs, n_negatives=cfg["n_negatives"],
        seed=seed, architecture=cfg["architecture"], loss=cfg["loss"],
        n_layers=cfg.get("n_layers", 2), n_heads=cfg.get("n_heads", 2))


def event_store(traffic: dict, n_aids: int, n_sessions: int, seed: int):
    """The port's ``EventStore`` over the generator's events for ``seed``
    (the generator's stream is seeded apart from the program's)."""
    from otto_tpu_torch.data.events import EventStore

    cols = events_v2(n_sessions=n_sessions, n_aids=n_aids, mean_length=traffic["mean_length"],
                     max_length=traffic["max_length"], weeks=traffic["weeks"],
                     drift_sigma=traffic["drift_sigma"],
                     burst_fraction=traffic["burst_fraction"], seed=[seed, 1])
    return EventStore.from_flat(*cols, assume_sorted=True)


def distinct_counts(aid: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Distinct aids of each session."""
    sess = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    pairs = np.unique(sess.astype(np.int64) * (1 << 32) + aid.astype(np.int64))
    return np.bincount((pairs >> 32).astype(np.int64), minlength=len(offsets) - 1)
