"""Frequency statistics + the aid-frequency baseline.

Port of ``otto_tpu/models/frequency.py``.  Replaces
src/baseline/frequency_statistics.py (global and per-event-type top-20 most
frequent aids over train/test/all, persisted as JSON keyed by aid) and
src/baseline/aid_frequency.py (predict the session's distinct aids in
first-seen order padded with the global per-type top-20).

Counting is one ``index_add_`` over the flat aid column onto the aid axis,
then a stable descending sort: ``jax.lax.top_k`` breaks ties toward the
lower aid and ``torch.topk`` promises no tie order, so the top-k is the head
of a stable sort.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.data.events import EventStore, PackedSessions
from otto_tpu_torch.ops.sessions import distinct_first_seen
from otto_tpu_torch.utils.runtime import resolve_device


def aid_counts(aids: torch.Tensor, n_aids: int,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """float32 [n_aids]: the summed weight (default 1) of each aid."""
    w = torch.ones(aids.shape, dtype=torch.float32, device=aids.device) if weights is None \
        else weights
    return torch.zeros(n_aids, dtype=torch.float32, device=aids.device).index_add_(
        0, aids.long(), w)


def _top_k(counts: torch.Tensor, k: int):
    """(values, indices) of the k largest counts, ties to the lower index."""
    v, i = torch.sort(counts, descending=True, stable=True)
    return v[:k].cpu().numpy(), i[:k].to(torch.int32).cpu().numpy()


@dataclass
class FrequencyStatistics:
    """Top-k most frequent aids, globally and per event type."""

    top_all: np.ndarray  # [k] aids
    top_by_type: dict[str, np.ndarray]  # 'clicks'/'carts'/'orders' -> [k]
    counts_all: np.ndarray
    counts_by_type: dict[str, np.ndarray]

    @classmethod
    def compute(cls, store: EventStore, n_aids: int, k: int = TOP_K, *,
                device: str | torch.device) -> "FrequencyStatistics":
        dev = resolve_device(device)
        aids = torch.as_tensor(store.aid, device=dev)
        types = torch.as_tensor(store.type, device=dev)
        counts_all, top_all = _top_k(aid_counts(aids, n_aids), k)
        top_by_type, counts_by_type = {}, {}
        for t, name in enumerate(EVENT_TYPES):
            counts_by_type[name], top_by_type[name] = _top_k(
                aid_counts(aids[types == t], n_aids), k)
        return cls(top_all=top_all, top_by_type=top_by_type, counts_all=counts_all,
                   counts_by_type=counts_by_type)

    # JSON layout mirrors the reference's aid_frequencies files:
    # {"<aid>": count, ...} ordered by descending count
    # (src/baseline/frequency_statistics.py:44-52).
    def save(self, directory: str | Path, prefix: str = "all") -> None:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        k = len(self.top_all)
        with open(directory / f"{prefix}_{k}_most_frequent_aids.json", "w") as f:
            json.dump({str(int(a)): int(c) for a, c in zip(self.top_all, self.counts_all)}, f, indent=2)
        for name in EVENT_TYPES:
            singular = {"clicks": "click", "carts": "cart", "orders": "order"}[name]
            with open(directory / f"{prefix}_{k}_most_frequent_{singular}_aids.json", "w") as f:
                json.dump(
                    {
                        str(int(a)): int(c)
                        for a, c in zip(self.top_by_type[name], self.counts_by_type[name])
                    },
                    f,
                    indent=2,
                )

    @classmethod
    def load(cls, directory: str | Path, prefix: str = "all", k: int = TOP_K) -> "FrequencyStatistics":
        directory = Path(directory)
        with open(directory / f"{prefix}_{k}_most_frequent_aids.json") as f:
            d = json.load(f)
        top_all = np.array([int(a) for a in d], dtype=np.int32)
        counts_all = np.array(list(d.values()), dtype=np.float32)
        top_by_type, counts_by_type = {}, {}
        for name in EVENT_TYPES:
            singular = {"clicks": "click", "carts": "cart", "orders": "order"}[name]
            with open(directory / f"{prefix}_{k}_most_frequent_{singular}_aids.json") as f:
                d = json.load(f)
            top_by_type[name] = np.array([int(a) for a in d], dtype=np.int32)
            counts_by_type[name] = np.array(list(d.values()), dtype=np.float32)
        return cls(top_all, top_by_type, counts_all, counts_by_type)


def _fill_with_global(session_preds: torch.Tensor, global_top: torch.Tensor) -> torch.Tensor:
    """Append ``global_top[: k - n_session_aids]`` after the session's own
    predictions (no dedup — reference semantics,
    src/baseline/aid_frequency.py:48-50)."""
    K = session_preds.shape[1]
    n_own = (session_preds >= 0).sum(dim=1)  # session preds are front-packed
    col = torch.arange(K, device=session_preds.device)[None, :]
    filler = global_top[(col - n_own[:, None]).clamp(0, K - 1)]
    return torch.where(session_preds >= 0, session_preds, filler).to(torch.int32)


def aid_frequency_predictions(packed: PackedSessions, stats: FrequencyStatistics,
                              k: int = TOP_K, *,
                              device: str | torch.device) -> dict[str, np.ndarray]:
    """The aid-frequency baseline: distinct session aids (first-seen order)
    padded with the per-type global top-k."""
    dev = resolve_device(device)
    own = distinct_first_seen(torch.as_tensor(packed.aids, device=dev),
                              torch.as_tensor(packed.mask, device=dev), k=k)
    return {name: _fill_with_global(
                own, torch.as_tensor(stats.top_by_type[name][:k], device=dev)).cpu().numpy()
            for name in EVENT_TYPES}
