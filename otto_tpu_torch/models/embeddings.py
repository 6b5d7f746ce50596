"""SGNS aid embeddings (inference) and the embedding-kNN recommender.

Port of ``otto_tpu/models/embeddings.py:580-817``: :class:`SGNSModel` for
serving (neighbor table, ``.npz`` save/load in the JAX package's own format,
construction from the JAX model's arrays), :func:`recursive_neighbors` and
:func:`embedding_knn_predictions`.  SGNS training is not ported yet.

The serving path replaces the reference's fastText + Annoy inference
(src/gensim_fasttext/inference.py:80-160).  Sessions with >= 20 distinct
aids get typed recency-weight scores (coefficients {1,6,3}, exponents
0.1..1) on the device; the rest get their ascending-unique session aids
padded with kNN neighbors of the last aid, on the host.  ``recursive``
(config nns.recursive_nns) walks the neighbor graph instead of taking one
row.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.config import SGNSConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.ops.retrieval import build_neighbor_table
from otto_tpu_torch.utils.runtime import resolve_device


@dataclass
class SGNSModel:
    """Trained SGNS tables on one device (inference only)."""

    w_in: torch.Tensor  # [n_aids, d] float32 — the "word vectors"
    w_out: torch.Tensor
    counts: torch.Tensor
    config: SGNSConfig

    @property
    def embeddings(self) -> torch.Tensor:
        return self.w_in

    @property
    def device(self) -> torch.device:
        return self.w_in.device

    def neighbor_table(self, k: int, metric: str = "euclidean", **kw) -> np.ndarray:
        return build_neighbor_table(self.w_in, k=k, metric=metric, device=self.device, **kw)

    @classmethod
    def from_jax_arrays(cls, w_in, w_out, counts, config: SGNSConfig = SGNSConfig(), *,
                        device: str | torch.device) -> "SGNSModel":
        """From the numpy arrays of an ``otto_tpu`` ``SGNSModel``."""
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        return cls(t(w_in), t(w_out), t(counts), config)

    def save(self, path) -> None:
        """The ``.npz`` that ``otto_tpu``'s ``SGNSModel.save`` writes."""
        np.savez_compressed(path, w_in=self.w_in.cpu().numpy(),
                            w_out=self.w_out.cpu().numpy(), counts=self.counts.cpu().numpy())

    @classmethod
    def load(cls, path, config: SGNSConfig = SGNSConfig(), *,
             device: str | torch.device) -> "SGNSModel":
        """Read an ``.npz`` written by either package's ``save``."""
        with np.load(path) as z:
            return cls.from_jax_arrays(z["w_in"], z["w_out"], z["counts"], config,
                                       device=device)


def recursive_neighbors(table: np.ndarray, start_aid: int, n: int,
                        exclude: set[int]) -> list[int]:
    """Greedy neighbor-graph walk: repeatedly append the nearest unseen
    neighbor of the current aid (gensim_fasttext/inference.py:124-141)."""
    out: list[int] = []
    current = start_aid
    seen = set(exclude)
    seen.add(start_aid)  # the query aid itself is never a neighbor
    for _ in range(n):
        advanced = False
        for cand in table[current]:
            cand = int(cand)
            if cand < 0 or cand in seen or cand in out:
                continue
            out.append(cand)
            seen.add(cand)
            current = cand
            advanced = True
            break
        if not advanced:
            break
    return out


def embedding_knn_predictions(
    store: EventStore,
    neighbor_table: np.ndarray,
    k: int = TOP_K,
    recursive: bool = False,
    *,
    device: str | torch.device,
) -> dict[str, np.ndarray]:
    """Full serving path of the embedding model over an EventStore; the
    recency route runs on ``device``, the kNN route on the host."""
    from otto_tpu_torch.models.covisitation import session_unique_counts
    from otto_tpu_torch.ops.sessions import recency_weighted_top_aids

    dev = resolve_device(device)
    counts = session_unique_counts(store)
    S = store.n_sessions
    preds = np.full((S, k), -1, np.int32)

    rec_idx = np.flatnonzero(counts >= 20)
    knn_idx = np.flatnonzero(counts < 20)

    if len(rec_idx):
        sub = store.select_sessions(rec_idx)
        packed = sub.pack(max_len=256, keep="last")

        def t(a):
            return torch.as_tensor(a, device=dev)

        top, _ = recency_weighted_top_aids(
            t(packed.aids), t(packed.types), t(packed.mask), t(packed.lengths),
            torch.tensor([1.0, 6.0, 3.0], dtype=torch.float32, device=dev),
            k=k, lo=0.1, hi=1.0,
        )
        preds[rec_idx] = top.cpu().numpy()

    if len(knn_idx):
        last = store.last_aid()
        for s in knn_idx:
            lo, hi = store.offsets[s], store.offsets[s + 1]
            uniq = np.unique(store.aid[lo:hi]).tolist()  # ascending, reference :86
            if recursive:
                nns = recursive_neighbors(
                    neighbor_table, int(last[s]), k - len(uniq), set(uniq)
                )
            else:
                # no dedup against the session aids here — parity with the
                # reference, whose non-recursive branch concatenates raw kNN
                # rows (gensim_fasttext/inference.py:143-155:
                # `predictions = session_unique_aids + nearest_neighbors`);
                # only the recursive walk excludes them (:127-140)
                nns = [int(a) for a in neighbor_table[int(last[s])] if a >= 0]
            row = (uniq + nns)[:k]
            preds[s, : len(row)] = row
    return {etype: preds for etype in EVENT_TYPES}
