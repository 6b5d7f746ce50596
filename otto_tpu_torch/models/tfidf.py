"""TF-IDF session-similarity recommender.

Port of ``otto_tpu/models/tfidf.py``, which reproduces
src/tfidf/inference.py: sessions are documents, aids are terms; similar
sessions are retrieved by cosine similarity of TF-IDF vectors and their aids
become predictions.

Session vectors live in a dense low-rank space: the sparse TF-IDF matrix is
projected by a random feature hash [n_aids, d] (sparse random projection
preserves cosine), and similar sessions come from the exact float32 top-k
scan (:func:`otto_tpu_torch.ops.retrieval.topk_scan`) over the projected
session matrix on the caller's device.  :func:`tfidf_weights` and
:func:`session_vectors` are numpy, copied (:29-64);
:func:`retrieve_similar_session_aids` (:96-132) is shared with the
session-embedding recommender.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from otto_tpu_torch import EVENT_TYPES, TOP_K
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.ops.retrieval import topk_scan
from otto_tpu_torch.utils.runtime import resolve_device


def tfidf_weights(store: EventStore, n_aids: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-event TF-IDF weight and the IDF table.

    tf = in-session count / session length; idf = ln((1+n)/(1+df)) + 1
    (sklearn smooth_idf semantics)."""
    S = store.n_sessions
    key = store.session_idx.astype(np.int64) * n_aids + store.aid.astype(np.int64)
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    tf = counts[inv] / store.lengths[store.session_idx]
    # document frequency per aid
    order = np.argsort(key, kind="stable")
    sk = key[order]
    head = np.concatenate([[True], sk[1:] != sk[:-1]])
    df = np.bincount((sk[head] % n_aids).astype(np.int64), minlength=n_aids)
    idf = np.log((1.0 + S) / (1.0 + df)) + 1.0
    return (tf * idf[store.aid]).astype(np.float32), idf.astype(np.float32)


def session_vectors(
    store: EventStore, n_aids: int, dim: int = 256, seed: int = 0
) -> np.ndarray:
    """L2-normalized random-projected TF-IDF session vectors [S, dim]."""
    rng = np.random.default_rng(seed)
    # sparse sign projection: each aid maps to `s` random +-1 coordinates
    s_nnz = 4
    proj_idx = rng.integers(0, dim, size=(n_aids, s_nnz))
    proj_sign = rng.choice([-1.0, 1.0], size=(n_aids, s_nnz)).astype(np.float32)

    w, _ = tfidf_weights(store, n_aids)
    S = store.n_sessions
    vec = np.zeros((S, dim), np.float32)
    rows = np.repeat(store.session_idx[:, None], s_nnz, axis=1)
    cols = proj_idx[store.aid]
    vals = proj_sign[store.aid] * w[:, None]
    np.add.at(vec, (rows.reshape(-1), cols.reshape(-1)), vals.reshape(-1))
    norms = np.linalg.norm(vec, axis=1, keepdims=True)
    return vec / np.maximum(norms, 1e-9)


@dataclass
class TfIdfModel:
    vectors: np.ndarray  # [S_corpus, dim] normalized
    corpus: EventStore
    n_aids: int

    @classmethod
    def fit(cls, corpus: EventStore, n_aids: int, dim: int = 256, seed: int = 0) -> "TfIdfModel":
        return cls(session_vectors(corpus, n_aids, dim, seed), corpus, n_aids)

    def similar_session_predictions(
        self,
        queries: EventStore,
        n_similar: int = 5,
        k: int = TOP_K,
        query_batch: int = 4096,
        *,
        device: str | torch.device,
    ) -> dict[str, np.ndarray]:
        """For each query session, gather aids of its most similar corpus
        sessions (most-recent-first within each) as predictions, the same
        list for every event type; the scan runs on ``device``.  The query
        vectors take the projection of seed 0, as in the reference."""
        qv = session_vectors(queries, self.n_aids, self.vectors.shape[1])
        preds = retrieve_similar_session_aids(
            qv, self.vectors, self.corpus, n_similar=n_similar, k=k,
            query_batch=query_batch, device=device,
        )
        return {etype: preds for etype in EVENT_TYPES}


def retrieve_similar_session_aids(
    query_vectors,
    corpus_vectors,
    corpus: EventStore,
    n_similar: int = 5,
    k: int = TOP_K,
    query_batch: int = 4096,
    *,
    device: str | torch.device,
) -> np.ndarray:
    """Exact top-``n_similar`` corpus sessions per query (float32
    dot-product scan on ``device``); each query's predictions are then the
    deduplicated aids of its similar sessions, each session's most recent
    first, cut to ``k`` (int32 [S, k], -1 padded)."""
    dev = resolve_device(device)
    queries = torch.as_tensor(query_vectors, dtype=torch.float32, device=dev)
    corpus_dev = torch.as_tensor(corpus_vectors, dtype=torch.float32, device=dev)
    S = queries.shape[0]
    preds = np.full((S, k), -1, np.int32)
    packed = corpus.pack(max_len=k, keep="last")
    for start in range(0, S, query_batch):
        end = min(start + query_batch, S)
        _, idx = topk_scan(queries[start:end], corpus_dev, k=n_similar, block=16384,
                           metric="dot")
        idx = idx.cpu().numpy()
        for r in range(end - start):
            seen: list[int] = []
            seen_set = set()
            for sim in idx[r]:
                row = packed.aids[sim][packed.mask[sim]][::-1]
                for a in row:
                    if int(a) not in seen_set:
                        seen.append(int(a))
                        seen_set.add(int(a))
                if len(seen) >= k:
                    break
            preds[start + r, :min(len(seen), k)] = seen[:k]
    return preds
