"""Similar-session retrieval shared by the session-vector recommenders.

Port of ``retrieve_similar_session_aids`` of ``otto_tpu/models/tfidf.py``
(:96-132); the TF-IDF recommender itself is not ported yet (ROADMAP M12).
"""

from __future__ import annotations

import numpy as np
import torch

from otto_tpu_torch import TOP_K
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.ops.retrieval import topk_scan
from otto_tpu_torch.utils.runtime import resolve_device


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
