"""otto_tpu_torch — the PyTorch + CUDA port of ``otto_tpu``.

``otto_tpu`` (JAX on a TPU) stays the reference; this package mirrors its
layout and names, so each module's counterpart sits at the same path.  It
imports ``torch`` and numpy, never ``jax`` and never ``otto_tpu``.

Ported so far (the embedding-kNN serving slice):

- ``otto_tpu_torch.data``    event store, labels, splits, synthetic data (copied numpy)
- ``otto_tpu_torch.eval``    recall@20 metrics and the validation harness
- ``otto_tpu_torch.ops``     fused retrieval (hand-written CUDA kernels for the
                             stage-1 window max and the window peel), exact
                             scan, neighbor tables, session recency ranking
- ``otto_tpu_torch.models``  SGNS inference and the embedding-kNN recommender

Constants are those of ``otto_tpu/__init__.py``.
"""

__version__ = "0.1.0"

# Event-type encoding, shared with the reference dataset
# (reference: src/utilities/dataset_writer_pickle.py:29-33).
CLICK, CART, ORDER = 0, 1, 2
EVENT_TYPES = ("clicks", "carts", "orders")
TYPE_WEIGHTS = (0.1, 0.3, 0.6)  # weighted recall@20 blend weights
TOP_K = 20
