"""otto_tpu_torch — the PyTorch + CUDA port of ``otto_tpu``.

``otto_tpu`` (JAX on a TPU) stays the reference; this package mirrors its
layout and names, so each module's counterpart sits at the same path.  It
imports ``torch`` and numpy, never ``jax`` and never ``otto_tpu``.

Ported so far (the embedding-kNN, baseline, two-stage and sequence
paths, matrix factorization and collaborative filtering, the training
utilities, the file CLI, and sharded serving over a process mesh):

- ``otto_tpu_torch.data``     event store, labels, splits, synthetic data (copied numpy),
                              JSONL ingest, parquet writers and the Kaggle
                              submission writer (native C++ at first use)
- ``otto_tpu_torch.eval``     recall@20 and MAP@k metrics, the validation
                              harness, the paired bootstrap of a lift, the
                              embedding trainers' model metrics (accuracy,
                              ROC-AUC, MAE, MSE) and the reference-semantics
                              oracle (copied)
- ``otto_tpu_torch.features`` aid, session and interaction features (copied
                              numpy, with the native segment-stats engine)
- ``otto_tpu_torch.ops``      fused retrieval (hand-written CUDA kernels for the
                              stage-1 window max and the window peel), exact
                              scan, neighbor tables, session ranking and the
                              session vote kernel, multiset and covisitation
                              ops, the mixture-of-experts FFN, forest
                              routing (a CUDA kernel)
- ``otto_tpu_torch.models``   SGNS training and inference and the embedding-kNN
                              recommender, frequency and recency baselines,
                              covisitation and its heuristic, candidate
                              generators, GBDT training and inference, the
                              listwise tower ranker, TF-IDF, the sequence
                              recommenders (GRU, NARM, STAMP, Caser,
                              transformer and MoE encoders), matrix
                              factorization and collaborative filtering
                              (sparse adagrad on the card), the file ensemble
- ``otto_tpu_torch.parallel`` process meshes on ``torch.distributed``, the
                              row-sharded lookup, top-k and SGNS/MF steps,
                              sharded serving (candidates, heuristic,
                              covisitation build, tower scoring) and
                              ``python -m otto_tpu_torch.parallel.dryrun``
- ``otto_tpu_torch.twostage``, ``otto_tpu_torch.streaming``: two-stage
                              training (tower or GBDT rankers), resume, and
                              prediction with trained artifacts
- ``otto_tpu_torch.pipelines`` the runners and the file CLI
                              (``python -m otto_tpu_torch.pipelines``)
- ``otto_tpu_torch.utils``    device selection, checkpoints, the NaN guard
                              with rollback, seeding, profiling, the H100
                              roofline, native-library builds
- ``otto_tpu_torch.visualization`` training curves, importance and data
                              plots (matplotlib, imported when a plot is made)

Constants are those of ``otto_tpu/__init__.py``.
"""

__version__ = "0.1.0"

# Event-type encoding, shared with the reference dataset
# (reference: src/utilities/dataset_writer_pickle.py:29-33).
CLICK, CART, ORDER = 0, 1, 2
EVENT_TYPES = ("clicks", "carts", "orders")
TYPE_WEIGHTS = (0.1, 0.3, 0.6)  # weighted recall@20 blend weights
TOP_K = 20
