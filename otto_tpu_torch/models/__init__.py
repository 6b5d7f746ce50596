"""Models (port of ``otto_tpu/models``): SGNS inference and the
embedding-kNN recommender so far."""
