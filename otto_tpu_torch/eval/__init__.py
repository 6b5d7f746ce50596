"""Recall@20 metrics, the validation harness, the embedding trainers' model
metrics and the reference-semantics oracle (port of ``otto_tpu/eval``).

``feature_oracle``, the pandas restatement of the feature families, is not
imported here: it needs pandas (and scikit-learn for its fold protocol),
which nothing on the served or trained path may need."""
