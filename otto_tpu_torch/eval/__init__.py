"""Recall@20 metrics, the validation harness, the embedding trainers' model
metrics and the reference-semantics oracle (port of ``otto_tpu/eval``)."""
