"""Recall@20 metrics and the validation harness (port of ``otto_tpu/eval``)."""
