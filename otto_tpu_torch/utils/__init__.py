"""Runtime helpers (port of ``otto_tpu/utils``)."""
