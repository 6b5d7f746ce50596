"""Retrieval, selection and session ops (port of ``otto_tpu/ops``).

The hand-written CUDA kernels live in ``otto_tpu_torch/csrc`` and are built
at first CUDA use by :mod:`otto_tpu_torch.ops._kernels`.
"""
