"""Tracing / profiling helpers.

Port of ``otto_tpu/utils/profiling.py``.  The reference has no profiling at
all (SURVEY §5.1 — only tqdm bars).  Here:

- :func:`trace` context manager runs ``torch.profiler`` (the host, and the
  card when there is one) and writes a Chrome / Perfetto trace into a
  directory
- :func:`span` names a stretch of the program's host work inside such a
  trace (the ``otto::`` ranges of the serving path); free when no profiler
  records
- :func:`device_memory_stats` snapshots the card's memory in use
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

from otto_tpu_torch.logging_utils import get_logger

log = get_logger(__name__)


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block; writes ``trace_<pid>_<ns>.json`` into ``log_dir``
    and yields the ``torch.profiler.profile`` (``key_averages()`` sums by
    operation and kernel)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    path = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    log.info("profiler trace written to %s", path)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a ``torch.profiler.record_function``
    range while a profiler records on this thread (started by ``profile()``'s
    ``with`` block or its ``start()``), and does nothing otherwise.

    The ranges are the profiler's own host events: they share its clock and
    its correlation with the card's kernels, nest by the ``with`` blocks that
    enclose them, and are written out with the rest of the trace (by
    :func:`trace`, or by whoever holds the profiler).  With no profiler
    recording, a call costs one check of the profiler's state and returns a
    shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def device_memory_stats(device: str | torch.device) -> dict:
    """``bytes_in_use``, ``peak_bytes_in_use`` (PyTorch's allocator, since
    the process started or the last ``torch.cuda.reset_peak_memory_stats``)
    and ``bytes_limit`` (the card's memory) of a CUDA device; ``{}`` for
    the CPU, which keeps no such statistics."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": total,
    }
