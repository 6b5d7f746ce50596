"""Tracing / profiling helpers.

Port of ``otto_tpu/utils/profiling.py``.  The reference has no profiling at
all (SURVEY §5.1 — only tqdm bars).  Here:

- :func:`trace` context manager runs ``torch.profiler`` (the host, and the
  card when there is one) and writes a Chrome / Perfetto trace into a
  directory
- :class:`StepTimer` measures per-step wall time, synchronising on the
  device of the step's output (launches return before the card finishes)
- :func:`device_memory_stats` snapshots the card's memory in use
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import numpy as np
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


class StepTimer:
    """Rolling step timer; call ``stop(out)`` with the step's output tensor
    to wait for its device before the clock is read."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, out=None) -> float:
        if isinstance(out, torch.Tensor) and out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    def rate(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.times else float("nan")


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
