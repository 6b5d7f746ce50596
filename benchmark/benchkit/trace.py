"""The traced window: ``torch.profiler`` (host and card) between
:meth:`DeviceTrace.start` and :meth:`DeviceTrace.stop`, and its reduction.

The window is a ``record_function`` range opened after a synchronise and
closed after another, so its length is what the card had to do in it.
A kernel belongs to a host range (``record_function``, such as PyTorch's own
the benchmark's ``bench::topk``) when the
call that launched it ran inside that range on the same thread; the link is
the profiler's correlation id.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

import torch

WINDOW = "bench::window"


@dataclass
class _Ev:
    name: str
    start: int  # ns
    end: int
    tid: int
    corr: int


class DeviceTrace:
    """One traced window over the current CUDA device."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._range = None
        self._summary: TraceSummary | None = None
        self.running = False

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.start()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self.running = True

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self.running = False

    @property
    def summary(self) -> TraceSummary:
        """The window's reduction, made on first use (after the measured
        window, so that reading the events does not delay it)."""
        if self._summary is None:
            self._summary = TraceSummary(self._prof.profiler.kineto_results.events())
        return self._summary


def warm_profiler() -> None:
    """Start and stop the profiler once over a tiny op, so that the tracing
    library's own start-up falls into set-up."""
    t = DeviceTrace()
    t.start()
    torch.ones(1, device="cuda").add_(1)
    t.stop()


class TraceSummary:
    """The kernels, copies and host ranges of one traced window."""

    def __init__(self, events):
        cpu = torch.autograd.DeviceType.CPU
        self.device: list[_Ev] = []
        self.host: list[_Ev] = []
        self.ranges: dict[str, list[_Ev]] = defaultdict(list)
        on_device = []
        for e in events:
            ev = _Ev(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.start_thread_id(), e.correlation_id())
            if e.device_type() != cpu:
                on_device.append((ev, e.is_user_annotation()))
            else:
                self.host.append(ev)
                if e.is_user_annotation():
                    self.ranges[ev.name].append(ev)
        # the profiler draws each host range again on the device's timeline;
        # those are not work
        self.device = [ev for ev, ann in on_device if not ann and ev.name not in self.ranges]
        win = self.ranges.get(WINDOW)
        if not win:
            raise RuntimeError("the traced window's range is missing from the trace")
        self.window = win[0]
        self.main_tid = self.window.tid
        # a kernel or copy carries the CUPTI correlation id of the runtime or
        # driver call that launched it (cudaLaunchKernel, cuLaunchKernelEx, ...)
        self.launch = {e.corr: e for e in self.host if e.corr and e.name.startswith("cu")}
        self.device.sort(key=lambda e: e.start)

    @property
    def window_s(self) -> float:
        return (self.window.end - self.window.start) / 1e9

    def _clipped(self):
        w0, w1 = self.window.start, self.window.end
        for e in self.device:
            s, t = max(e.start, w0), min(e.end, w1)
            if t > s:
                yield s, t, e

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device's activity in the window, merged."""
        out: list[list[int]] = []
        for s, t, _ in self._clipped():
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e9

    def device_seconds_in(self, range_name: str) -> float | None:
        """Device time of every kernel and copy launched inside a host range
        of that name on the window's thread; None if no such range ran."""
        rs = sorted((r for r in self.ranges.get(range_name, ()) if r.tid == self.main_tid),
                    key=lambda r: r.start)
        if not rs:
            return None
        starts = [r.start for r in rs]
        total = 0
        for s, t, e in self._clipped():
            launch = self.launch.get(e.corr)
            if launch is None or launch.tid != self.main_tid:
                continue
            i = bisect.bisect_right(starts, launch.start) - 1
            if i >= 0 and launch.start <= rs[i].end:
                total += t - s
        return total / 1e9

    def range_count(self, range_name: str) -> int:
        return sum(1 for r in self.ranges.get(range_name, ()) if r.tid == self.main_tid)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the deepest host operation running at each gap's middle
        (``host python`` where none was)."""
        ops: dict[str, int] = defaultdict(int)
        for s, t, e in self._clipped():
            ops[e.name] += t - s
        busy = self.busy_intervals()
        w0, w1 = self.window.start, self.window.end
        gaps, prev = [], w0
        for s, t in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = t
        if w1 > prev:
            gaps.append((prev, w1))
        idle: dict[str, int] = defaultdict(int)
        for (g0, g1), name in zip(gaps, self._host_at([(a + b) // 2 for a, b in gaps])):
            idle[name] += g1 - g0
        return {
            "device_ops": [[n, v / 1e9] for n, v in sorted(ops.items(), key=lambda x: -x[1])[:top]],
            "idle_gaps": [[n, v / 1e9] for n, v in sorted(idle.items(), key=lambda x: -x[1])[:top]],
        }

    def _host_at(self, points: list[int]) -> list[str]:
        """For sorted time points, the name of the deepest host event of the
        window's thread (events nest) running at each."""
        evs = sorted((e for e in self.host if e.tid == self.main_tid and e.name != WINDOW),
                     key=lambda e: (e.start, -e.end))
        out, stack, i = [], [], 0
        for p in points:
            while i < len(evs) and evs[i].start <= p:
                while stack and stack[-1].end < evs[i].start:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            while stack and stack[-1].end < p:
                stack.pop()
            out.append(stack[-1].name if stack else "host python")
        return out
