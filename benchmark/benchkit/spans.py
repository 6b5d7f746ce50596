"""The program's own spans in a traced window: the ``otto::`` ranges that
``otto_tpu_torch.utils.profiling.span`` opens while a profiler records.
A program without them leaves the window with none, and the readers built
on this module then read nothing.

A serving call is one ``otto::serve`` span on the window's thread; the
``*.serve`` metrics that read spans give their totals per call.
"""

from __future__ import annotations

SERVE = "otto::serve"


def calls(tr) -> int:
    """The serving calls in the window."""
    return tr.range_count(SERVE)


def host_ms_per_call(tr, names: tuple[str, ...]) -> float | None:
    """Host milliseconds of the spans named ``names`` on the window's
    thread, per serving call; None where no call or no such span ran."""
    n = calls(tr)
    spans = [r for name in names for r in tr.ranges.get(name, ()) if r.tid == tr.main_tid]
    if not n or not spans:
        return None
    return sum(r.end - r.start for r in spans) / 1e6 / n
