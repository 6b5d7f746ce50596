"""Segmented-scan primitives.

Port of ``otto_tpu/ops/scan.py``.  Run-length sums over sorted key runs must
not come from a global float32 ``cumsum`` minus an offset: its absolute error
grows with the *global* prefix (~0.03 at 4e5) and corrupts small run totals.
The reference restarts an associative scan at each run head; torch has no
associative scan, so here:

- a run's total is one ``index_add_`` of the run's values into its own
  slot (segment ids from ``cumsum(head)``), accumulated in float64 and
  rounded once to the input dtype.  Nothing outside the run enters the
  sum, so the error stays inside the run; integer-valued weights are exact.
- the segmented cumsum takes a float64 prefix sum and subtracts the prefix
  at the segment's head: the float64 error (2^-53 of the prefix) stays far
  below one float32 step of the run's own values.
- "propagate first" gathers at the last head at or before each position,
  found with a ``cummax`` over head positions.

The reference sums in a tree, so fractional sums may differ from it in the
last bit; integer-valued sums are equal.
"""

from __future__ import annotations

import torch


def _heads(head: torch.Tensor, shape, axis: int) -> torch.Tensor:
    """``head`` broadcast to ``shape`` with position 0 of ``axis`` a head."""
    flags = torch.broadcast_to(head, shape).clone()
    flags.select(axis, 0).fill_(True)
    return flags


def _start_index(flags: torch.Tensor, axis: int) -> torch.Tensor:
    """Index along ``axis`` of the segment head that covers each position."""
    n = flags.shape[axis]
    view = [1] * flags.ndim
    view[axis] = n
    pos = torch.arange(n, device=flags.device).reshape(view)
    return torch.cummax(torch.where(flags, pos, 0), dim=axis).values


def segmented_cumsum(values: torch.Tensor, head: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inclusive cumsum along ``axis`` that restarts wherever ``head`` is True.

    ``head`` has the same ndim as ``values`` and a broadcast-compatible shape
    (True marks the first element of each segment; position 0 starts a
    segment whether or not it is marked).
    """
    if head.ndim != values.ndim:
        raise ValueError("head must have the same ndim as values")
    start = _start_index(_heads(head, values.shape, axis), axis)
    v = values.to(torch.float64)
    cs = torch.cumsum(v, dim=axis)
    before = torch.gather(cs, axis, start) - torch.gather(v, axis, start)
    return (cs - before).to(values.dtype)


def segmented_propagate_first(values: torch.Tensor, head: torch.Tensor,
                              axis: int = 0) -> torch.Tensor:
    """Broadcast each segment's first value across the whole segment (same
    segment convention as :func:`segmented_cumsum`)."""
    start = _start_index(_heads(head, values.shape, axis), axis)
    return torch.gather(values, axis, start)


def run_totals(values: torch.Tensor, head: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Per-position total of the containing run (same value across the run)."""
    flags = _heads(head, values.shape, axis)
    v = values.movedim(axis, -1)
    f = flags.movedim(axis, -1)
    n = v.shape[-1]
    lines = v.reshape(-1, n)
    seg = torch.cumsum(f.reshape(-1, n).to(torch.int64), dim=1) - 1
    seg = seg + torch.arange(lines.shape[0], device=v.device)[:, None] * n
    seg = seg.reshape(-1)
    totals = torch.zeros(lines.numel(), dtype=torch.float64, device=v.device)
    totals.index_add_(0, seg, lines.reshape(-1).to(torch.float64))
    out = totals[seg].to(values.dtype).reshape(v.shape)
    return out.movedim(-1, axis)
