"""Checkpointing of training state.

Port of ``otto_tpu/utils/checkpoint.py``: a directory of numbered steps
with retention.  Each step is one ``step_<n>.pt`` written by ``torch.save``
(to a temporary name, then renamed, so a crash never leaves a half-written
step) holding a dict of CPU tensors, nested dicts allowed.  ``restore(step,
template=)`` puts each tensor where the template's tensor of the same name
lives (device and dtype), as the reference restores onto the template's
arrays; sharded restore waits for the parallel slice.  A checkpoint of one
package does not load in the other: the JAX package's holds a JAX PRNG key
where this one holds a ``torch.Generator`` state.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a (nested) dict, with the matching leaves
    of ``rest``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


class CheckpointManager:
    """Save and restore (nested) ``{name: tensor}`` dicts by step, keeping
    the newest ``max_to_keep``."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def all_steps(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1]) for p in self.directory.glob("step_*.pt"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> None:
        tmp = self.directory / f".step_{step}.pt.tmp"
        torch.save(_tree_map(lambda v: v.detach().cpu(), state), tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            self._path(old).unlink()

    def restore(self, step: int | None = None, template: dict | None = None) -> dict | None:
        """The state saved at ``step`` (default the latest): on the CPU, or
        with ``template`` (a dict of the same names) each tensor on the
        device and in the dtype of the template's."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        if template is None:
            return state
        return _tree_map(lambda t, v: v.to(device=t.device, dtype=t.dtype), template, state)

    def close(self) -> None:
        """Nothing is held open between calls; kept for the reference's API."""
