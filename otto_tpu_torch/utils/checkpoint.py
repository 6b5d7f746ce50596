"""Checkpointing of training state.

Port of what ``otto_tpu/utils/checkpoint.py`` gives the SGNS trainer: a
directory of numbered steps with retention.  Each step is one
``step_<n>.pt`` written by ``torch.save`` (to a temporary name, then
renamed, so a crash never leaves a half-written step) holding a flat dict
of CPU tensors.  A checkpoint of one package does not load in the other:
the JAX package's holds a JAX PRNG key where this one holds a
``torch.Generator`` state.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


class CheckpointManager:
    """Save and restore ``{name: tensor}`` dicts by step, keeping the
    newest ``max_to_keep``."""

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

    def save(self, step: int, state: dict[str, torch.Tensor]) -> None:
        tmp = self.directory / f".step_{step}.pt.tmp"
        torch.save({k: v.detach().cpu() for k, v in state.items()}, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            self._path(old).unlink()

    def restore(self, step: int | None = None) -> dict[str, torch.Tensor] | None:
        """The state saved at ``step`` (default the latest), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def close(self) -> None:
        """Nothing is held open between calls; kept for the reference's API."""
