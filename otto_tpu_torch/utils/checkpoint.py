"""Checkpointing of training state.

Port of ``otto_tpu/utils/checkpoint.py``: a directory of numbered steps
with retention.  Each step is one ``step_<n>.pt`` written by ``torch.save``
(to a temporary name, then renamed, so a crash never leaves a half-written
step) holding a dict of CPU tensors, nested dicts and lists allowed.
``restore(step, template=)`` puts each tensor where the template's tensor
of the same name lives (device and dtype), as the reference restores onto
the template's arrays.

Sharded state, as orbax restores onto a template's shardings: a leaf that
is a ``DTensor`` (a rank's block with its mesh and layout;
``parallel.model_parallel.with_layout``) is saved whole: every rank of the
process group calls ``save``, the blocks are gathered over the mesh, rank 0
writes and the others wait for it.  A template leaf that is a ``DTensor``
restores this rank's block of the saved whole tensor (a plain tensor, on
the template's device and in its dtype); other leaves restore whole.  A
checkpoint of one package does not load in the other: the JAX package's
holds a JAX PRNG key where this one holds a ``torch.Generator`` state.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of nested dicts and lists, with the matching
    leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _leaves(tree) -> list:
    if isinstance(tree, (dict, list)):
        return [leaf for v in (tree.values() if isinstance(tree, dict) else tree)
                for leaf in _leaves(v)]
    return [tree]


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A leaf's whole tensor on the CPU: a ``DTensor``'s blocks gathered."""
    if _is_sharded(t):
        from otto_tpu_torch.parallel.mesh import gather_block

        return gather_block(t.device_mesh, t.to_local(), t.placements).cpu()
    return t.detach().cpu()


def _restored(t, v: torch.Tensor) -> torch.Tensor:
    """The saved ``v`` where the template leaf ``t`` lives: this rank's block
    of it when ``t`` is a ``DTensor``."""
    if _is_sharded(t):
        from otto_tpu_torch.parallel.mesh import take_block

        v = take_block(t.device_mesh, v, t.placements)
        return v.to(device=t.to_local().device, dtype=t.dtype)
    return v.to(device=t.device, dtype=t.dtype)


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
        """Write ``state`` as step ``step``.  With ``DTensor`` leaves every
        rank of the process group calls this: the blocks are gathered, rank 0
        writes, and all return once the step is on disk."""
        import torch.distributed as dist

        sharded = any(_is_sharded(t) for t in _leaves(state))
        whole = _tree_map(_whole, state)
        if not sharded or dist.get_rank() == 0:
            tmp = self.directory / f".step_{step}.pt.tmp"
            torch.save(whole, tmp)
            os.replace(tmp, self._path(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                self._path(old).unlink()
        if sharded:
            dist.barrier()

    def restore(self, step: int | None = None, template: dict | None = None) -> dict | None:
        """The state saved at ``step`` (default the latest): on the CPU, or
        with ``template`` (a dict of the same names) each tensor on the
        device and in the dtype of the template's, and this rank's block of
        it where the template's is a ``DTensor``."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        if template is None:
            return state
        return _tree_map(_restored, template, state)

    def close(self) -> None:
        """Nothing is held open between calls; kept for the reference's API."""
