"""Failure detection and automatic rollback for long training runs.

Port of ``otto_tpu/utils/failure.py``.  The reference has no failure
handling at all: scripts crash and restart is manual, with per-stage
artifact files as the only mitigation (SURVEY §5.3).  Here the training
loop gets an explicit guard:

- :func:`nonfinite_count` — one device reduction over a whole (nested) dict
  of tensors, read back by the caller as a single scalar.
- :class:`TrainingGuard` — wraps a :class:`~otto_tpu_torch.utils.checkpoint.
  CheckpointManager`: checkpoints every ``save_every`` steps, and on a
  non-finite loss / state (overflow, a bad batch, or a flipped bit) rolls
  back to the last good checkpoint, restored onto the state's devices, and
  replays from there.  A *deterministic* NaN (same batch order replayed)
  recurs until ``max_rollbacks`` raises — reshuffle or skip the offending
  batch after a rollback (``ok=False``).  Hard failures (preemption, crash)
  resume the same way on restart via ``manager.latest_step()`` — the
  guard's checkpoints double as the elastic restart points.

Typical loop::

    guard = TrainingGuard(manager, save_every=100)
    state, step = guard.resume(state)    # picks up after a crash
    while step < n_steps:
        step += 1
        state2, loss = train_step(state, next_batch())
        state, step, ok = guard.observe(step, state2, loss)
        # on rollback: ok=False, state/step rewound; re-enter the loop
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import torch

from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.utils.checkpoint import CheckpointManager

log = get_logger(__name__)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def nonfinite_count(tree: Any) -> torch.Tensor:
    """Total count of non-finite elements across every floating tensor of a
    (nested) dict: a 0-dim int64 tensor on the leaves' device (the CPU when
    there is none), one reduction there; ``int()`` reads it back."""
    leaves = [t for t in _leaves(tree) if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not leaves:
        return torch.zeros((), dtype=torch.int64)
    return torch.stack([(~torch.isfinite(t)).sum() for t in leaves]).sum()


@dataclass
class TrainingGuard:
    """Checkpoint-backed NaN/Inf watchdog with automatic rollback."""

    manager: CheckpointManager
    save_every: int = 100
    check_state_every: int = 0  # 0 = only check the loss scalar
    max_rollbacks: int = 3
    rollbacks: int = field(default=0, init=False)
    failures: list = field(default_factory=list, init=False)
    _last_good: int | None = field(default=None, init=False)

    def resume(self, state: Any):
        """Restore the latest checkpoint if one exists (crash/preemption
        restart) onto ``state``'s devices; returns (state, step)."""
        step = self.manager.latest_step()
        if step is None:
            return state, 0
        restored = self.manager.restore(step, template=state)
        self._last_good = step
        log.info("resumed from checkpoint at step %d", step)
        return restored, step

    def observe(self, step: int, state: Any, loss) -> tuple[Any, int, bool]:
        """Record one completed step.  Returns (state, step, ok): on a
        detected failure the returned state/step are rewound to the last
        good checkpoint and ok is False."""
        bad = not math.isfinite(float(loss))
        if not bad and self.check_state_every and step % self.check_state_every == 0:
            bad = int(nonfinite_count(state)) > 0
        if bad:
            self.failures.append({"step": step, "loss": float(loss)})
            if self._last_good is None:
                raise RuntimeError(
                    f"non-finite training state at step {step} with no "
                    "checkpoint to roll back to"
                )
            self.rollbacks += 1
            if self.rollbacks > self.max_rollbacks:
                raise RuntimeError(
                    f"non-finite training state at step {step}: exceeded "
                    f"{self.max_rollbacks} rollbacks"
                )
            restored = self.manager.restore(self._last_good, template=state)
            log.warning(
                "non-finite state at step %d: rolled back to step %d "
                "(rollback %d/%d)",
                step, self._last_good, self.rollbacks, self.max_rollbacks,
            )
            return restored, self._last_good, False
        if step > 0 and step % self.save_every == 0:
            self.manager.save(step, state)
            self._last_good = step
        return state, step, True
