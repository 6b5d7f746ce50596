"""The check that the run loaded neither JAX nor the JAX package.

Names are compared by their top-level part (before the first dot), whole:
``otto_tpu_torch`` is the port and passes, ``otto_tpu`` and ``otto_tpu.x``
do not."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "otto_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The loaded module names (``sys.modules`` by default) whose top-level
    name is one of :data:`FORBIDDEN`, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
