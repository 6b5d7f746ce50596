"""Device selection, numeric settings, and the loader of the script files.

Port of ``otto_tpu/utils/runtime.py``.  The JAX module configures XLA's
compilation cache; PyTorch runs eagerly and needs none.  What the port needs
instead is an explicit device: nothing here picks one behind the caller's
back, and asking for CUDA without a card is an error, never a quiet run on
the CPU.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``torch.device(name)``, raising if it names CUDA and no card is there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products in full float32 on the card.

    TF32 keeps about three decimal digits; the exact scan, the dense top-k
    and the stage-1 twin need float32 scores.  The flag is process-wide, so it
    is restored on exit.
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def device_line(device: str | torch.device) -> str:
    """What ran the numbers: ``nvidia-smi``'s name and power limit of the
    card (a card below its maximum power runs slower under load), or "cpu"."""
    import subprocess

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()


def load_file(path: str | Path, name: str):
    """A module imported from the file ``path`` under the name ``name``
    (the examples and tools are scripts, not packages)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
