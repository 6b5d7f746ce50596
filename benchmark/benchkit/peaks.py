"""Published peaks of the cards the benchmark knows, with their source.

A copy of the constants of ``otto_tpu_torch/utils/roofline.py``, kept here so
that a later change to the program cannot move the yardstick.  A card that
is not in the table has no peaks: :func:`peaks_for` returns ``None`` and the
share metrics that need them report nothing (the program's
``peaks_for_name`` falls back to the H100's figures instead).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    hbm_bytes_per_s: float  # device memory bandwidth
    bf16_flops: float  # dense tensor-core rate, bf16 inputs, float32 accumulate
    f32_flops: float  # float32 outside the tensor cores
    source: str


H100_SXM = Peaks(
    hbm_bytes_per_s=3.35e12,
    bf16_flops=989e12,
    f32_flops=67e12,
    source="NVIDIA H100 Tensor Core GPU data sheet, SXM part at 700 W, dense rates",
)

# substrings of torch.cuda.get_device_name(), lower case, spaces removed
TABLE = {"h10080gbhbm3": H100_SXM}


def peaks_for(device_name: str) -> Peaks | None:
    """The peaks of the card named ``device_name``, or None if unknown."""
    key = device_name.lower().replace(" ", "")
    for sub, peaks in TABLE.items():
        if sub in key:
            return peaks
    return None
