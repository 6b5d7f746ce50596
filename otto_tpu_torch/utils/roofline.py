"""Roofline accounting: what fraction of the card's speed of light a
measured kernel or step achieves.

Port of ``otto_tpu/utils/roofline.py`` with an NVIDIA H100's peaks in place
of a TPU's (NVIDIA's data sheet, SXM part at 700 W, dense rates: the
constants ``chip_smoke.py`` computes its bounds with).  The byte/FLOP
counts are the *caller's* model of the work (documented at each call
site); fractions are therefore estimates of the achieved-vs-peak ratio
under that model, not hardware counters — use ``torch.profiler`` traces
when exact numbers matter.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ChipPeaks:
    hbm_gbps: float  # device memory bandwidth, GB/s
    bf16_tflops: float  # tensor-core peak, bf16 inputs / f32 accumulate
    f32_tflops: float  # float32 outside the tensor cores


PEAKS = {
    "h100": ChipPeaks(hbm_gbps=3350.0, bf16_tflops=989.0, f32_tflops=67.0),
}


def peaks_for_name(name: str) -> ChipPeaks | None:
    """Peaks of a card by its name (``torch.cuda.get_device_name``), or
    ``None`` for a card this table does not know."""
    name = name.lower().replace(" ", "")
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return None


def chip_peaks(device: str | torch.device | None = None) -> ChipPeaks:
    """Peaks of ``device`` (a CUDA device's name from ``torch.cuda``); the
    H100's, the port's target part, for ``None`` or the CPU.  Raises for a
    CUDA card with no peaks in the table, rather than rate it as an H100."""
    if device is not None and torch.device(device).type == "cuda":
        name = torch.cuda.get_device_name(torch.device(device))
        peaks = peaks_for_name(name)
        if peaks is None:
            raise ValueError(f"no published peaks for the card {name!r}")
        return peaks
    return PEAKS["h100"]


WGMMA_K = 16  # contraction depth of one bf16 wgmma instruction on Hopper


def roofline(seconds: float, *, hbm_bytes: float = 0.0, bf16_flops: float = 0.0,
             f32_flops: float = 0.0, k_dim: int | None = None,
             device=None) -> dict:
    """Achieved rates and fractions-of-peak for one measured call.

    Returns {"hbm_gbps", "hbm_frac", "tflops", "mxu_frac", "bound"} (the
    reference's keys: ``mxu_frac`` is the fraction of the tensor-core peak
    for bf16 work, of the float32 peak for float32 work) — the binding
    resource is whichever fraction is highest (a call below ~0.5 on both is
    latency-bound or under-shaped for the hardware).

    With ``k_dim`` (the matmul contraction depth) the dict also carries the
    *achievable-bound* accounting: a bf16 ``wgmma`` contracts 16 deep, so a
    depth k that is not a multiple of 16 pads its last instruction and can
    reach at most k / (16 * ceil(k / 16)) of the peak (the TPU's derate is
    its MXU's 128-deep pass).  ``light_s`` is the speed-of-light time under
    that derate (max of memory-stream time and derated compute time) and
    ``light_frac`` the measured call's fraction of it.
    """
    peaks = chip_peaks(device)
    out: dict = {}
    hbm = hbm_bytes / seconds / 1e9 if seconds > 0 else 0.0
    out["hbm_gbps"] = round(hbm, 1)
    out["hbm_frac"] = round(hbm / peaks.hbm_gbps, 4)
    tflops = (bf16_flops + f32_flops) / seconds / 1e12 if seconds > 0 else 0.0
    peak_t = peaks.bf16_tflops if bf16_flops >= f32_flops else peaks.f32_tflops
    out["tflops"] = round(tflops, 2)
    out["mxu_frac"] = round(tflops / peak_t, 4)
    out["bound"] = "hbm" if out["hbm_frac"] >= out["mxu_frac"] else "mxu"
    if k_dim is not None and seconds > 0:
        derate = k_dim / (WGMMA_K * -(-k_dim // WGMMA_K))
        hbm_s = hbm_bytes / (peaks.hbm_gbps * 1e9)
        mxu_s = (bf16_flops + f32_flops) / (peak_t * derate * 1e12)
        light_s = max(hbm_s, mxu_s)
        out["k_dim"] = int(k_dim)
        out["light_s"] = round(light_s, 6)
        out["light_frac"] = round(light_s / seconds, 4)
        out["light_bound"] = "hbm" if hbm_s >= mxu_s else "mxu"
    return out
