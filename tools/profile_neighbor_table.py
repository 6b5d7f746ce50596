"""Profile one full-width neighbor-table build of the PyTorch port on a card.

    python3 tools/profile_neighbor_table.py

Builds a seeded random SGNS input table of 1,855,603 aids x 32 dims on the
card (the shape of ``chip_smoke.py``'s phase 4), warms up on one query
batch, then runs ``SGNSModel.neighbor_table`` once unprofiled and once
under ``torch.profiler``.  Prints the card's name and power limit, both wall
times, the device's busy time (the sum of its kernels and copies; one
stream, so they do not overlap) and idle share over the profiled build, and
device time by kernel name.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_AIDS, DIM, K = 1_855_603, 32, 21   # chip_smoke.py's phase 4
TOP = 12                             # kernel names listed


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_neighbor_table: needs a CUDA card", file=sys.stderr)
        return 2
    from otto_tpu_torch.models.embeddings import SGNSModel
    from otto_tpu_torch.ops.retrieval import build_neighbor_table

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    w_in = np.random.default_rng(20260101).standard_normal((N_AIDS, DIM), dtype=np.float32)
    model = SGNSModel.from_jax_arrays(w_in, np.zeros_like(w_in), np.zeros(N_AIDS, np.float32),
                                      device=dev)
    build_neighbor_table(model.w_in[:4096], k=K, device=dev)  # warm-up: build, load
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    model.neighbor_table(k=K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model.neighbor_table(k=K)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies, sets): a CPU op's row repeats
    # the device time of the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == cuda]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    print(f"neighbor table k={K} over {N_AIDS} aids x {DIM}: unprofiled "
          f"{wall:.3f} s; profiled {prof_wall:.3f} s, device busy {busy:.3f} s, idle "
          f"{100 * (1 - busy / prof_wall):.1f}%", flush=True)
    for key, us, count in rows[:TOP]:
        print(f"  {us / 1e6:9.4f} s {100 * us / 1e6 / prof_wall:5.1f}%  x{count:<6d} {key[:90]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
