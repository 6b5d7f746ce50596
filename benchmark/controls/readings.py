"""The readings the limits of ``benchmark/limits/<cell>.json`` are set from.

    python3 benchmark/controls/readings.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults reversed,half_catalog] [--fault-seeds 7,8,9]

For every seed, the cell's check on the program (the driver's ``readings``:
no measured window, one pass over the shards); on the control seeds, the
control too (the reference one precision lower in the program's place); for
every fault, the program with that fault planted.  One JSON line a reading
goes to standard output, and with ``--out`` appended to that file.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

from benchkit import spec as S  # noqa: E402


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    bench = S.load_spec(ROOT)
    cell = S.workload(bench, args.workload)
    cfg = S.config(bench, cell["config"], ROOT)
    traffic = S.traffic(cell["traffic"])
    driver = S.load_module("drivers", traffic["driver"])

    def emit(kind: str, seed: int, nums: dict, notes=()):
        line = json.dumps({"workload": cell["name"], "kind": kind, "seed": seed,
                           "numbers": {k: v if math.isfinite(v) else str(v)
                                       for k, v in nums.items()}, "notes": list(notes)})
        print(line, flush=True)
        if args.out is not None:
            with args.out.open("a") as f:
                f.write(line + "\n")

    jobs = [(s, None) for s in args.seeds + [c for c in args.control_seeds
                                               if c not in args.seeds]]
    jobs += [(s, f) for f in args.faults.split(",") if f for s in args.fault_seeds]
    for seed, fault in jobs:
        t = time.perf_counter()
        r = driver.readings(cfg, traffic, seed, device=args.device, fault=fault)
        emit(fault or "program", seed, r["checks"], r["notes"] + [f"{time.perf_counter() - t:.1f} s"])
        if fault is None and seed in args.control_seeds:
            emit("control", seed, driver.control(r["state"], cfg))
        del r


if __name__ == "__main__":
    main()
