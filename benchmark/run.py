"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names its configuration and traffic mix; the mix names its driver
(``benchmark/drivers/<driver>.py``), which sets up, runs the measured window
and returns the end-to-end numbers, the correctness numbers and what the
per-layer readers (``benchmark/metrics/<metric>.py``) need.  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a traced part of the window.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the correctness numbers beside their limits.
Exit codes: 0 a result was printed (correct or not); 2 the benchmark's files
are missing or malformed; 3 no CUDA card, or fewer than the cell asks for;
4 JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = ROOT / "bench_cache"

# every build and kernel cache inside the checkout, at fixed paths (the port
# builds its CUDA library into otto_tpu_torch/_build/ by itself)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE_DIR / sub)
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]


def _fail(code: int, msg: str):
    print(msg, file=sys.stderr)
    sys.exit(code)


def _clean(x):
    """Infinite and NaN numbers as strings (JSON has none)."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchkit import spec as S
    from benchkit.guard import forbidden_modules

    try:
        bench = S.load_spec(ROOT)
        cell = S.workload(bench, args.workload)
        cfg = S.config(bench, cell["config"], ROOT)
        traffic = S.traffic(cell["traffic"])
        limits = S.limits(cell["name"])
        driver = S.load_module("drivers", traffic["driver"])
        e2e = S.end_to_end_for(bench, cell["name"])
        layers = S.per_layer_for(bench, cell["name"])
        readers = {m["name"]: S.load_module("metrics", m["name"]) for m in layers}
    except (OSError, KeyError, ValueError) as exc:
        _fail(2, f"benchmark files: {exc!r}")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        _fail(3, f"the cell needs {cell['chips']} CUDA card(s); torch.cuda.is_available() is "
                 f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}")
    device_name = torch.cuda.get_device_name(0)
    t_init = time.perf_counter() - T_START

    res = driver.run(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), T_START)

    if args.trace:
        ctx = dict(res["layer"], device_name=device_name)
        metrics = {}
        for m in layers:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in e2e}

    found = forbidden_modules()
    if found:
        _fail(4, f"forbidden modules loaded: {found}")
    out, lines = assemble(res, metrics, limits, device_name, cell["chips"], bool(args.trace))
    print(f"process start to the card found {t_init:.3f} s", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(out))


def assemble(res: dict, metrics: dict, limits: dict, device_name: str, chips: int,
             trace: bool) -> tuple[dict, list[str]]:
    """The result's line and the lines for standard error (the driver's
    notes, then each correctness number beside its limit, also the last key
    of the result)."""
    checks = {k: {"value": _clean(res["checks"].get(k, math.inf)), "limit": lim}
              for k, lim in limits.items()}
    correct = res["failed"] == 0 and all(
        k in res["checks"] and res["checks"][k] <= lim for k, lim in limits.items())
    device = {"platform": "gpu", "kind": device_name, "count": chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": bool(correct), "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    tr = res["layer"].get("trace") if trace else None
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    lines = list(res["notes"]) + [f"check {k} {v['value']} limit {v['limit']}"
                                  for k, v in checks.items()]
    return out, lines


if __name__ == "__main__":
    main()
