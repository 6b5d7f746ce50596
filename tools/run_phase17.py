"""Run ``chip_smoke.py``'s phase 17 (data-parallel training) alone on a card.

    python3 tools/run_phase17.py

It needs phase 11c's fold, so it first runs 11c (the bench refit, held to
its recorded lift) and 11a (K5 against its twin and the fixed-point
reference on that fold), then 17a (one NCCL rank in this process, mesh
(1, 1)) and 17b (two ``gloo`` ranks sharing the card, mesh (2, 1); this
file run as ``--rank``), with ``chip_smoke.py``'s own functions and checks.
About 3 minutes against the whole script's 17.  Prints the card's name and
power limit first and ``phase 17 ok`` last; needs a CUDA card and imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WORK = cs.REPO / "tmp" / "run_phase17"


def rank_main() -> int:
    """One 17b rank: gloo on the shared card, mesh (2, 1)."""
    import torch.distributed as dist

    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.parallel import init_distributed, make_mesh

    cs.check(init_distributed("gloo", timeout_s=600), "17b: no rank environment")
    mesh = make_mesh(MeshConfig(data_parallel=2, model_parallel=1), device_type="cuda")
    t0 = time.perf_counter()
    out = cs.dp_rank(torch, mesh, WORK)
    out["s"] = time.perf_counter() - t0
    print("17b rank result: " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    import torch.distributed as dist

    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.data.splits import split_by_time
    from otto_tpu_torch.data.synthetic import synthetic_events_v2
    from otto_tpu_torch.ops import _kernels, forest, fused_retrieval, fused_sessions, hist, row_topk
    from otto_tpu_torch.parallel import init_distributed, make_mesh
    from otto_tpu_torch.parallel.mesh import launch_local

    if not torch.cuda.is_available():
        print("run_phase17: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _kernels.lib()
    print(f"torch {torch.__version__}; kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    counters = {"fused_stage1": (fused_retrieval.fused_stage1, "launches"),
                "fused_stage1_deep": (fused_retrieval.fused_stage1, "deep_launches"),
                "fused_stage1_fma": (fused_retrieval.fused_stage1, "fma_launches"),
                "peel_rows": (row_topk.peel_rows, "launches"),
                "aid_vote": (fused_sessions.aid_vote_aggregate, "launches"),
                "predict_forest": (forest.predict_forest, "launches"),
                "predict_forest_rows": (forest.predict_forest_rows, "launches"),
                "bin_rows": (forest.bin_rows, "launches"),
                "node_histograms": (hist.node_histograms, "launches")}

    def zero():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read(path, expected):
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        print(f"kernel launches in the {path}: {launches}", flush=True)
        for name in expected:
            cs.check(launches[name] > 0, f"{name} was not launched by the {path}")
        return launches

    fit = json.loads((cs.REPO / "artifacts" / "bench_e2e" / "bench_fit.json").read_text())
    split = split_by_time(synthetic_events_v2(n_sessions=fit["sessions"], n_aids=fit["aids"],
                                              seed=fit["seed"]),
                          val_fraction=fit["val_fraction"], seed=fit["seed"])
    with cs.phase("11c the bench refit (phase 17's fold)"):
        fold = cs.refit(torch, dev, split, zero, read)["fold"]
    with cs.phase("11a the histogram kernel vs its twin on the fold"):
        print(json.dumps(cs.hist_vs_twin(torch, dev, fold)), flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        env = cs.mesh_env()
        os.environ.update(env)
        try:
            cs.check(init_distributed("nccl", timeout_s=300), "17a: no process group")
            with cs.phase("17a one NCCL rank, mesh (1, 1)"):
                cs.dp_world1(torch, dev, make_mesh(MeshConfig(), device_type="cuda"), fold,
                             WORK, (zero, read))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for k in env:
                os.environ.pop(k, None)
        del fold
        torch.cuda.empty_cache()
        with cs.phase("17b two gloo ranks sharing the card, mesh (2, 1)"):
            for out in launch_local([sys.executable, __file__, "--rank"], 2, timeout_s=600,
                                    env={"PYTHONPATH": str(cs.REPO)}, cwd=cs.REPO):
                print(out.strip().splitlines()[-1], flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print("phase 17 ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main() if sys.argv[1:2] == ["--rank"] else main())
