"""Run ``chip_smoke.py``'s phase 18 (model and expert parallelism) alone on a
card.

    python3 tools/run_phase18.py

18a runs in one NCCL rank in this process (meshes (1, 1) and (1, 1, 1)),
18b in two ``gloo`` ranks sharing the card (this file run as ``--rank``:
mesh (1, 2), and the 3-D step at (1, 2, 1) and (1, 1, 2)), with
``chip_smoke.py``'s own functions and checks: every family's step at the
full width of ``configs/sequence_transformer.yaml`` and
``configs/sequence_moe.yaml`` over the 1,855,603-aid catalog against the
single-device step.  Prints the card's name and power limit first and
``phase 18 ok`` last; needs a CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from otto_tpu_torch.utils.runtime import device_line  # noqa: E402


def rank_main() -> int:
    """One 18b rank: gloo on the shared card."""
    import torch.distributed as dist

    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.parallel import init_distributed, make_mesh, make_mesh3d, mesh_device

    cs.check(init_distributed("gloo", timeout_s=600), "18b: no rank environment")
    mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=2), device_type="cuda")
    meshes3 = [make_mesh3d(1, 2, 1, device_type="cuda"), make_mesh3d(1, 1, 2, device_type="cuda")]
    zero, read = cs.mesh_counters()
    zero()
    t0 = time.perf_counter()
    out = cs.mp_steps(torch, mesh_device(mesh), mesh, meshes3, "18b", read)
    out["s"] = time.perf_counter() - t0
    cs.check(not any(out["launches"].values()), f"18b launched K1 or K2: {out['launches']}")
    print(f"18b rank {dist.get_rank()} result: " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    import torch.distributed as dist

    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.ops import forest, fused_retrieval, fused_sessions, hist, row_topk
    from otto_tpu_torch.parallel import init_distributed, make_mesh, make_mesh3d
    from otto_tpu_torch.parallel.mesh import launch_local

    if not torch.cuda.is_available():
        print("run_phase18: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(device_line("cuda"), flush=True)
    print(f"torch {torch.__version__}", flush=True)
    counters = {"fused_stage1": (fused_retrieval.fused_stage1, "launches"),
                "fused_stage1_deep": (fused_retrieval.fused_stage1, "deep_launches"),
                "fused_stage1_fma": (fused_retrieval.fused_stage1, "fma_launches"),
                "peel_rows": (row_topk.peel_rows, "launches"),
                "aid_vote": (fused_sessions.aid_vote_aggregate, "launches"),
                "predict_forest": (forest.predict_forest, "launches"),
                "predict_forest_rows": (forest.predict_forest_rows, "launches"),
                "bin_rows": (forest.bin_rows, "launches"),
                "node_histograms": (hist.node_histograms, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)

    def read():
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        print(f"kernel launches in phase 18a: {launches}", flush=True)
        return launches

    for cut in cs.MP_CUTS:
        print(f"phase 18 cut: {cut}", flush=True)
    env = cs.mesh_env()
    os.environ.update(env)
    try:
        cs.check(init_distributed("nccl", timeout_s=300), "18a: no process group")
        with cs.phase("18a one NCCL rank, meshes (1, 1) and (1, 1, 1)"):
            out = cs.mp_steps(torch, dev, make_mesh(MeshConfig(), device_type="cuda"),
                              [make_mesh3d(1, 1, 1, device_type="cuda")], "18a", read)
            cs.check(not any(out["launches"].values()), "phase 18a launched a hand kernel")
            print("18a: " + json.dumps(out), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    torch.cuda.empty_cache()
    with cs.phase("18b two gloo ranks sharing the card, mesh (1, 2), (1, 2, 1), (1, 1, 2)"):
        for out in launch_local([sys.executable, __file__, "--rank"], 2, timeout_s=600,
                                env={"PYTHONPATH": str(cs.REPO)}, cwd=cs.REPO):
            print(out.strip().splitlines()[-1], flush=True)
    print("phase 18 ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main() if sys.argv[1:2] == ["--rank"] else main())
