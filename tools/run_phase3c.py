"""Run ``chip_smoke.py``'s phases 3 and 3c (the retrieval backends) alone on
a card.

    python3 tools/run_phase3c.py

Phase 3 makes the seeded 1,855,603 x 32 table (through ``SGNSModel.save`` /
``load``) and checks the compensated retriever; phase 3c then runs, with
``chip_smoke.py``'s own functions and checks: 3c-i the int8 stage-1 kernel
against its twin on one 4,096-query batch of the full catalog, both
metrics, with its times, ``torch._int_mm``'s bare product and the bound;
3c-ii ``build_neighbor_table(backend="int8")`` with its launches, bytes and
recall; 3c-iii ``topk_hybrid`` and ``topk_approx`` on the float32 and bf16
tables; 3c-iv ``rescore_survivors=True``; then, outside ``chip_smoke.py``,
one ``build_neighbor_table(backend="hybrid")`` on phase 3's float32 table
(stage 1's FMA kernel, 454 launches), with its seconds, launches and recall
on 256 aids against the exact scan.  Prints the card's name and power limit
first, the ptxas report of the int8 and FMA kernels, each phase's seconds,
the kernel's record, and ``phase 3c ok`` last; needs a CUDA card and
imports nothing of JAX.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WORK = cs.REPO / "tmp" / "run_phase3c"


def hybrid_neighbor_table(torch, dev, w_in, zero_counters, read_counters,
                          n_recall: int = 256) -> dict:
    """``build_neighbor_table(backend="hybrid")`` over the float32 table:
    its seconds, the FMA kernel and the peel once a query batch and no other
    stage-1 route, and recall on ``n_recall`` aids against the exact scan."""
    import numpy as np

    from otto_tpu_torch.ops.retrieval import build_neighbor_table, topk_scan

    n = w_in.shape[0]
    zero_counters()
    t0 = time.perf_counter()
    table = build_neighbor_table(w_in, k=cs.K_NNS, backend="hybrid", device=dev)
    secs = time.perf_counter() - t0
    launches = read_counters("float32 hybrid neighbor table", ("fused_stage1_fma", "peel_rows"))
    batches = -(-n // cs.QUERY_BATCH)
    cs.check(launches["fused_stage1_fma"] == batches and launches["peel_rows"] == batches
             and not any(launches[r] for r in ("fused_stage1", "fused_stage1_deep",
                                               "fused_stage1_int8")),
             f"hybrid table: {launches} for {batches} query batches")
    ids = torch.as_tensor(np.random.default_rng(cs.SEED + 9).choice(n, n_recall, replace=False),
                          device=dev)
    rows = ids.cpu().numpy()
    want = cs.without_self(topk_scan(w_in[ids], w_in, k=cs.K_NNS + 1, block=cs.SCAN_BLOCK,
                                     metric="euclidean")[1].cpu().numpy(), rows, cs.K_NNS)
    rec = cs.overlap(table[rows], want)
    print(f"build_neighbor_table(backend='hybrid') {n} x {w_in.shape[1]} float32, "
          f"k={cs.K_NNS}: {secs:.3f} s; launches {launches}; recall on {n_recall} aids vs the "
          f"exact scan {rec:.4f} (limit {cs.INT8_RECALL})", flush=True)
    cs.check(rec >= cs.INT8_RECALL, f"hybrid table: recall {rec}")
    return {"s": secs, "launches": launches, "recall": rec}


def main() -> int:
    from otto_tpu_torch.ops import _kernels, fused_retrieval, row_topk

    if not torch.cuda.is_available():
        print("run_phase3c: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    print(f"torch {torch.__version__}; kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    report = path.with_suffix(".ptxas.txt").read_text().splitlines()
    for i, line in enumerate(report):
        if ("fused_stage1_int8_kernel" in line or "fused_stage1_fma_kernel" in line) \
                and "Compiling entry" in line:
            print("\n".join(x.strip() for x in report[i:i + 4]), flush=True)
    counters = {"fused_stage1": (fused_retrieval.fused_stage1, "launches"),
                "fused_stage1_deep": (fused_retrieval.fused_stage1, "deep_launches"),
                "fused_stage1_fma": (fused_retrieval.fused_stage1, "fma_launches"),
                "fused_stage1_int8": (fused_retrieval.fused_stage1_int8, "launches"),
                "peel_rows": (row_topk.peel_rows, "launches")}

    def zero():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read(path, expected):
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        print(f"kernel launches in the {path}: {launches}", flush=True)
        for name in expected:
            cs.check(launches[name] > 0, f"{name} was not launched by the {path}")
        return launches

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        with cs.phase("3 full-width retrieval"):
            model = cs.retrieval(torch, dev, cs.N_AIDS, cs.QUERY_BATCH, 256, WORK)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    with cs.phase("3c-i the int8 stage-1 kernel vs its twin on the full catalog"):
        record = cs.int8_stage1_vs_twin(torch, dev, model.w_in, cs.QUERY_BATCH)
    torch.cuda.empty_cache()
    with cs.phase("3c-ii build_neighbor_table(backend='int8') on the full catalog"):
        table = cs.int8_neighbor_table(torch, dev, model.w_in, cs.QUERY_BATCH, zero, read)
    with cs.phase("3c-iii topk_hybrid and topk_approx on the full catalog"):
        hybrid = cs.hybrid_approx(torch, dev, model.w_in, cs.QUERY_BATCH, zero, read)
    with cs.phase("3c-iv rescore_survivors on the compensated retriever"):
        survivors = cs.survivors_batch(torch, dev, table.pop("retriever"), cs.QUERY_BATCH, zero,
                                       read)
    with cs.phase("build_neighbor_table(backend='hybrid') on the full catalog"):
        hybrid_table = hybrid_neighbor_table(torch, dev, model.w_in, zero, read)
    record["launches"] = table["launches"]["fused_stage1_int8"]
    print(json.dumps({"kernel": record, "int8_table": table, "hybrid_approx": hybrid,
                      "rescore_survivors": survivors, "hybrid_table": hybrid_table}),
          flush=True)
    print("phase 3c ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
