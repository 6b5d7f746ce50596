"""The serve driver end to end at a tiny size on the CPU (1,000 aids, shards
of 64 sessions), and the check's control and planted faults coming out not
correct.  The card's own run of a cell is ``test_cell_on_the_card``."""

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from benchkit import spec as S

BENCH = S.load_spec()
SEED = 3_141_592_653  # above 2**31, as the driver's seeds are


def tiny(workload: str, n_aids: int = 1000):
    """The cell at 1,000 aids and small shards, held to the limits of
    ``limits/<workload>.json``."""
    config, mix = workload.split(".")
    cell = {"name": workload, "config": config, "traffic": mix, "chips": 1}
    cfg = dict(S.config(BENCH, config), n_aids=n_aids)
    traffic = dict(S.traffic(mix))
    # long sessions, so that the recency route has some tens of them
    traffic.update(pool_sessions=512, shard_sessions=64, mean_length=30.0,
                   check_model_sessions=32, check_recency_sessions=64)
    return cell, cfg, traffic, S.load_module("drivers", traffic["driver"]), S.limits(workload)


def over(checks: dict, limits: dict) -> list[str]:
    return [k for k, lim in limits.items() if not checks.get(k, math.inf) <= lim]


@pytest.mark.parametrize("workload", ["sasrec.serve", "gru4rec.serve"])
def test_run_end_to_end_is_correct(workload):
    cell, cfg, traffic, driver, limits = tiny(workload)
    res = driver.run(cell, cfg, traffic, SEED, 0.2, False, time.perf_counter(), device="cpu")
    assert set(res["end_to_end"]) == {m["name"] for m in S.end_to_end_for(BENCH, workload)}
    assert all(v > 0 for v in res["end_to_end"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    assert over(res["checks"], limits) == [], res["checks"]


@pytest.mark.parametrize("workload", ["sasrec.serve", "gru4rec.serve"])
def test_serve_control_fails(workload):
    _, cfg, traffic, driver, limits = tiny(workload)
    sound = driver.readings(cfg, traffic, SEED, device="cpu")
    assert over(sound["checks"], limits) == []
    assert over(driver.control(sound["state"], cfg), limits)


@pytest.mark.parametrize("fault, fails", [("altered_token", "model_gap"),
                                          ("reversed", "model_misrank"),
                                          ("shuffled", "model_misrank"),
                                          ("half_catalog", "model_misrank")])
def test_serve_faults_fail(fault, fails):
    _, cfg, traffic, driver, limits = tiny("sasrec.serve")
    bad = driver.readings(cfg, traffic, SEED, device="cpu", fault=fault)
    assert fails in over(bad["checks"], limits), bad["checks"]


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sasrec.serve",
                        "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
                       cwd=S.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["busy_s"] > 0
    assert set(out["metrics"]) == {m["name"] for m in S.per_layer_for(BENCH, "sasrec.serve")}
