"""The port's ten examples (``examples/torch/01-10``) through their
``main`` on the CPU at tiny sizes.

01 and 02 return what the JAX package's own functions give on the same
store (``otto_tpu.data.synthetic``, ``splits`` and ``eval.metrics``):
equal counts, equal type mix, the same worked session and recalls.  The
deterministic numbers of 03, 04 and 10 are held to the JAX package on the
same store too: 03's aid_weight and covisitation rows to
``otto_tpu.pipelines``' runners, 04's counts to its store, 10's heuristic
recall to its heuristic on the same held-out sessions.  Their trained rows
and 07's rates can only be held to their ranges.  06's serving process's lists equal the training process's; 09's
heuristic agrees with the oracle exactly on the covisitation route and its
candidates everywhere.
05 and 08 share one launch of two ``gloo`` ranks (this file run as a
script; no JAX in the ranks), each rank calling both examples' ``main`` in
its rank mode: 08's strategies start from the same loss and end within its
spread, 05 measures every mesh size.  The card case (``cuda``) runs 03 at a
tiny size over 70,000 aids and checks that every kernel of its path
launched.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
ARGV_05 = ["--device", "cpu", "--world", "2", "--iters", "2", "--per-dev-batch", "8",
           "--rows-per-dev", "1024", "--pairs-per-dev", "64"]
ARGV_08 = ["--device", "cpu", "--dp", "1", "--mp", "2", "--mesh3d", "1,2,1", "--steps", "3",
           "--sessions", "300", "--aids", "200", "--batch", "32"]
ROWS_03 = "aid_weight,covisitation,embedding_knn,two_stage (gbdt engine)"


def example(number: str):
    from otto_tpu_torch.utils.runtime import load_file

    path = next((REPO / "examples" / "torch").glob(f"{number}_*.py"))
    return load_file(path, f"otto_example_{path.stem}")


# ---------------------------------------------------------------------------
# the ranks of the 05 + 08 launch (this file run as a script)
# ---------------------------------------------------------------------------


def _worker(out: Path) -> None:
    import torch
    import torch.distributed as dist

    from otto_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    assert init_distributed("gloo", timeout_s=100)
    got = {"05": example("05").main([*ARGV_05, "--rank-backend", "gloo", "--sizes", "1,2"]),
           "08": example("08").main([*ARGV_08, "--rank-backend", "gloo"])}
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "otto_tpu"))
    assert not bad, bad
    (out / f"rank{dist.get_rank()}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(Path(sys.argv[1]))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_01_counts_equal_to_the_jax_package(tmp_path):
    from otto_tpu.data.synthetic import synthetic_events

    got = example("01").main(["--device", "cpu", "--sessions", "300", "--aids", "120",
                              "--chunk-sessions", "100", "--out-dir", str(tmp_path)])
    want = synthetic_events(n_sessions=300, n_aids=120)
    assert got["read_back_equal"] and got["chunks"] == 3
    assert (got["n_events"], got["n_sessions"]) == (want.n_events, want.n_sessions)
    assert got["mean_length"] == float(want.lengths.mean())
    assert got["max_length"] == int(want.lengths.max())


def test_02_numbers_equal_to_the_jax_package(tmp_path):
    from otto_tpu.data import splits
    from otto_tpu.data.synthetic import synthetic_events
    from otto_tpu.eval.metrics import cart_order_recall_at_k, click_recall_at_k

    got = example("02").main(["--device", "cpu", "--sessions", "400", "--aids", "150",
                              "--session", "3", "--out-dir", str(tmp_path)])
    store = synthetic_events(n_sessions=400, n_aids=150)
    assert (got["n_events"], got["n_sessions"]) == (store.n_events, store.n_sessions)
    np.testing.assert_array_equal(got["type_mix"], np.bincount(store.type) / store.n_events)
    assert got["top_aid_count"] == np.bincount(store.aid, minlength=150).max()
    sp = splits.split_by_fraction(store, val_fraction=0.2)
    lo, hi = sp.val_input.offsets[3], sp.val_input.offsets[4]
    own = list(dict.fromkeys(sp.val_input.aid[lo:hi][::-1].tolist()))[:20]
    assert got["own_aids"] == own and got["session_id"] == int(sp.val_input.session_ids[3])
    preds = np.full((1, 20), -1, np.int32)
    preds[0, :len(own)] = own
    click, _ = click_recall_at_k(preds, sp.val_labels.click[3:4])
    cart, _ = cart_order_recall_at_k(preds, sp.val_labels.padded("carts")[3:4])
    for g, w in ((got["click_recall"], float(click)), (got["cart_recall"], float(cart))):
        assert g == w or (math.isnan(g) and math.isnan(w))


def test_03_rows_report_recalls():
    from otto_tpu import pipelines
    from otto_tpu.data import splits
    from otto_tpu.data.synthetic import synthetic_events

    got = example("03").main(["--device", "cpu", "--sessions", "240", "--aids", "150",
                              "--epochs", "1", "--gbdt-trees", "5", "--models", ROWS_03])
    assert list(got["rows"]) == ROWS_03.split(",")
    sp = splits.split_by_fraction(synthetic_events(n_sessions=240, n_aids=150, mean_length=12.0),
                                  val_fraction=0.25)
    want = {"aid_weight": pipelines.run_aid_weight(sp.val_input, sp.val_labels).report,
            "covisitation": pipelines.run_covisit_heuristic(sp.train, sp.val_input, 150,
                                                            sp.val_labels).report}
    keys = ("weighted", "clicks", "carts", "orders")
    for name, report in want.items():
        np.testing.assert_allclose([got["rows"][name][k] for k in keys],
                                   [float(getattr(report, k)) for k in keys], rtol=0, atol=1e-6,
                                   err_msg=name)
    for name in ("embedding_knn", "two_stage (gbdt engine)"):  # trained: only their range
        assert all(0.0 <= got["rows"][name][k] <= 1.0 for k in keys)
    assert 0.0 < got["candidate_ceiling"]["weighted"] <= 1.0


def test_04_rates_are_positive():
    from otto_tpu.data.synthetic import synthetic_events

    got = example("04").main(["--device", "cpu", "--sessions", "300", "--aids", "200"])
    assert got["device"] == "cpu"
    es = synthetic_events(n_sessions=300, n_aids=200, mean_length=12, seed=7)
    assert (got["n_events"], got["n_sessions"]) == (es.n_events, es.n_sessions)
    assert all(got[k] > 0 for k in ("covisit_events_per_s", "heuristic_sessions_per_s",
                                    "candidate_sessions_per_s", "candidates_per_s"))


@pytest.fixture(scope="module")
def mesh_examples(tmp_path_factory):
    from otto_tpu_torch.parallel.mesh import launch_local

    d = tmp_path_factory.mktemp("mesh_examples")
    env = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    launch_local([sys.executable, __file__, str(d)], 2, timeout_s=120, env=env)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]


def test_05_measures_every_mesh_size(mesh_examples):
    rows = mesh_examples[0]["05"]
    for study in ("ranker", "sgns"):
        assert sorted(rows[study], key=int) == ["1", "2"]
        assert all(rate > 0 and secs > 0 for rate, secs in rows[study].values())


def test_08_strategies_optimize_the_same_objective(mesh_examples):
    ex = example("08")
    for rank in mesh_examples:
        res = rank["08"]
        ex.check(res)
        firsts = {res[k]["first"] for k in ex.SAME_OBJECTIVE}
        assert max(firsts) - min(firsts) < 1e-5, firsts
        assert math.isfinite(res["ep"]["last"])
    assert mesh_examples[0]["08"] == mesh_examples[1]["08"]


def test_06_serving_process_equals_the_trainer(tmp_path):
    got = example("06").main([str(tmp_path / "artifacts"), "--device", "cpu", "--sessions", "300",
                              "--aids", "200", "--fresh", "32", "--epochs", "1"])
    assert got["lists_equal"]
    assert all(got["served"][t].shape == (32, 20) for t in ("clicks", "carts", "orders"))


def test_07_rates_are_positive():
    got = example("07").main(["--device", "cpu", "--sessions", "200", "--aids", "150",
                              "--tower-steps", "1", "--gbdt-sessions", "60", "--gbdt-trees", "2"])
    assert got["gbdt"]["trees"] == 4 and got["gbdt"]["trees_per_s"] > 0
    assert all(got[k][r] > 0 for k, r in (("sgns", "center_events_per_s"), ("cf", "epoch_s"),
                                          ("tower", "candidates_per_s"),
                                          ("sequence", "examples_per_s")))


def test_09_covisitation_route_agrees_exactly():
    got = example("09").main(["--device", "cpu", "--sessions", "1500", "--aids", "400"])
    assert got["covisit_route_sessions"] > 0
    for t in ("clicks", "carts", "orders"):
        assert got["heuristic"][t]["exact_covisit_route"] == 1.0
        assert got["candidates"][t]["exact"] == 1.0


def test_10_two_stage_keeps_the_heuristic():
    from otto_tpu import EVENT_TYPES
    from otto_tpu.data.splits import split_by_time
    from otto_tpu.data.synthetic import synthetic_events_v2
    from otto_tpu.eval.harness import evaluate_predictions
    from otto_tpu.models.covisitation import build_covisitation, covisit_heuristic_predictions
    from otto_tpu.models.frequency import FrequencyStatistics

    got = example("10").main(["--device", "cpu", "--sessions", "800", "--aids", "400",
                              "--epochs", "1"])
    split = split_by_time(synthetic_events_v2(n_sessions=800, n_aids=400, seed=11),
                          val_fraction=0.2, seed=11)
    stats = FrequencyStatistics.compute(split.train, n_aids=400)
    heur = covisit_heuristic_predictions(split.val_input, build_covisitation(split.train, 400),
                                         {t: stats.top_by_type[t] for t in EVENT_TYPES},
                                         recency_host_f64=True)
    hold = got["holdout"]
    want = evaluate_predictions(split.val_labels.take(hold), heur["clicks"][hold],
                                heur["carts"][hold], heur["orders"][hold])
    assert abs(got["heuristic_weighted"] - float(want.weighted)) <= 1e-6
    assert got["two_stage_weighted"] >= got["heuristic_weighted"] - example("10").MARGIN


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_03_launches_every_kernel_of_its_path(cuda_device):
    from otto_tpu_torch.ops import forest, fused_retrieval, fused_sessions, hist, row_topk

    counters = ((fused_retrieval.fused_stage1, "launches"), (row_topk.peel_rows, "launches"),
                (fused_sessions.aid_vote_aggregate, "launches"),
                (forest.predict_forest, "launches"), (forest.bin_rows, "launches"),
                (hist.node_histograms, "launches"))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    got = example("03").main(["--device", "cuda", "--sessions", "600", "--aids", "70000",
                              "--epochs", "1", "--gbdt-trees", "5", "--models",
                              "aid_weight,embedding_knn,two_stage (gbdt engine)"])
    launches = {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in counters}
    assert all(v > 0 for v in launches.values()), launches
    assert all(0.0 <= r["weighted"] <= 1.0 for r in got["rows"].values())
