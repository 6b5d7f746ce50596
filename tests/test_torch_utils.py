"""The port's training utilities, oracle and plots against ``otto_tpu``'s
on the CPU: ``utils/{checkpoint,failure,prng,profiling,roofline}.py``
(mirroring ``tests/test_failure.py``, ``tests/test_roofline.py`` with an
H100's peaks, and the utility cases of ``tests/test_utils_viz.py``),
``eval/oracle.py`` (equal to the JAX package's copy on
``tests/test_oracle_parity.py``'s store) and ``visualization.py``.
"""

import numpy as np
import pytest
import torch

from otto_tpu.eval import oracle as joracle
from otto_tpu.utils.roofline import roofline as j_roofline
from otto_tpu_torch import EVENT_TYPES
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.splits import split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events, synthetic_events_v2
from otto_tpu_torch.eval import oracle as toracle
from otto_tpu_torch.utils.checkpoint import CheckpointManager
from otto_tpu_torch.utils.failure import TrainingGuard, nonfinite_count
from otto_tpu_torch.utils.prng import host_rng, set_seed
from otto_tpu_torch.utils.profiling import device_memory_stats, trace
from otto_tpu_torch.utils.roofline import PEAKS, chip_peaks, peaks_for_name, roofline

torch.set_num_threads(1)


# ---------------------------------------------------------- checkpoint --
def test_checkpoint_roundtrip_nested_with_template(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": torch.tensor(5)}
    mgr.save(1, state)
    mgr.save(2, {"params": {"w": torch.ones(2, 3)}, "step": torch.tensor(6)})
    assert mgr.latest_step() == 2
    restored = mgr.restore(1, template=state)
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert int(restored["step"]) == 5
    # each tensor takes the template's dtype (and device) under its name
    template = {"params": {"w": torch.zeros(2, 3, dtype=torch.float64)},
                "step": torch.zeros((), dtype=torch.int32)}
    restored = mgr.restore(2, template=template)
    assert restored["params"]["w"].dtype == torch.float64
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 6
    assert mgr.restore()["params"]["w"].dtype == torch.float32  # no template: as saved
    with pytest.raises(KeyError):
        mgr.restore(2, template={"other": torch.zeros(1)})
    mgr.close()


def test_checkpoint_retention(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    for step in range(4):
        mgr.save(step, {"x": torch.tensor(step)})
    assert mgr.all_steps() == [2, 3]
    mgr.close()


def test_checkpoint_resume_mid_training_with_optimizer_state(tmp_path):
    """Interrupted after step 3, checkpointed (parameters and Adam's state),
    resumed in a fresh optimizer: the same final parameters as an
    uninterrupted run."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(32, 4)).astype(np.float32))
    y = torch.tensor(rng.normal(size=(32,)).astype(np.float32))

    def run(w, opt, n):
        for _ in range(n):
            opt.zero_grad()
            ((x @ w - y) ** 2).mean().backward()
            opt.step()

    w = torch.zeros(4, requires_grad=True)
    run(w, torch.optim.Adam([w], lr=0.1), 6)
    ref = w.detach().clone()

    w = torch.zeros(4, requires_grad=True)
    opt = torch.optim.Adam([w], lr=0.1)
    run(w, opt, 3)
    st = opt.state[w]
    CheckpointManager(tmp_path / "resume").save(3, {"w": w.detach(), "m": st["exp_avg"],
                                                   "v": st["exp_avg_sq"], "t": st["step"]})
    w2 = torch.zeros(4, requires_grad=True)
    opt2 = torch.optim.Adam([w2], lr=0.1)
    template = {"w": torch.zeros(4), "m": torch.zeros(4), "v": torch.zeros(4),
                "t": torch.zeros(())}
    restored = CheckpointManager(tmp_path / "resume").restore(template=template)
    with torch.no_grad():
        w2.copy_(restored["w"])
    opt2.state[w2] = {"exp_avg": restored["m"], "exp_avg_sq": restored["v"],
                      "step": restored["t"]}
    run(w2, opt2, 3)
    torch.testing.assert_close(w2.detach(), ref, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ failure --
def test_nonfinite_count():
    clean = {"a": torch.ones(3, 3), "b": {"c": torch.zeros(5), "i": torch.arange(4)}}
    assert int(nonfinite_count(clean)) == 0
    dirty = {"a": torch.tensor([1.0, float("nan"), float("inf")]),
             "b": {"c": torch.ones(2, dtype=torch.float64), "i": torch.arange(3)}}
    assert int(nonfinite_count(dirty)) == 2
    assert int(nonfinite_count({"i": torch.arange(3)})) == 0


def _toy_step(params, x):
    # scalar quadratic: params converge toward x
    w = params["w"]
    return {"w": w - 0.1 * 2 * (w - x)}, ((w - x) ** 2).sum()


def test_guard_rolls_back_on_nan(tmp_path):
    mgr = CheckpointManager(tmp_path / "g")
    guard = TrainingGuard(mgr, save_every=5, max_rollbacks=2)
    params = {"w": torch.zeros(4)}
    params, step = guard.resume(params)
    assert step == 0

    poisoned = {17}  # first visit to step 17 produces a NaN loss
    seen_bad = False
    while step < 30:
        step += 1
        new_params, loss = _toy_step(params, 1.0)
        if step in poisoned:
            poisoned.discard(step)
            loss = torch.tensor(float("nan"))
        params, step, ok = guard.observe(step, new_params, loss)
        if not ok:
            seen_bad = True
            assert step == 15  # rewound to the last multiple of save_every
            assert torch.equal(params["w"], mgr.restore(15)["w"])
    assert seen_bad
    assert guard.rollbacks == 1
    assert guard.failures[0]["step"] == 17
    torch.testing.assert_close(params["w"], torch.ones(4), atol=1e-2, rtol=0)
    mgr.close()


def test_guard_checks_the_state(tmp_path):
    """With ``check_state_every`` a NaN in the state rolls back though the
    loss is finite."""
    mgr = CheckpointManager(tmp_path / "gs")
    guard = TrainingGuard(mgr, save_every=2, check_state_every=1)
    params = {"w": torch.zeros(3)}
    params, step, ok = guard.observe(2, params, torch.tensor(0.5))
    assert ok
    bad = {"w": torch.tensor([0.0, float("nan"), 0.0])}
    params, step, ok = guard.observe(3, bad, torch.tensor(0.5))
    assert not ok and step == 2 and torch.equal(params["w"], torch.zeros(3))
    mgr.close()


def test_guard_raises_without_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path / "g2")
    guard = TrainingGuard(mgr, save_every=5)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        guard.observe(1, {"w": torch.zeros(2)}, torch.tensor(float("nan")))
    mgr.close()


def test_guard_gives_up_after_max_rollbacks(tmp_path):
    mgr = CheckpointManager(tmp_path / "g3")
    guard = TrainingGuard(mgr, save_every=1, max_rollbacks=2)
    params = {"w": torch.ones(2)}
    params, step, ok = guard.observe(1, params, torch.tensor(0.5))  # checkpoint
    assert ok
    for i in range(2):
        params, step, ok = guard.observe(2 + i, params, torch.tensor(float("nan")))
        assert not ok and step == 1
    with pytest.raises(RuntimeError, match="exceeded"):
        guard.observe(5, params, torch.tensor(float("nan")))
    mgr.close()


def test_guard_resume_after_crash(tmp_path):
    """A fresh guard over the same directory resumes from the last
    checkpoint, in the dtype of the state it is given."""
    mgr = CheckpointManager(tmp_path / "g4")
    guard = TrainingGuard(mgr, save_every=2)
    params = {"w": torch.zeros(3)}
    step = 0
    while step < 6:
        step += 1
        params, loss = _toy_step(params, 2.0)
        params, step, _ = guard.observe(step, params, loss)
    saved_w = params["w"].clone()
    mgr.close()

    guard2 = TrainingGuard(CheckpointManager(tmp_path / "g4"), save_every=2)
    restored, step = guard2.resume({"w": torch.zeros(3, dtype=torch.float64)})
    assert step == 6
    assert restored["w"].dtype == torch.float64
    assert torch.equal(restored["w"], saved_w.double())


# ---------------------------------------------------- prng, profiling --
def test_set_seed_returns_a_seeded_generator():
    import random

    g = set_seed(42)
    a = (random.random(), np.random.random(), torch.rand(1).item(),
         torch.rand(3, generator=g))
    g = set_seed(42)
    b = (random.random(), np.random.random(), torch.rand(1).item(),
         torch.rand(3, generator=g))
    assert a[:3] == b[:3] and torch.equal(a[3], b[3])
    assert isinstance(g, torch.Generator)
    np.testing.assert_array_equal(host_rng(3).random(4), np.random.default_rng(3).random(4))


def test_memory_stats_of_the_cpu_are_empty():
    assert device_memory_stats("cpu") == {}


def test_profiler_trace_writes_a_trace(tmp_path):
    d = tmp_path / "trace"
    with trace(d) as prof:
        torch.arange(16.0).sum().item()
    files = list(d.rglob("*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert any("aten::sum" in e.key for e in prof.key_averages())


# ------------------------------------------------------------ roofline --
def test_roofline_fractions_on_h100_peaks():
    # 3,350 GB moved in 2 s = 1,675 GB/s = half the H100's memory rate
    r = roofline(2.0, hbm_bytes=3350e9)
    assert r["hbm_gbps"] == 1675.0
    assert abs(r["hbm_frac"] - 0.5) < 1e-6
    assert r["bound"] == "hbm"
    # 989 TFLOP of bf16 work in 2 s = half the tensor-core peak
    r = roofline(2.0, bf16_flops=989e12)
    assert abs(r["mxu_frac"] - 0.5) < 1e-6
    assert r["bound"] == "mxu"
    # float32 operations compare against the float32 peak
    r = roofline(1.0, f32_flops=67e12)
    assert abs(r["mxu_frac"] - 1.0) < 1e-6
    # the same accounting as the reference's, on other peaks
    ratio = PEAKS["h100"].hbm_gbps / 819.0
    assert abs(roofline(1.0, hbm_bytes=1e12)["hbm_frac"] * ratio
               - j_roofline(1.0, hbm_bytes=1e12)["hbm_frac"]) < 1e-3


def test_chip_peaks():
    assert chip_peaks(None) == PEAKS["h100"] == chip_peaks("cpu")
    assert peaks_for_name("NVIDIA H100 80GB HBM3") == PEAKS["h100"]
    assert PEAKS["h100"].hbm_gbps == 3350.0 and PEAKS["h100"].bf16_tflops == 989.0
    assert PEAKS["h100"].f32_tflops == 67.0


def test_unknown_card_has_no_peaks(monkeypatch):
    assert peaks_for_name("NVIDIA A100-SXM4-80GB") is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Tesla T4")
    with pytest.raises(ValueError, match="Tesla T4"):
        chip_peaks("cuda:0")
    with pytest.raises(ValueError, match="Tesla T4"):
        roofline(1.0, hbm_bytes=1e9, device="cuda:0")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert chip_peaks("cuda:0") == PEAKS["h100"]


@pytest.mark.parametrize("k,derate", [(16, 1.0), (32, 1.0), (34, 34 / 48), (8, 0.5),
                                      (128, 1.0), (198, 198 / 208)])
def test_roofline_light_frac_wgmma_derate(k, derate):
    # k / (16 ceil(k / 16)) of the bf16 peak: 989 * derate TFLOP of work
    # then takes 1 s at speed-of-light; measured at 2 s -> light_frac 0.5
    r = roofline(2.0, hbm_bytes=1e9, bf16_flops=989e12 * derate, k_dim=k)
    assert r["light_bound"] == "mxu"
    assert abs(r["light_s"] - 1.0) < 1e-3
    assert abs(r["light_frac"] - 0.5) < 1e-3


def test_roofline_light_bound_flips_to_memory():
    r = roofline(2.0, hbm_bytes=6700e9, bf16_flops=1e12, k_dim=128)
    assert r["light_bound"] == "hbm"
    assert abs(r["light_s"] - 2.0) < 1e-3
    assert abs(r["light_frac"] - 1.0) < 1e-3


# -------------------------------------------------------------- oracle --
N_AIDS = 900


@pytest.fixture(scope="module")
def oracle_inputs():
    """``tests/test_oracle_parity.py``'s store and split, seeded neighbor
    tables (-1 padded, some rows empty) and frequency lists."""
    store = synthetic_events_v2(n_sessions=3000, n_aids=N_AIDS, mean_length=13.0,
                                n_clusters=40, seed=11)
    split = split_by_time(store, val_fraction=0.25, seed=3)
    rng = np.random.default_rng(5)
    tables = {}
    for kind in ("time_weighted", "click_weighted", "cart_weighted", "click_cart",
                 "cart_order"):
        t = rng.integers(0, N_AIDS, (N_AIDS, 50)).astype(np.int32)
        t[np.arange(50)[None] >= rng.integers(0, 51, N_AIDS)[:, None]] = -1
        tables[kind] = t
    ft = np.argsort(rng.random((N_AIDS, N_AIDS)), axis=1)[:, :46].astype(np.int32)
    counts = np.bincount(split.train.aid, minlength=N_AIDS)
    freq = {t: [int(a) for a in np.argsort(-counts, kind="stable")[i:i + 20]]
            for i, t in enumerate(EVENT_TYPES)}
    return split, tables, ft, freq


def test_oracle_equal_to_jax_copy(oracle_inputs):
    split, tables, ft, freq = oracle_inputs
    inp = split.val_input
    lists = toracle.store_to_lists(inp)
    assert lists == joracle.store_to_lists(inp)
    for k in (None, 15):
        for t in tables.values():
            assert toracle.table_to_dict(t, k) == joracle.table_to_dict(t, k)
    assert toracle.neighbor_lists(ft) == joracle.neighbor_lists(ft)
    labels = toracle.labels_to_lists(split.val_labels)
    assert labels == joracle.labels_to_lists(split.val_labels)

    narrow = {k: toracle.table_to_dict(t, 15) for k, t in tables.items()}
    wide = {k: toracle.table_to_dict(t) for k, t in tables.items()}
    nn45 = toracle.neighbor_lists(ft[:, 1:])
    nn20 = toracle.neighbor_lists(ft[:, 1:21])
    got = toracle.oracle_heuristic(*lists, narrow, freq, nn45)
    want = joracle.oracle_heuristic(*lists, narrow, freq, nn45)
    assert got == want
    assert toracle.oracle_heuristic(*lists, narrow, freq, None) == \
        joracle.oracle_heuristic(*lists, narrow, freq, None)
    assert toracle.oracle_regular_candidates(*lists, wide, nn20) == \
        joracle.oracle_regular_candidates(*lists, wide, nn20)
    r = toracle.weighted_corpus_recall(got, labels)
    assert r == joracle.weighted_corpus_recall(want, labels) and 0 < r["weighted"] < 1
    assert toracle.corpus_recall(got["clicks"], labels[0]) == r["clicks"]


# ------------------------------------------------------- visualization --
@pytest.fixture(scope="module")
def viz_store():
    return synthetic_events(n_sessions=300, n_aids=500, mean_length=8.0, seed=7)


def test_visualizations_write_files(tmp_path, viz_store):
    pytest.importorskip("matplotlib")
    from otto_tpu_torch import visualization as viz

    rng = np.random.default_rng(0)
    paths = [
        viz.visualize_learning_curve([{"epoch": 0, "train_loss": 1.0, "val_loss": 1.1},
                                      {"epoch": 1, "train_loss": 0.5, "val_loss": 0.7}],
                                     tmp_path / "curve.png"),
        viz.visualize_predictions(rng.normal(size=100), rng.normal(size=100),
                                  tmp_path / "pred.png"),
        viz.visualize_session(viz_store, 0, tmp_path / "session.png"),
        viz.visualize_aid_frequencies(np.bincount(viz_store.aid, minlength=500).astype(float),
                                      tmp_path / "freq.png"),
        viz.visualize_feature_importance({"f1": 0.5, "f2": 0.1}, tmp_path / "imp.png"),
        viz.visualize_distributions(viz_store, tmp_path / "dist.png"),
        viz.visualize_feature_distribution(rng.normal(size=500), rng.normal(0.5, 1.2, size=300),
                                           "session_count", tmp_path / "feat.png"),
    ]
    assert all(p.exists() and p.stat().st_size > 0 for p in paths)


class _Linear:
    """A scorer with the port's ``predict(x, m, device=)`` and the
    reference's ``predict(x, m)``."""

    def __init__(self, w):
        self.w = w

    def predict(self, x, m, device=None):
        return np.where(m, x @ self.w, -np.inf)


def test_permutation_importance_equal_to_jax():
    from otto_tpu.visualization import permutation_importance as j_perm
    from otto_tpu_torch.visualization import permutation_importance as t_perm

    rng = np.random.default_rng(1)
    X = rng.normal(size=(120, 6, 3)).astype(np.float32)
    y = (rng.random((120, 6)) < 0.3).astype(np.int8)
    m = rng.random((120, 6)) < 0.9
    model = _Linear(np.array([2.0, -0.5, 0.0], np.float32))
    names = ["a", "b", "c"]
    assert t_perm(model, X, y, m, names, n_sessions=80, device="cpu") == \
        j_perm(model, X, y, m, names, n_sessions=80)


def test_permutation_importance_identifies_signal():
    from otto_tpu_torch.config import RankerConfig
    from otto_tpu_torch.models.ranker import RankerData, train_ranker
    from otto_tpu_torch.visualization import permutation_importance

    rng = np.random.default_rng(0)
    S, C, F = 200, 8, 4
    X = rng.normal(size=(S, C, F)).astype(np.float32)
    y = (X[:, :, 0] > 0.8).astype(np.int8)  # only feature 0 matters
    m = np.ones((S, C), bool)
    data = RankerData(X, y, m, np.arange(S), rng.integers(0, 100, (S, C)).astype(np.int32),
                      [f"f{i}" for i in range(F)])
    cfg = RankerConfig(hidden_dims=(16,), loss="bce", n_folds=2, epochs=10,
                       batch_sessions=64, learning_rate=1e-2, dropout=0.0)
    model, _ = train_ranker(data, cfg, device="cpu")
    imp = permutation_importance(model, X, y, m, data.feature_names, n_sessions=100,
                                 device="cpu")
    assert imp["f0"] == max(imp.values())


def test_store_lists_of_a_port_store():
    """``store_to_lists`` reads the port's EventStore (offsets, aids, types)."""
    es = EventStore.from_flat(np.array([4, 4, 9]), np.array([7, 8, 7]), np.arange(3),
                              np.array([0, 1, 2], np.int8))
    assert toracle.store_to_lists(es) == ([[7, 8], [7]], [[0, 1], [2]])
