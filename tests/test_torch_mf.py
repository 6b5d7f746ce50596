"""The port's matrix factorization and collaborative filtering
(``otto_tpu_torch/models/matrix_factorization.py``), its configs and the
model metrics against ``otto_tpu``'s, on the CPU, at small widths
(n_factors 8), on the stores of ``tests/test_matrix_factorization.py``,
with JAX's initial tables injected into the port (its own draws match
JAX's in distribution only).

Tolerances:

- the pair datasets, ``mf_samples``, every numpy draw (the validation split,
  each epoch's permutation) and so every batch: bit-equal;
- the learning rate: equal to optax's float32 staircase;
- each epoch's train and validation loss within 1e-5 relative; the final
  tables within 1e-4 * (|x| + 0.01) (float32 sums in other orders through
  a few hundred adagrad steps); the stopping epoch equal;
- the model metrics: equal (the same numpy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from otto_tpu.config import CFConfig as JCF
from otto_tpu.config import MFConfig as JMF
from otto_tpu.data import loader as jloader
from otto_tpu.data.events import EventStore as JStore
from otto_tpu.data.synthetic import synthetic_events as j_synth
from otto_tpu.eval import model_metrics as jmm
from otto_tpu.models import matrix_factorization as jmf
from otto_tpu_torch.config import CFConfig, MFConfig
from otto_tpu_torch.data import loader as tloader
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.eval import model_metrics as tmm
from otto_tpu_torch.models import matrix_factorization as tmf

torch.set_num_threads(1)

CONFIGS = "configs"
_DEFAULT_RNG = np.random.default_rng


def _both(store: JStore) -> tuple[JStore, EventStore]:
    arrays = (store.session_ids[store.session_idx], store.aid, store.ts, store.type)
    return store, EventStore.from_flat(*arrays)


@pytest.fixture(scope="module")
def block_stores():
    """800 sessions of 8 events over 40 aids in 4 clusters
    (``test_train_cf_learns``'s store)."""
    rng = np.random.default_rng(0)
    S, L, per = 800, 8, 10
    sess = np.repeat(np.arange(S), L)
    clus = rng.integers(0, 4, S)
    aid = (np.repeat(clus, L) * per + rng.integers(0, per, S * L)).astype(np.int64)
    ts = np.tile(np.arange(L), S) * 600  # 10 minutes apart: the 'time' labels mix
    return _both(JStore.from_flat(sess, aid, ts, rng.integers(0, 3, S * L).astype(np.int8)))


@pytest.fixture(scope="module")
def synth_stores():
    """``synthetic_events(300, 100)`` (``test_train_mf_learns``'s store)."""
    return _both(j_synth(n_sessions=300, n_aids=100, mean_length=8, seed=71))


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("name,jcls,tcls", [("matrix_factorization", JMF, MFConfig),
                                            ("collaborative_filtering", JCF, CFConfig)])
def test_published_configs_equal(name, jcls, tcls):
    path = f"{CONFIGS}/{name}.yaml"
    assert tcls.from_yaml(path).to_dict() == jcls.from_yaml(path).to_dict()
    assert tcls().to_dict() == jcls().to_dict()


# ----------------------------------------------------------- pair data --
PAIR_CASES = {
    "diff": lambda m, s, r: m.cf_pairs_diff(s, r),
    "time_mean_all": lambda m, s, r: m.cf_pairs_time(s, r, 1.0, 1.0, "mean"),
    "time_mean_sampled": lambda m, s, r: m.cf_pairs_time(s, r, 1.0, 0.15, "mean"),
    "time_max_all": lambda m, s, r: m.cf_pairs_time(s, r, 1.0, 1.0, "max"),
    "time_max_sampled": lambda m, s, r: m.cf_pairs_time(s, r, 1.0, 0.15, "max"),
    "mf_samples": lambda m, s, r: m.mf_samples(s),
}


@pytest.mark.parametrize("store_name", ["block", "synth"])
@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_datasets_bit_equal(block_stores, synth_stores, store_name, case):
    js, ts = block_stores if store_name == "block" else synth_stores
    want = PAIR_CASES[case](jmf, js, _DEFAULT_RNG(5))
    got = PAIR_CASES[case](tmf, ts, _DEFAULT_RNG(5))
    assert len(got) == len(want) == 3 and len(want[0]) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if case.startswith("time_mean"):
        assert 0 < want[2].mean() < 1  # both labels present


def test_cf_pairs_semantics():
    """The reference's own semantic cases (test_matrix_factorization.py)."""
    es = EventStore.from_flat(np.array([1, 1, 1, 2, 2]), np.array([10, 11, 12, 20, 21]),
                              np.arange(5), np.zeros(5, np.int8))
    x1, x2, y = tmf.cf_pairs_diff(es, _DEFAULT_RNG(0))
    got = {(a, b): float(t) for a, b, t in zip(x1.tolist(), x2.tolist(), y)}
    assert all(got.get(p) == 1.0 for p in ((10, 11), (11, 12), (20, 21)))
    assert all(a != b and (a < 20) == (b < 20) for a, b in got)
    es = EventStore.from_flat(np.array([1, 1, 2, 2]), np.array([5, 6, 7, 8]),
                              np.array([0, 1800, 0, 5 * 3600]), np.zeros(4, np.int8))
    x1, x2, y = tmf.cf_pairs_time(es, _DEFAULT_RNG(0), hour_difference=1.0, sample_frac=1.0)
    d = {(a, b): t for a, b, t in zip(x1.tolist(), x2.tolist(), y.tolist())}
    assert (d[(5, 6)], d[(6, 5)], d[(7, 8)]) == (1.0, 0.0, 0.0)


# ----------------------------------------------------------- lr schedule --
@pytest.mark.parametrize("cfg", [MFConfig(), CFConfig(), MFConfig(learning_rate=0.013,
                                                                  lr_decay_rate=0.7)],
                         ids=["mf", "cf", "odd_rate"])
def test_lr_schedule_equal_to_optax(cfg):
    sched = optax.exponential_decay(cfg.learning_rate, cfg.lr_decay_steps, cfg.lr_decay_rate,
                                    staircase=True)
    for step in (0, 1, 4_999, 5_000, 7_499, 7_500, 22_500):
        want = np.float32(jnp.float32(sched(step)))
        got = tmf.lr_at(cfg, step)
        assert np.float32(got) == want and float(np.float32(got)) == got, (step, got, want)


# ------------------------------------------------------ training protocol --
class _Draws:
    """A numpy Generator that records what the trainer draws."""

    def __init__(self, seed, log):
        self._rng, self._log = _DEFAULT_RNG(seed), log

    def permutation(self, n):
        out = self._rng.permutation(n)
        self._log.append(("permutation", out.copy()))
        return out

    def random(self, *a, **kw):
        out = self._rng.random(*a, **kw)
        self._log.append(("random", out.copy()))
        return out


def _recording_loader(base, log):
    class Loader(base):
        def __iter__(self):
            for batch in super().__iter__():
                log.append(tuple(np.asarray(b).copy() for b in batch))
                yield batch

    return Loader


def _jax_tables(kind: str, cfg, n_sessions: int, n_aids: int) -> dict:
    """The initial tables JAX's train_mf / train_cf draw."""
    key = jax.random.PRNGKey(cfg.seed)
    if kind == "cf":
        return {"embeddings": jax.random.normal(key, (n_aids, cfg.n_factors)) * 0.05}
    k1, k2 = jax.random.split(key)
    return {"session_embeddings": jax.random.normal(k1, (n_sessions, cfg.n_factors)) * 0.05,
            "aid_embeddings": jax.random.normal(k2, (n_aids, cfg.n_factors)) * 0.05}


TRAIN_CASES = {
    # (trainer, store, n_aids, config): mf_rise's validation loss rises
    # after epoch 1 and early stopping fires at epoch 3, so the result is
    # the best epoch's copy (at lr 0.2-0.3 the float32 trajectories of both
    # packages lie 1e-4-3e-3 from a float64 run's after one epoch, so the
    # case keeps to lr 0.1: 1.2e-5 between them); mf_wrap's batch (4,096) exceeds the 2,737
    # training rows, one wrapped batch an epoch; cf_shared's 512-pair
    # batches hit each of the 100 aids ~10 times through x1 and x2 into the
    # one table, and stop early too
    "mf_rise": ("mf", "synth", 100, dict(n_factors=8, epochs=12, early_stopping_patience=2,
                                         batch_size=512, learning_rate=0.1)),
    "mf_wrap": ("mf", "synth", 100, dict(n_factors=8, epochs=20, early_stopping_patience=8,
                                         batch_size=4096, learning_rate=0.02)),
    "cf_shared": ("cf", "synth", 100, dict(n_factors=8, epochs=6, early_stopping_patience=2,
                                           batch_size=512, learning_rate=0.2)),
}


def _run_both(case, stores, monkeypatch):
    kind, _, n_aids, kw = TRAIN_CASES[case]
    js, ts = stores
    jcfg = (JMF if kind == "mf" else JCF)(n_aids=n_aids, **kw)
    tcfg = (MFConfig if kind == "mf" else CFConfig)(n_aids=n_aids, **kw)
    init = {k: np.asarray(v) for k, v in _jax_tables(kind, jcfg, js.n_sessions, n_aids).items()}
    runs = {}
    for pkg in ("jax", "torch"):
        log = {"draws": [], "batches": [], "live": None}
        monkeypatch.setattr(np.random, "default_rng",
                            lambda seed, _log=log: _Draws(seed, _log["draws"]))
        if pkg == "torch":
            monkeypatch.setattr(tmf, "init_tables", lambda shapes, seed: {
                k: torch.tensor(init[k]) for k in shapes})
            monkeypatch.setattr(tmf, "BatchLoader",
                                _recording_loader(tloader.BatchLoader, log["batches"]))
            real_step = tmf.sparse_step

            def step(tables, *a, _log=log):
                _log["live"] = tables  # the tables the steps update in place
                return real_step(tables, *a)

            monkeypatch.setattr(tmf, "sparse_step", step)
            train = tmf.train_mf if kind == "mf" else tmf.train_cf
            model = train(ts, n_aids, tcfg, device="cpu")
        else:
            monkeypatch.setattr(jmf, "BatchLoader",
                                _recording_loader(jloader.BatchLoader, log["batches"]))
            train = jmf.train_mf if kind == "mf" else jmf.train_cf
            model = train(js, n_aids, jcfg)
        monkeypatch.undo()
        runs[pkg] = log, model
    return runs


def _close(got, want, rtol=1e-4, floor=1e-2):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    worst = float((np.abs(got - want) / (np.abs(want) + floor)).max())
    assert worst <= rtol, worst


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_training_protocol_equal_to_jax(block_stores, synth_stores, monkeypatch, case):
    stores = synth_stores if TRAIN_CASES[case][1] == "synth" else block_stores
    (jlog, jm), (tlog, tm) = _run_both(case, stores, monkeypatch).values()
    # the draws and the batches, bit for bit
    assert [k for k, _ in tlog["draws"]] == [k for k, _ in jlog["draws"]]
    for (_, a), (_, b) in zip(tlog["draws"], jlog["draws"]):
        np.testing.assert_array_equal(a, b)
    assert len(tlog["batches"]) == len(jlog["batches"]) > 0
    for tb, jb in zip(tlog["batches"], jlog["batches"]):
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)
    # the history: the same epochs (so the same stopping epoch), losses close
    assert [h["epoch"] for h in tm.history] == [h["epoch"] for h in jm.history]
    for th, jh in zip(tm.history, jm.history):
        for key in ("train_loss", "val_loss"):
            assert th[key] == pytest.approx(jh[key], rel=1e-5), (th, jh)
    val = [h["val_loss"] for h in jm.history]
    best = int(np.argmin(val))
    if case == "mf_wrap":
        kw = TRAIN_CASES[case][3]
        assert kw["batch_size"] > len(tlog["draws"][1][1])  # the epoch's permutation
        assert len(tlog["batches"]) == len(tm.history)  # one wrapped batch an epoch
    else:
        assert best < len(val) - 1 and val[-1] > val[best]  # stopped after a rise
    # the returned tables are the best epoch's, equal to JAX's
    names = (["session_embeddings", "aid_embeddings"] if TRAIN_CASES[case][0] == "mf"
             else ["embeddings"])
    for name in names:
        _close(getattr(tm, name), getattr(jm, name))
    if case != "mf_wrap":
        # the tables the steps went on updating after the best epoch are the
        # last epoch's: without the copy they would have been returned
        live = tlog["live"][names[-1]].numpy()
        assert not np.allclose(live, getattr(jm, names[-1]), rtol=1e-3, atol=1e-4)


def test_sparse_step_shared_table_batch_complete():
    """CF's two lookups into one table: both gradients from the rows before
    the step, both squares in the accumulator before either update, and a
    duplicated row gets every one of its updates (a numpy model of the
    reference's step, :215-238)."""
    rng = _DEFAULT_RNG(3)
    V, D, B = 6, 4, 40
    e0 = rng.normal(size=(V, D)).astype(np.float32)
    acc0 = rng.uniform(0, 1, (V, D)).astype(np.float32)
    i1, i2 = rng.integers(0, V, B), rng.integers(0, V, B)
    y = (rng.random(B) < 0.5).astype(np.float32)
    tables, accs = {"embeddings": torch.tensor(e0)}, {"embeddings": torch.tensor(acc0)}
    loss = tmf.sparse_step(tables, accs, (("embeddings", 0), ("embeddings", 1)), "bce", 0.5,
                           torch.tensor(i1), torch.tensor(i2), torch.tensor(y))
    e = e0.astype(np.float64)
    logits = (e[i1] * e[i2]).sum(1)
    want_loss = np.mean(np.logaddexp(0, logits) - y * logits)
    dl = (1 / (1 + np.exp(-logits)) - y) / B
    g1, g2 = dl[:, None] * e[i2], dl[:, None] * e[i1]
    acc = acc0.astype(np.float64)
    np.add.at(acc, i1, g1 * g1)
    np.add.at(acc, i2, g2 * g2)
    np.add.at(e, i1, -0.5 * g1 / np.sqrt(acc[i1] + 1e-10))
    np.add.at(e, i2, -0.5 * g2 / np.sqrt(acc[i2] + 1e-10))
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    _close(accs["embeddings"].numpy(), acc, rtol=1e-5)
    _close(tables["embeddings"].numpy(), e, rtol=1e-5)


# ------------------------------------------------------------- npz files --
@pytest.mark.parametrize("kind", ["mf", "cf"])
def test_npz_loads_both_ways(kind, tmp_path):
    rng = _DEFAULT_RNG(9)
    s = rng.normal(size=(30, 8)).astype(np.float32)
    a = rng.normal(size=(50, 8)).astype(np.float32)
    if kind == "mf":
        jmf.MFModel(s, a, JMF()).save(tmp_path / "j.npz")
        tmf.MFModel(s, a, MFConfig()).save(tmp_path / "t.npz")
        for loaded in (tmf.MFModel.load(tmp_path / "j.npz"), jmf.MFModel.load(tmp_path / "t.npz")):
            np.testing.assert_array_equal(loaded.session_embeddings, s)
            np.testing.assert_array_equal(loaded.aid_embeddings, a)
    else:
        jmf.CFModel(a, JCF()).save(tmp_path / "j.npz")
        tmf.CFModel(a, CFConfig()).save(tmp_path / "t.npz")
        for loaded in (tmf.CFModel.load(tmp_path / "j.npz"), jmf.CFModel.load(tmp_path / "t.npz")):
            np.testing.assert_array_equal(loaded.embeddings, a)
        x1, x2 = rng.integers(0, 50, 20), rng.integers(0, 50, 20)
        np.testing.assert_array_equal(tmf.CFModel(a, CFConfig()).score_pairs(x1, x2),
                                      jmf.CFModel(a, JCF()).score_pairs(x1, x2))


def test_trainers_need_a_card_when_asked_for_one(synth_stores):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda file drives the trainers there")
    _, ts = synth_stores
    with pytest.raises(RuntimeError, match="cuda"):
        tmf.train_mf(ts, 100, MFConfig(n_factors=8, epochs=1), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tmf.train_cf(ts, 100, CFConfig(n_factors=8, epochs=1), device="cuda")


# ------------------------------------------------------------ metrics --
METRIC_CASES = {
    "ties": lambda r: ((r.random(500) < 0.4).astype(np.int8),
                       np.round(r.normal(size=500), 1)),
    "continuous": lambda r: ((r.random(300) < 0.6).astype(np.float32),
                             r.normal(size=300).astype(np.float32)),
    "one_class": lambda r: (np.ones(50, np.int8), r.normal(size=50)),
    "no_positive": lambda r: (np.zeros(50, np.int8), r.normal(size=50)),
    "known": lambda r: (np.array([0, 0, 1, 1]), np.array([0.1, 0.4, 0.35, 0.8])),
}


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_model_metrics_equal_to_jax(case):
    y, s = METRIC_CASES[case](_DEFAULT_RNG(11))
    want, got = jmm.roc_auc(y, s), tmm.roc_auc(y, s)
    assert (np.isnan(want) and np.isnan(got)) or got == want
    assert np.isnan(got) == (case in ("one_class", "no_positive"))
    jc, tc = jmm.classification_scores(y, s), tmm.classification_scores(y, s)
    assert tc.keys() == jc.keys() and tc["accuracy"] == jc["accuracy"]
    jr, tr = jmm.regression_scores(y, s), tmm.regression_scores(y, s)
    assert tr == jr
    if case == "known":
        assert got == pytest.approx(0.75)
