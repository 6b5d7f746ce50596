"""The port's listwise tower (``otto_tpu_torch/models/ranker.py``) against
``otto_tpu``'s, on the CPU, on inputs made from a seed with numpy.

Tolerances:

- the three losses: values within 1e-6 relative, gradients within 1e-6 of
  their largest magnitude (XLA and torch sum the [B, C, C] pairs and the
  log-sum-exp in other orders and differentiate ``logaddexp`` by other
  formulas; measured here 3.1e-7 and 1.6e-7);
- the forward: bit-equal on dyadic inputs (every product and sum exact, the
  bfloat16 roundings then identical); on normal inputs 99% of scores within
  1e-5 * (|s| + 1e-3) and every score within 4e-3 * max |s| (where the two
  float32 sums of a hidden unit differ in their last bit, its bfloat16
  rounding can differ by an ulp of bfloat16; measured 0.48% and 1.6e-3);
- ``FeatureNormalizer`` (numpy, copied) bit-equal; its torch form within
  2^-20 of it (``log1p`` an ulp apart);
- the learning-rate schedule within 1e-6 relative of optax's float32;
- one AdamW step, dropout off, from the same parameters: in float32 compute
  the loss within 1e-6 relative, >= 99.9% of the parameters within 1e-6 and
  every one within 2 * lr (Adam's first step moves a tiny gradient by about
  +-lr, so its sign decides); in bfloat16 compute the loss within 1e-5;
- ``train_ranker`` with JAX's initial parameters injected and dropout 0:
  the folds, the keep masks and the batch order equal, each fold's MAP@20
  within 0.01 (bfloat16 steps drift apart);
- the npz files load in both directions with every array bit-equal.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from otto_tpu.config import RankerConfig as JRankerConfig
from otto_tpu.eval import metrics as jmet
from otto_tpu.models import ranker as jrk
from otto_tpu_torch.config import RankerConfig
from otto_tpu_torch.models import ranker as trk

torch.set_num_threads(1)

F = 55
LIMITS = dict(share=0.99, rel=1e-5, floor=1e-3, worst=4e-3)


def _loss_inputs(seed=0, B=32, C=40):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.normal(size=(B, C)), 1).astype(np.float32)  # ties
    labels = (rng.random((B, C)) < 0.15).astype(np.int8)
    labels[:4] = 0  # sessions without a positive
    mask = rng.random((B, C)) < 0.85  # masked slots
    mask[5] = False  # a session with no slot
    return scores, labels, mask


@pytest.mark.parametrize("name", ["lambdarank", "listwise_softmax", "bce"])
def test_losses_and_gradients_equal_to_jax(name):
    scores, labels, mask = _loss_inputs()
    jv, jg = jax.value_and_grad(lambda s: jrk.LOSSES[name](s, jnp.asarray(labels),
                                                          jnp.asarray(mask)))(
        jnp.asarray(scores))
    s = torch.tensor(scores, requires_grad=True)
    tv = trk.LOSSES[name](s, torch.from_numpy(labels), torch.from_numpy(mask))
    tv.backward()
    jg = np.asarray(jg)
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-6)
    assert np.abs(s.grad.numpy() - jg).max() <= 1e-6 * np.abs(jg).max()
    assert ((s.grad.numpy() == 0) == (jg == 0)).all()  # masked slots get no gradient


def test_lambdarank_ranks_ties_to_the_lower_column():
    """All-tied scores: ranks follow the columns (a stable sort), so only
    the first 20 columns carry a discount."""
    labels = np.zeros((1, 30), np.int8)
    labels[0, [3, 25]] = 1
    mask = np.ones((1, 30), bool)
    scores = np.zeros((1, 30), np.float32)
    want = float(jrk.lambdarank_loss(jnp.asarray(scores), jnp.asarray(labels),
                                     jnp.asarray(mask)))
    got = float(trk.lambdarank_loss(torch.from_numpy(scores), torch.from_numpy(labels),
                                    torch.from_numpy(mask)))
    assert got == pytest.approx(want, rel=1e-6) and got > 0


def _dyadic_params(rng, dims):
    return {k: v for i in range(len(dims) - 1) for k, v in (
        (f"w{i}", (rng.integers(-1, 2, (dims[i], dims[i + 1])) / 2).astype(np.float32)),
        (f"b{i}", (rng.integers(-2, 3, dims[i + 1]) / 2).astype(np.float32)))}


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_forward_bit_equal_on_dyadic_inputs(compute):
    rng = np.random.default_rng(1)
    params = _dyadic_params(rng, [F, 16, 8, 1])
    x = (rng.integers(-3, 4, (64, 20, F)) / 4).astype(np.float32)
    want = np.asarray(jrk.tower_forward({k: jnp.asarray(v) for k, v in params.items()},
                                        jnp.asarray(x), compute_dtype=getattr(jnp, compute)))
    tower = trk.tower_params_from_numpy(params, device="cpu")
    with torch.no_grad():
        got = tower(torch.from_numpy(x), compute_dtype=getattr(torch, compute)).numpy()
    assert got.dtype == np.float32 and got.shape == (64, 20)
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 1


def _within_limits(got, want):
    d = np.abs(got - want)
    assert (d <= LIMITS["rel"] * (np.abs(want) + LIMITS["floor"])).mean() >= LIMITS["share"]
    assert d.max() <= LIMITS["worst"] * np.abs(want).max()


def test_forward_within_limits_on_normal_inputs():
    """Full width, (256, 256, 128) over F = 55, with JAX's initial weights
    and nonzero biases."""
    rng = np.random.default_rng(2)
    params = {k: np.asarray(v) for k, v in
              jrk.init_tower(jax.random.PRNGKey(0), F, (256, 256, 128)).items()}
    for k in params:
        if k.startswith("b"):
            params[k] = (rng.normal(size=params[k].shape) * 0.1).astype(np.float32)
    x = (rng.normal(size=(256, 128, F)) * 3).astype(np.float32)
    want = np.asarray(jax.jit(jrk.tower_forward)({k: jnp.asarray(v) for k, v in params.items()},
                                                  jnp.asarray(x)))
    with torch.no_grad():
        got = trk.tower_params_from_numpy(params, device="cpu")(torch.from_numpy(x)).numpy()
    _within_limits(got, want)
    back = trk.tower_params_to_numpy(trk.tower_params_from_numpy(params, device="cpu"))
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)


def test_init_tower_layout_and_scale():
    p = trk.init_tower(F, (256, 128), torch.Generator().manual_seed(3))
    want = jrk.init_tower(jax.random.PRNGKey(3), F, (256, 128))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in p.values())
    assert all(not v.any() for k, v in p.items() if k.startswith("b"))
    assert float(p["w0"].std()) == pytest.approx(np.sqrt(2 / F), rel=0.05)
    again = trk.init_tower(F, (256, 128), torch.Generator().manual_seed(3))
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_normalizer_bit_equal():
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(100, 30, F)).astype(np.float32)
    feats[..., :5] *= 1000  # heavy-tailed: log-compressed columns
    feats[0, 0, 3], feats[1, 1, 7], feats[2, 2, 8] = np.nan, np.inf, -np.inf
    mask = rng.random((100, 30)) < 0.8
    jn, tn = jrk.FeatureNormalizer.fit(feats, mask), trk.FeatureNormalizer.fit(feats, mask)
    for a in ("mean", "std", "log_cols"):
        np.testing.assert_array_equal(getattr(tn, a), getattr(jn, a))
    assert np.flatnonzero(tn.log_cols).tolist() == [0, 1, 2, 3, 4, 7, 8]  # +-inf: log
    want = jn(feats)
    np.testing.assert_array_equal(tn(feats), want)
    got = tn.apply(torch.from_numpy(feats)).numpy()
    assert np.isfinite(got).all() and np.abs(got - want).max() <= 2.0**-20 * np.abs(want).max()


@pytest.mark.parametrize("t", [0, 1, 5_000, 10_000, 20_000])
def test_schedule_equal_to_optax(t):
    cfg = RankerConfig(learning_rate=3e-3)
    want = float(optax.cosine_decay_schedule(cfg.learning_rate, 10_000, 0.1)(t))
    assert trk.learning_rate(cfg, t) == pytest.approx(want, rel=1e-6)


def _jax_step(params, x, y, m, compute, loss="lambdarank", lr=1e-3, wd=1e-5):
    opt = optax.adamw(optax.cosine_decay_schedule(lr, 10_000, 0.1), weight_decay=wd)

    @jax.jit
    def step(params):
        def f(p):
            return jrk.LOSSES[loss](jrk.tower_forward(p, x, compute_dtype=compute), y, m)

        value, grads = jax.value_and_grad(f)(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates), value

    new, value = step(params)
    return {k: np.asarray(v) for k, v in new.items()}, float(value)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_one_step_equal_to_jax(compute):
    """One lambdarank step at [64 x 128 x 55], (256, 256, 128), dropout
    off, from JAX's initial parameters."""
    rng = np.random.default_rng(5)
    jp = jrk.init_tower(jax.random.PRNGKey(5), F, (256, 256, 128))
    x = rng.normal(size=(64, 128, F)).astype(np.float32)
    y = (rng.random((64, 128)) < 0.1).astype(np.int8)
    m = rng.random((64, 128)) < 0.9
    want, want_loss = _jax_step(jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                                getattr(jnp, compute))
    cfg = RankerConfig()
    tower = trk.tower_params_from_numpy(jp, device="cpu")
    loss = trk.train_step(tower, trk.make_optimizer(tower, cfg), torch.from_numpy(x),
                          torch.from_numpy(y), torch.from_numpy(m), trk.learning_rate(cfg, 0),
                          loss="lambdarank", compute_dtype=getattr(torch, compute))
    got = trk.tower_params_to_numpy(tower)
    if compute == "bfloat16":
        assert float(loss) == pytest.approx(want_loss, rel=1e-5)
        return
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert (d <= 1e-6).mean() >= 0.999
    assert d.max() <= 2 * cfg.learning_rate


def _separable(S=240, C=16, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(S, C, F)).astype(np.float32)
    logits = 2.0 * feats[:, :, 0]
    labels = (rng.random((S, C)) < 1 / (1 + np.exp(-logits + 2.0))).astype(np.int8)
    mask = rng.random((S, C)) < 0.9
    cands = rng.integers(0, 1000, (S, C)).astype(np.int32)
    return labels, mask, feats, cands


_DEFAULT_RNG = np.random.default_rng


class _Draws:
    """A numpy Generator that records what train_ranker draws."""

    def __init__(self, seed, log):
        self._rng, self._log = _DEFAULT_RNG(seed), log

    def random(self, *a, **kw):
        out = self._rng.random(*a, **kw)
        self._log.append(("random", out.copy()))
        return out

    def permutation(self, n):
        out = self._rng.permutation(n)
        self._log.append(("permutation", out.copy()))
        return out


def test_train_ranker_protocol_equal_to_jax(monkeypatch):
    """Small widths (16, 8), 3 folds, 2 epochs, dropout 0, JAX's initial
    parameters injected into the port; 240 sessions, so an epoch is one
    batch of 128 and the batches are padded with their own head."""
    labels, mask, feats, cands = _separable()
    kw = dict(hidden_dims=(16, 8), n_folds=3, epochs=2, batch_sessions=128, dropout=0.0,
              learning_rate=1e-2)
    runs = {}
    for pkg, cfg_cls, rk in (("jax", JRankerConfig, jrk), ("torch", RankerConfig, trk)):
        log = {"folds": [], "keep": [], "draws": [], "batches": []}

        def kfold(sizes, n, _real=rk.group_kfold, _log=log):
            _log["folds"].append(_real(sizes, n))
            return _log["folds"][-1]

        def sample(*a, _real=rk.negative_sample_mask, _log=log):
            _log["keep"].append(_real(*a))
            return _log["keep"][-1]

        monkeypatch.setattr(rk, "group_kfold", kfold)
        monkeypatch.setattr(rk, "negative_sample_mask", sample)
        monkeypatch.setattr(rk.np.random, "default_rng",
                            lambda seed, _log=log: _Draws(seed, _log["draws"]))
        if pkg == "torch":
            real_step = trk.train_step

            def step(tower, opt, x, y, m, *a, _log=log, **k):
                _log["batches"].append((y.numpy().copy(), m.numpy().copy()))
                return real_step(tower, opt, x, y, m, *a, **k)

            def init(n_features, hidden, generator):
                key = jax.random.PRNGKey(generator.initial_seed())
                _, sub = jax.random.split(key)
                return {k: torch.from_numpy(np.array(v)) for k, v in
                        jrk.init_tower(sub, n_features, hidden).items()}

            monkeypatch.setattr(trk, "train_step", step)
            monkeypatch.setattr(trk, "init_tower", init)
        data = rk.RankerData(feats, labels, mask, np.arange(len(feats)), cands)
        args = {"device": "cpu"} if pkg == "torch" else {}
        model, oof = rk.train_ranker(data, cfg_cls(**kw), **args)
        monkeypatch.undo()
        runs[pkg] = log, model, oof
    (jlog, jm, joof), (tlog, tm, toof) = runs["jax"], runs["torch"]
    for key in ("folds", "keep"):
        assert len(tlog[key]) == len(jlog[key]) > 0
        for a, b in zip(tlog[key], jlog[key]):
            np.testing.assert_array_equal(a, b)
    assert [d[0] for d in tlog["draws"]] == [d[0] for d in jlog["draws"]]
    for (_, a), (_, b) in zip(tlog["draws"], jlog["draws"]):
        np.testing.assert_array_equal(a, b)
    # the batch order: each step's labels and keep mask as the reference
    # slices them from its draws
    fold_of, perms = jlog["folds"][0], [d for k, d in jlog["draws"] if k == "permutation"]
    want = []
    for fold in range(3):
        train = np.flatnonzero(fold_of != fold)
        keep = jlog["keep"][fold]
        usable = keep.sum(axis=1) > 0
        train, keep = train[usable], keep[usable]
        for order in perms[2 * fold:2 * fold + 2]:
            sel = order[:128]
            sel = np.concatenate([sel, sel[:128 - len(sel)]]) if len(sel) < 128 else sel
            want.append((labels[train[sel]], keep[sel]))
    assert len(tlog["batches"]) == len(want) == 6
    for (gy, gm), (wy, wm) in zip(tlog["batches"], want):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gm, wm)
    assert [len(e) for e in tm.epoch_losses] == [2, 2, 2]
    for fold in range(3):
        val = np.flatnonzero(fold_of == fold)
        maps = [float(jmet.map_at_k(jnp.asarray(np.where(mask[val], o[val], 0.0)),
                                    jnp.asarray(labels[val].astype(np.int32)),
                                    jnp.asarray(mask[val]), k=20)) for o in (toof, joof)]
        assert maps[0] == pytest.approx(maps[1], abs=0.01), fold
    assert np.array_equal(np.isinf(toof), ~mask) and np.array_equal(np.isinf(joof), ~mask)


def test_npz_loads_both_ways(tmp_path):
    """A JAX-trained tower saved by each package and loaded by the other:
    every array bit-equal, and the loaded models score alike (the forward's
    limits)."""
    labels, mask, feats, cands = _separable(S=120)
    cfg = JRankerConfig(hidden_dims=(16, 8), n_folds=2, epochs=1, batch_sessions=64,
                        dropout=0.0)
    jm, _ = jrk.train_ranker(jrk.RankerData(feats, labels, mask, np.arange(120), cands,
                                            [f"f{i}" for i in range(F)]), cfg)
    jm.prior_alpha, jm.fold_recalls, jm.oof_recall = 0.25, [0.5, 0.6], 0.55
    jm.save(tmp_path / "jax.npz")
    tm = trk.RankerModel.load(tmp_path / "jax.npz", RankerConfig(hidden_dims=(16, 8)))
    tm.save(tmp_path / "port.npz")
    back = jrk.RankerModel.load(tmp_path / "port.npz", cfg)
    for m in (tm, back):
        assert m.feature_names == jm.feature_names and m.prior_alpha == 0.25
        assert list(m.fold_recalls) == [0.5, 0.6] and m.oof_recall == 0.55
        for a in ("mean", "std", "log_cols"):
            np.testing.assert_array_equal(getattr(m.normalizer, a), getattr(jm.normalizer, a))
        assert len(m.params_per_fold) == 2
        for p, q in zip(m.params_per_fold, jm.params_per_fold):
            assert sorted(p) == sorted(q)
            for k in q:
                np.testing.assert_array_equal(np.asarray(p[k]), np.asarray(q[k]))
    with np.load(tmp_path / "port.npz", allow_pickle=True) as a, \
            np.load(tmp_path / "jax.npz", allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
    want = jm.predict(feats, mask)
    got = tm.predict(feats, mask, device="cpu")
    assert np.array_equal(np.isinf(got), ~mask)
    _within_limits(got[mask], want[mask])
    x = torch.from_numpy(feats.reshape(-1, F))
    np.testing.assert_array_equal(tm.predict_rows(x).numpy().reshape(mask.shape)[mask],
                                  got[mask])
    with pytest.raises(TypeError, match="DeviceMesh"):
        tm.predict(feats, mask, mesh=object(), device="cpu")
