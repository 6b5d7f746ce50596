"""The port's GBDT training against ``otto_tpu``'s, on the CPU: the
histogram twin of K5, ``_grow_tree``, the objectives, ``fit_gbdt`` and
``train_gbdt_ranker``.  Inputs are made with numpy from a seed and handed to
both packages; sizes stay small (<= 2,000 rows, 8 features, 16 bins, depth
<= 4, <= 20 trees).

Tolerances, and why:

- histograms: bit-equal to ``_mm_hist`` and to the scatter branch on dyadic
  vals (k/256, |k| < 256: every sum is exact in float32, and exact in the
  bf16 hi/lo pair); on normal vals within 1e-5 of each cell's sum of |vals|
  against the scatter branch (the twin sums in float64 and rounds once, XLA
  in float32), and within the reference's own 1e-3 relative of ``_mm_hist``
  (tests/test_gbdt.py: its bf16 pair keeps 16 significant bits);
- ``_grow_tree`` on dyadic grad/hess: ``feat``, ``thr`` and the leaf ids
  bit-equal to both of the reference's branches; gains and leaves within
  1e-6 relative (the same float32 operations, which XLA may fuse otherwise);
  the empty leaf of a node that does not split is -0.0 in both;
- objectives within 1e-5 (``jax.nn.sigmoid`` and ``torch.sigmoid`` may
  differ in the last ulp; the ranks come from the same stable sort);
- ``fit_gbdt`` with subsample 1.0: the feature masks equal, the first tree's
  splits equal and its leaves within 1e-5, held-out MAP@20 within 0.005;
  with subsample 0.9 the bags differ by design (``jax.random`` against a
  ``torch.Generator``), so the fits are judged statistically: held-out
  MAP@20 no more than 0.03 below the reference's (40 sessions: a better
  fit is no fault), and both well above a random ranking;
- ``train_gbdt_ranker``: edges, fold sessions and keep masks equal; the
  port's model, saved and loaded by ``otto_tpu``, scores as the port's
  ``predict`` does, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from otto_tpu.config import GBDTConfig as JGBDTConfig
from otto_tpu.eval.metrics import map_at_k as j_map_at_k
from otto_tpu.models import gbdt as jg
from otto_tpu_torch.config import GBDTConfig
from otto_tpu_torch.models import gbdt as tg
from otto_tpu_torch.models.ranker import RankerData
from otto_tpu_torch.ops import hist

torch.set_num_threads(1)

N, F, NB = 1920, 8, 16


def _dyadic(rng, shape, low=-255):
    return (rng.integers(low, 256, shape) / 256).astype(np.float32)


def _scatter_hist(binned, key, vals, n_keys, n_bins):
    """The reference's scatter branch (``_grow_tree_impl``, :236-239), with
    the right-going rows' vals zeroed as its caller does (:224-226)."""
    n_rows, n_feat = binned.shape
    k = np.where(key >= 0, key, 0)
    v = vals * (key >= 0)[:, None]
    col_off = (jnp.arange(n_feat, dtype=jnp.int32) * n_bins)[None, :]
    idx = jnp.asarray(k)[:, None] * (n_feat * n_bins) + col_off + jnp.asarray(binned).astype(
        jnp.int32)
    v3 = jnp.broadcast_to(jnp.asarray(v)[:, None, :], (*idx.shape, 3))
    out = jnp.zeros((n_keys * n_feat * n_bins, 3), jnp.float32).at[idx].add(v3)
    return np.asarray(out).reshape(n_keys, n_feat, n_bins, 3)


@pytest.mark.parametrize("vals_kind", ["dyadic", "normal"])
@pytest.mark.parametrize("n_keys", [1, 4])
def test_histogram_twin_equal_to_jax(vals_kind, n_keys):
    rng = np.random.default_rng(n_keys)
    binned = rng.integers(0, NB, (N, F)).astype(np.uint8)
    binned[:, 1] = np.minimum(binned[:, 1], 2)  # a feature with few, crowded bins
    key = rng.integers(-1 if n_keys > 1 else 0, n_keys, N).astype(np.int32)
    vals = _dyadic(rng, (N, 3)) if vals_kind == "dyadic" else \
        rng.normal(size=(N, 3)).astype(np.float32)
    got = hist.build_histogram(torch.as_tensor(binned), torch.as_tensor(key),
                               torch.as_tensor(vals), n_keys, NB).numpy()
    mm = np.asarray(jg._mm_hist(jnp.asarray(binned), jnp.asarray(key), jnp.asarray(vals),
                                n_keys, NB, 512))
    sc = _scatter_hist(binned, key, vals, n_keys, NB)
    assert got.dtype == np.float32 and got.shape == (n_keys, F, NB, 3)
    if vals_kind == "dyadic":
        np.testing.assert_array_equal(got, mm)
        np.testing.assert_array_equal(got, sc)
    else:
        abs_sum = hist.build_histogram(torch.as_tensor(binned), torch.as_tensor(key),
                                       torch.as_tensor(np.abs(vals)), n_keys, NB).numpy()
        assert np.all(np.abs(got - sc) <= 1e-5 * abs_sum + 1e-30)
        np.testing.assert_allclose(got, mm, rtol=1e-3, atol=1e-3 * float(abs_sum.max()))


def test_histogram_skips_rows_and_bins_outside_the_grid():
    """Keys outside [0, n_keys) and bins of n_bins or more add nothing."""
    binned = torch.tensor([[0, 3], [1, 4], [2, 0]], dtype=torch.uint8)
    key = torch.tensor([0, -1, 2], dtype=torch.int32)
    vals = torch.ones((3, 3))
    out = hist.build_histogram(binned, key, vals, 2, 4)
    want = torch.zeros((2, 2, 4, 3))
    want[0, 0, 0] = 1.0
    want[0, 1, 3] = 1.0
    assert torch.equal(out, want)
    with pytest.raises(TypeError):
        hist.build_histogram(binned, key.long(), vals, 2, 4)
    with pytest.raises(ValueError):
        hist.build_histogram(binned, key, vals, 2, 257)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """On CPU tensors the wrappers run the twin: the launcher is never
    called and the kernel's launch count (kept by ``node_histograms``, the
    wrapper that launches it) stays."""
    from otto_tpu_torch.ops import _kernels

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the histogram kernel")

    monkeypatch.setattr(_kernels, "launch_build_histogram", refuse)
    before = hist.node_histograms.launches
    rng = np.random.default_rng(0)
    binned = torch.as_tensor(rng.integers(0, NB, (N, F)).astype(np.uint8))
    out = hist.build_histogram(binned, torch.zeros(N, dtype=torch.int32),
                               torch.ones((N, 3)), 1, NB)
    assert out.device.type == "cpu" and float(out[..., 2].sum()) == N * F
    tg._grow_tree(binned, *(torch.ones(N) for _ in range(4)), torch.ones(F, dtype=torch.bool),
                  0.01, 1e-5, 20.0, 1e-3, 0.1, depth=3, n_bins=NB)
    assert hist.node_histograms.launches == before


GROW_CASES = {
    "plain": dict(min_data_in_leaf=20.0, min_child_weight=1e-3, mask_off=()),
    "min_child_weight": dict(min_data_in_leaf=5.0, min_child_weight=40.0, mask_off=()),
    "feature_mask": dict(min_data_in_leaf=20.0, min_child_weight=1e-3, mask_off=(0, 3, 6)),
    "all_invalid_node": dict(min_data_in_leaf=600.0, min_child_weight=1e-3, mask_off=()),
}


@pytest.mark.parametrize("hist_impl", ["matmul", "scatter"])
@pytest.mark.parametrize("case", sorted(GROW_CASES))
def test_grow_tree_equal_to_jax_on_dyadic_inputs(hist_impl, case):
    c = GROW_CASES[case]
    rng = np.random.default_rng(11)
    binned = rng.integers(0, NB, (N, F)).astype(np.uint8)
    binned[:, 2] = (binned[:, 0] + rng.integers(0, 2, N)) % NB  # near-duplicate features
    grad = _dyadic(rng, N)
    hess = _dyadic(rng, N, low=1)
    weight = (rng.random(N) < 0.9).astype(np.float32)
    bag = (rng.random(N) < 0.8).astype(np.float32)
    fm = np.ones(F, bool)
    fm[list(c["mask_off"])] = False
    scalars = (0.01, 1e-5, c["min_data_in_leaf"], c["min_child_weight"], 0.1)
    depth = 4
    want = jg._grow_tree(*(jnp.asarray(a) for a in (binned, grad, hess, weight, bag, fm)),
                         *(jnp.float32(s) for s in scalars), depth=depth, n_bins=NB,
                         hist_chunk=512, hist_impl=hist_impl)
    got = tg._grow_tree(*(torch.as_tensor(a) for a in (binned, grad, hess, weight, bag, fm)),
                        *scalars, depth=depth, n_bins=NB, hist_impl=hist_impl)
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    for name, g, w in zip(("feat", "thr", "leaf", "gain", "leaf id"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
    for i in (0, 1, 4):  # feat, thr and the rows' leaf ids
        np.testing.assert_array_equal(got[i], want[i])
    for i in (2, 3):  # leaves, gains
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(np.signbit(got[2]), np.signbit(want[2]))
    if case == "all_invalid_node":
        assert (got[1] == NB).any() and (got[1] < NB).any()
        empty = np.setdiff1d(np.arange(1 << depth), got[4])
        assert len(empty) and np.all(got[2][empty] == 0) and np.all(np.signbit(got[2][empty]))


def _scores_with_ties(rng, S, C):
    s = np.round(rng.normal(size=(S, C)), 1).astype(np.float32)  # many ties
    s[:, :4] = 0.5  # a run of equal scores at the front
    return s


@pytest.mark.parametrize("norm", [True, False])
def test_lambdarank_gh_equal_to_jax(norm):
    rng = np.random.default_rng(3)
    S, C = 70, 30  # C > k, and S not a multiple of the chunk
    scores = _scores_with_ties(rng, S, C)
    labels = (rng.random((S, C)) < 0.15).astype(np.int8)
    labels[:5] = 0  # sessions without a positive
    mask = rng.random((S, C)) < 0.85
    mask[:, 0] = True
    want = jg._lambdarank_gh(jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(mask),
                             k=20, chunk=32, norm=norm)
    got = tg._lambdarank_gh(torch.as_tensor(scores), torch.as_tensor(labels),
                            torch.as_tensor(mask), k=20, chunk=32, norm=norm)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_bce_gh_equal_to_jax():
    rng = np.random.default_rng(4)
    scores = (rng.normal(size=(50, 30)) * 4).astype(np.float32)
    labels = (rng.random((50, 30)) < 0.2).astype(np.int8)
    mask = rng.random((50, 30)) < 0.8
    want = jg._bce_gh(jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(mask))
    got = tg._bce_gh(torch.as_tensor(scores), torch.as_tensor(labels), torch.as_tensor(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- fits
S, C = 120, 16  # 1,920 rows
S_TRAIN = 80


@pytest.fixture(scope="module")
def task():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(S, C, F)).astype(np.float32)
    s = 1.6 * X[..., 0] + X[..., 1] * X[..., 2] + 1.4 * (X[..., 3] > 0.4) - np.abs(X[..., 4])
    s = s + 0.35 * rng.normal(size=(S, C))
    X[rng.random(X.shape) < 0.05] = np.nan  # the missing bin
    labels = (s >= np.sort(s, axis=1)[:, -3][:, None]).astype(np.int8)
    mask = np.ones((S, C), bool)
    mask[:, -4:] = rng.random((S, 4)) < 0.5  # padded columns
    edges = jg.fit_bin_edges(X[mask], NB)
    return X, jg.bin_features(X, edges), labels, mask


def _cfg(**kw):
    kw = dict(n_trees=20, max_depth=4, n_bins=NB, min_data_in_leaf=10, learning_rate=0.1,
              eval_every=5, early_stopping_rounds=10, **kw)
    return JGBDTConfig(**kw), GBDTConfig(**kw)


def _held_out_map(forest_scores, labels, mask):
    return float(j_map_at_k(jnp.asarray(np.where(mask, forest_scores, -np.inf)),
                            jnp.asarray(labels), jnp.asarray(mask), k=20))


def _fit_both(task, monkeypatch, **kw):
    """Both packages' ``fit_gbdt`` on the first S_TRAIN sessions, early-stopped
    on the rest; returns the forests, their held-out MAP@20 and each
    package's feature masks, tree by tree."""
    _, binned, labels, mask = task
    jcfg, tcfg = _cfg(**kw)
    masks = {"jax": [], "torch": []}
    j_grow, t_grow = jg._grow_tree, tg._grow_tree

    def j_rec(*a, **k):
        masks["jax"].append(np.asarray(a[5]))
        return j_grow(*a, **k)

    def t_rec(*a, **k):
        masks["torch"].append(a[5].numpy())
        return t_grow(*a, **k)

    monkeypatch.setattr(jg, "_grow_tree", j_rec)
    monkeypatch.setattr(tg, "_grow_tree", t_rec)
    tr, va = slice(0, S_TRAIN), slice(S_TRAIN, S)
    w = mask[tr].astype(np.float32)
    val = (binned[va], labels[va], mask[va])
    jf = jg.fit_gbdt(binned[tr], labels[tr], mask[tr], w, jcfg, val=val)
    tf = tg.fit_gbdt(binned[tr], labels[tr], mask[tr], w, tcfg, val=val, device="cpu")
    vb = binned[va].reshape(-1, F)
    maps = [_held_out_map(f.predict_binned(vb, **dev).reshape(-1, C), labels[va], mask[va])
            for f, dev in ((jf, {}), (tf, {"device": "cpu"}))]
    return jf, tf, maps, masks


@pytest.mark.parametrize("loss", ["bce", "lambdarank"])
@pytest.mark.parametrize("colsample", [1.0, 0.8])
def test_fit_gbdt_equal_to_jax_without_bagging(task, monkeypatch, loss, colsample):
    jf, tf, (j_map, t_map), masks = _fit_both(task, monkeypatch, loss=loss, subsample=1.0,
                                               colsample=colsample)
    assert len(masks["torch"]) == len(masks["jax"]) > 0
    for a, b in zip(masks["torch"], masks["jax"]):
        np.testing.assert_array_equal(a, b)
    assert tf.base == jf.base and tf.depth == jf.depth
    np.testing.assert_array_equal(tf.feat[0], jf.feat[0])
    np.testing.assert_array_equal(tf.thr[0], jf.thr[0])
    np.testing.assert_allclose(tf.leaf[0], jf.leaf[0], rtol=1e-5, atol=1e-7)
    assert abs(t_map - j_map) <= 0.005, (t_map, j_map)


@pytest.mark.parametrize("loss", ["bce", "lambdarank"])
def test_fit_gbdt_with_bagging_judged_statistically(task, monkeypatch, loss):
    _, _, labels, mask = task
    _, tf, (j_map, t_map), _ = _fit_both(task, monkeypatch, loss=loss, subsample=0.9,
                                         colsample=0.9)
    rng = np.random.default_rng(0)
    va = slice(S_TRAIN, S)
    random_map = _held_out_map(rng.random((S - S_TRAIN, C)), labels[va], mask[va])
    assert t_map >= j_map - 0.03, (t_map, j_map)  # no worse than the reference
    assert min(t_map, j_map) > random_map + 0.2, (t_map, j_map, random_map)
    assert 1 <= tf.best_iteration <= 20


def test_fit_gbdt_reproducible_and_segmented_cadence(task):
    """Two fits give the same forest; ``trees_per_call`` measures the metric
    once a segment (the reference's cadence), and a ``mesh`` that is not a
    ``DeviceMesh`` raises (data-parallel fits: tests/test_torch_data_parallel.py)."""
    _, binned, labels, mask = task
    _, cfg = _cfg(loss="bce", subsample=0.9, colsample=0.9)
    tr, va = slice(0, S_TRAIN), slice(S_TRAIN, S)
    args = (binned[tr], labels[tr], mask[tr], mask[tr].astype(np.float32))
    val = (binned[va], labels[va], mask[va])
    a = tg.fit_gbdt(*args, cfg, val=val, device="cpu")
    b = tg.fit_gbdt(*args, cfg, val=val, device="cpu")
    for f in ("feat", "thr", "leaf", "gain_importance", "split_importance"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    seg = tg.fit_gbdt(*args, GBDTConfig(**{**vars(cfg), "trees_per_call": 6}), val=val,
                      device="cpu")
    assert seg.best_iteration in (6, 12, 18, 20)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tg.fit_gbdt(*args, cfg, mesh=object(), device="cpu")


def test_train_gbdt_ranker_equal_to_jax(task, monkeypatch, tmp_path):
    X, _, labels, mask = task
    jcfg, tcfg = _cfg(loss="bce", n_folds=3, subsample=1.0, colsample=1.0)
    calls = {"jax": [], "torch": []}
    j_fit, t_fit = jg.fit_gbdt, tg.fit_gbdt

    def j_rec(*a, **k):
        calls["jax"].append((a[0], a[3], k["val"][0]))
        return j_fit(*a, **k)

    def t_rec(*a, **k):
        calls["torch"].append((a[0], a[3], k["val"][0]))
        return t_fit(*a, **k)

    monkeypatch.setattr(jg, "fit_gbdt", j_rec)
    monkeypatch.setattr(tg, "fit_gbdt", t_rec)
    names = [f"f{i}" for i in range(F)]
    jdata = jg.RankerData(X, labels, mask, np.arange(S), np.zeros((S, C), np.int32), names)
    tdata = RankerData(X, labels, mask, np.arange(S), np.zeros((S, C), np.int32), names)
    recall = lambda idx, s: float(np.mean(np.argmax(s, axis=1) == 0))  # noqa: E731
    jm, j_oof = jg.train_gbdt_ranker(jdata, jcfg, eval_recall=recall)
    tm, t_oof = tg.train_gbdt_ranker(tdata, tcfg, eval_recall=recall, device="cpu")
    np.testing.assert_array_equal(tm.edges, jm.edges)
    assert len(calls["torch"]) == len(calls["jax"]) == 3
    for (tb, tw, tv), (jb, jw, jv) in zip(calls["torch"], calls["jax"]):
        np.testing.assert_array_equal(tb, jb)  # the fold's training sessions
        np.testing.assert_array_equal(tw, jw)  # its keep mask
        np.testing.assert_array_equal(tv, jv)  # its held-out sessions
    assert np.array_equal(np.isinf(t_oof), np.isinf(j_oof)) and np.all(np.isinf(t_oof[~mask]))
    assert len(tm.fold_recalls) == 3 and np.isfinite(tm.oof_recall)
    tm.prior_alpha = 0.25
    tm.save(tmp_path / "ranker.npz")
    loaded = jg.load_ranker_model(tmp_path / "ranker.npz")
    assert loaded.prior_alpha == 0.25 and loaded.feature_names == names
    want = tm.predict(X, mask, device="cpu")
    np.testing.assert_array_equal(loaded.predict(X, mask), want)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tg.train_gbdt_ranker(tdata, tcfg, mesh=object(), device="cpu")
