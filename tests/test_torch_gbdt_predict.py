"""The port's GBDT inference (binning, routing, fold forests, npz layout)
and the ranker helpers against ``otto_tpu``, on the CPU.

The models are the committed ``artifacts/bench_e2e/ranker_{clicks,carts,
orders}.npz`` (three folds of depth 7, 50-120 trees a fold, 55 features,
256 bins).  Same seeded numpy inputs through both packages.

Tolerances: everything bit-equal.  Bins and leaf ids are integers.  A fold's
score is ``base`` plus the trees' leaves added one at a time in tree order
in float32 by both sides (``lax.scan`` in the JAX package, the twin's loop
here), and the folds are added in order and multiplied by float32(1/3) on
both, so the float32 results are identical; the tests compare bit patterns.
Nodes that do not split carry ``thr = 256`` (every bin goes left); rows of
bin 0 (all NaN) and bin 255 reach them.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from otto_tpu.models import gbdt as jg
from otto_tpu.models import ranker as jrk
from otto_tpu_torch.config import GBDTConfig
from otto_tpu_torch.models import gbdt as tg
from otto_tpu_torch.models import ranker as trk
from otto_tpu_torch.ops import forest as tf

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "artifacts" / "bench_e2e"
TYPES = ("clicks", "carts", "orders")


@pytest.fixture(scope="module")
def models():
    return {t: (jg.load_ranker_model(BENCH / f"ranker_{t}.npz"),
                tg.load_ranker_model(BENCH / f"ranker_{t}.npz")) for t in TYPES}


def _binned_rows(n, seed, n_feat=55):
    """Random bins with a block of all-NaN rows (bin 0) and one of bin 255."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, (n, n_feat)).astype(np.uint8)
    b[: n // 8] = 0
    b[n // 8: n // 4] = 255
    return b


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_bin_edges_and_bins_equal(models):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 6)).astype(np.float32)
    x[::5, 1] = np.nan
    x[:, 4] = np.round(x[:, 4])  # few distinct values: padded edges
    x[:, 5] = np.nan             # an all-NaN column
    for n_bins in (16, 256):
        je, te = jg.fit_bin_edges(x, n_bins), tg.fit_bin_edges(x, n_bins)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tg.bin_features(x, te), jg.bin_features(x, je))
    # the committed model's edges on feature-like values, NaN included
    jm, tm = models["clicks"]
    feats = rng.lognormal(size=(40, 23, 55)).astype(np.float32)
    feats[rng.random(feats.shape) < 0.2] = np.nan
    np.testing.assert_array_equal(tg.bin_features(feats, tm.edges),
                                  jg.bin_features(feats, jm.edges))
    np.testing.assert_array_equal(tm.bin(feats), jg.bin_features(feats, jm.edges).reshape(-1, 55))


@pytest.mark.parametrize("etype", TYPES)
def test_route_tree_leaf_ids_identical(models, etype):
    import jax.numpy as jnp

    jm, _ = models[etype]
    b = _binned_rows(500, 1)
    for fold in jm.forests:
        for t in (0, len(fold.feat) // 2, len(fold.feat) - 1):
            jr = np.asarray(jg._route_tree(jnp.asarray(b), jnp.asarray(fold.feat[t]),
                                           jnp.asarray(fold.thr[t]), depth=fold.depth))
            tr = tf._route_tree(torch.from_numpy(b), torch.from_numpy(fold.feat[t]),
                                torch.from_numpy(fold.thr[t]), fold.depth)
            assert tr.dtype == torch.int32
            np.testing.assert_array_equal(tr.numpy(), jr)


@pytest.mark.parametrize("etype", TYPES)
def test_forest_twin_bit_equal_per_fold(models, etype):
    import jax.numpy as jnp

    jm, _ = models[etype]
    b = _binned_rows(700, 2)
    for fold in jm.forests:
        jp = np.asarray(jg._predict_forest(jnp.asarray(b), jnp.asarray(fold.feat),
                                           jnp.asarray(fold.thr), jnp.asarray(fold.leaf),
                                           jnp.float32(fold.base), depth=fold.depth))
        tp = tf._predict_forest_reference(torch.from_numpy(b), torch.from_numpy(fold.feat),
                                          torch.from_numpy(fold.thr), torch.from_numpy(fold.leaf),
                                          np.float32(fold.base), fold.depth)
        np.testing.assert_array_equal(_bits(tp.numpy()), _bits(jp))


@pytest.mark.parametrize("etype", TYPES)
@pytest.mark.parametrize("n", [1, 115, 1500])
def test_predict_binned_folds_bit_equal(models, etype, n):
    jm, tm = models[etype]
    b = _binned_rows(n, 3 + n)
    want = jm.predict_binned_folds(b, batch=1024)  # n > batch: two padded batches
    got = tm.predict_binned_folds(b, device="cpu")
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # one fold through GBDTForest.predict_binned
    np.testing.assert_array_equal(_bits(tm.forests[1].predict_binned(b, device="cpu")),
                                  _bits(jm.forests[1].predict_binned(b)))


def test_predict_masks_and_matches_jax(models):
    jm, tm = models["orders"]
    rng = np.random.default_rng(4)
    X = rng.lognormal(size=(30, 17, 55)).astype(np.float32)
    X[rng.random(X.shape) < 0.3] = np.nan
    mask = rng.random((30, 17)) < 0.8
    want, got = jm.predict(X, mask), tm.predict(X, mask, device="cpu")
    assert np.isneginf(got[~mask]).all()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_threshold_256_sends_every_bin_left():
    """A hand-made depth-2 forest whose root does not split (thr 256, the
    committed models' value) and whose children split at bin 254: rows of
    bin 255 go right at the child, never at the root; thr is not cut to 8
    bits anywhere."""
    import jax.numpy as jnp

    feat = np.array([[0, 1, 2]], np.int32)
    thr = np.array([[256, 254, 254]], np.int32)
    leaf = np.array([[1.0, 2.0, 4.0, 8.0]], np.float32)
    b = np.array([[255, 255, 0], [0, 0, 255], [255, 0, 255], [7, 254, 255]], np.uint8)
    tp = tf._predict_forest_reference(torch.from_numpy(b), torch.from_numpy(feat),
                                      torch.from_numpy(thr), torch.from_numpy(leaf), 0.5, 2)
    jp = np.asarray(jg._predict_forest(jnp.asarray(b), jnp.asarray(feat), jnp.asarray(thr),
                                       jnp.asarray(leaf), jnp.float32(0.5), depth=2))
    np.testing.assert_array_equal(tp.numpy(), [2.5, 1.5, 1.5, 1.5])
    np.testing.assert_array_equal(_bits(tp.numpy()), _bits(jp))
    pack = tf.pack_forests([(feat, thr, leaf, 0.5)], device="cpu")
    assert int(pack.nodes[0, 0]) == (256 << 16)  # feature 0, threshold 256
    np.testing.assert_array_equal(tf.predict_forest(torch.from_numpy(b), pack).numpy(),
                                  [2.5, 1.5, 1.5, 1.5])


def test_predict_forest_checks_its_inputs(models):
    _, tm = models["clicks"]
    pack = tm.packed("cpu")
    assert pack.n_folds == 3 and pack.depth == 7 and pack.feat.shape == (280, 127)
    with pytest.raises(TypeError):
        tf.predict_forest(torch.zeros((4, 55), dtype=torch.int32), pack)
    with pytest.raises(ValueError):
        tf.predict_forest(torch.zeros((4, 20), dtype=torch.uint8), pack)  # a node reads > 20
    f = tm.forests[0]
    with pytest.raises(ValueError):
        tf.pack_forests([(f.feat, np.full_like(f.thr, 40000), f.leaf, f.base)], device="cpu")
    with pytest.raises(ValueError):
        tf.pack_forests([(f.feat[:, :63], f.thr[:, :63], f.leaf[:, :64], f.base),
                         (f.feat, f.thr, f.leaf, f.base)], device="cpu")


def _assert_same_model(a, b):
    assert len(a.forests) == len(b.forests)
    for fa, fb in zip(a.forests, b.forests):
        for name in ("feat", "thr", "leaf", "gain_importance", "split_importance"):
            x, y = getattr(fa, name), getattr(fb, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        assert (fa.base, fa.depth, fa.best_iteration) == (fb.base, fb.depth, fb.best_iteration)
    np.testing.assert_array_equal(a.edges, b.edges)
    assert a.edges.dtype == b.edges.dtype
    assert a.config.to_dict() == b.config.to_dict()
    assert a.feature_names == b.feature_names
    np.testing.assert_array_equal(a.fold_recalls, b.fold_recalls)
    for name in ("oof_recall", "prior_alpha"):
        x, y = getattr(a, name), getattr(b, name)
        assert x == y or (np.isnan(x) and np.isnan(y)), name


def test_npz_round_trips_both_ways(models, tmp_path):
    jm, tm = models["carts"]
    tm.prior_alpha, jm.prior_alpha = 0.25, 0.25
    try:
        tm.save(tmp_path / "port.npz")
        jm.save(tmp_path / "jax.npz")
        _assert_same_model(jg.load_ranker_model(tmp_path / "port.npz"), jm)
        _assert_same_model(tg.load_ranker_model(tmp_path / "jax.npz"), tm)
        with np.load(tmp_path / "port.npz", allow_pickle=True) as a, \
                np.load(tmp_path / "jax.npz", allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    finally:
        tm.prior_alpha = jm.prior_alpha = float("inf")


def test_from_numpy_and_importances(models):
    jm, tm = models["clicks"]
    got = tg.GBDTRankerModel.from_numpy(
        [vars(f) for f in jm.forests], jm.edges, GBDTConfig.from_dict(jm.config.to_dict()),
        feature_names=list(jm.feature_names), fold_recalls=list(jm.fold_recalls),
        oof_recall=jm.oof_recall, prior_alpha=jm.prior_alpha)
    _assert_same_model(got, tm)
    for kind in ("gain", "split"):
        np.testing.assert_array_equal(tm.feature_importance(kind), jm.feature_importance(kind))


def test_load_ranker_model_refuses_a_tower(tmp_path):
    np.savez(tmp_path / "tower.npz", w0=np.zeros((2, 2), np.float32))
    with pytest.raises(NotImplementedError, match="M12"):
        tg.load_ranker_model(tmp_path / "tower.npz")


def test_ranker_helpers_equal():
    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 40, 200)
    np.testing.assert_array_equal(trk.group_kfold(sizes, 5), jrk.group_kfold(sizes, 5))
    labels = (rng.random((60, 30)) < 0.1).astype(np.int8)
    mask = rng.random((60, 30)) < 0.9
    np.testing.assert_array_equal(
        trk.negative_sample_mask(labels, mask, 0.3, np.random.default_rng(9)),
        jrk.negative_sample_mask(labels, mask, 0.3, np.random.default_rng(9)))
    cands = rng.integers(0, 100, (60, 30)).astype(np.int32)
    scores = np.round(rng.normal(size=(60, 30)), 1).astype(np.float32)  # ties
    scores[~mask] = -np.inf
    np.testing.assert_array_equal(trk.top_k_predictions(cands, scores, k=20),
                                  jrk.top_k_predictions(cands, scores, k=20))


def test_committed_model_config_loads():
    with np.load(BENCH / "ranker_clicks.npz", allow_pickle=True) as z:
        cfg = json.loads(bytes(z["__config"]).decode())
    assert dataclasses.asdict(GBDTConfig.from_dict(cfg)) == cfg
