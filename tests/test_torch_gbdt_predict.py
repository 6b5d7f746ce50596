"""The port's GBDT inference (binning, routing, fold forests, npz layout)
and the ranker helpers against ``otto_tpu``, on the CPU.

The models are the committed ``artifacts/bench_e2e/ranker_{clicks,carts,
orders}.npz`` (three folds of depth 7, 50-120 trees a fold, 55 features,
256 bins).  Same seeded numpy inputs through both packages.  The float-row
route (``predict_forest_rows``: the twin's binning, then routing) is held to
the JAX package's ``bin_features`` plus ``GBDTRankerModel.predict``, also on
rows of the values binning can get wrong (NaN, +-inf, +-0.0, denormals,
edges and one ulp either side, float32 max).  The forest kernel cannot run
here; its arithmetic (the packed slices, the sign-bit compare, the 8-step
edge search, the fold sums across slices) is replayed in numpy on the
kernel's own pack and held to the twins.

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
    # the kernel's slice: heap row 1 the root, (thr << 7) | feat; rows 4-7 the leaves
    assert pack.model.shape == (1, 8, 32)
    assert int(pack.model[0, 1, 0]) == (256 << 7)  # feature 0, threshold 256
    assert pack.model[0, 4:, 0].view(torch.float32).tolist() == [1.0, 2.0, 4.0, 8.0]
    np.testing.assert_array_equal(tf.predict_forest(torch.from_numpy(b), pack).numpy(),
                                  [2.5, 1.5, 1.5, 1.5])
    np.testing.assert_array_equal(_kernel_emulation(b, pack), [2.5, 1.5, 1.5, 1.5])
    # the kernel's compare, n - (bin << 7) < 0, is bin > thr for every bin,
    # every threshold up to 256 and every feature the node can name
    t_, f_, b_ = np.meshgrid(np.arange(257), np.arange(128), np.arange(256), indexing="ij")
    n = ((t_ << 7) | f_).astype(np.uint32)
    right = ((n - (b_.astype(np.uint32) << 7)) >> 31).astype(bool)
    np.testing.assert_array_equal(right, b_ > t_)


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
    """``load_ranker_model`` dispatches on the ``__gbdt`` marker: a tower's
    npz, written by the JAX package, loads as the port's ``RankerModel``
    with the given config (default ``RankerConfig()``), a GBDT's as
    ``GBDTRankerModel``."""
    from otto_tpu.config import RankerConfig as JRankerConfig
    from otto_tpu_torch.config import RankerConfig

    rng = np.random.default_rng(3)
    params = {"w0": rng.normal(size=(4, 3)).astype(np.float32), "b0": np.zeros(3, np.float32),
              "w1": rng.normal(size=(3, 1)).astype(np.float32), "b1": np.zeros(1, np.float32)}
    jrk.RankerModel([params], jrk.FeatureNormalizer(np.zeros(4, np.float32),
                                                    np.ones(4, np.float32), np.zeros(4, bool)),
                    JRankerConfig(hidden_dims=(3,)), feature_names=list("abcd"),
                    prior_alpha=0.5).save(tmp_path / "tower.npz")
    for cfg, want in ((None, RankerConfig()), (RankerConfig(hidden_dims=(3,)),
                                               RankerConfig(hidden_dims=(3,)))):
        model = tg.load_ranker_model(tmp_path / "tower.npz", cfg)
        assert isinstance(model, trk.RankerModel) and model.config == want
        assert model.feature_names == list("abcd") and model.prior_alpha == 0.5
        for k, v in params.items():
            np.testing.assert_array_equal(model.params_per_fold[0][k], v)
    assert isinstance(tg.load_ranker_model(BENCH / "ranker_clicks.npz", RankerConfig()),
                      tg.GBDTRankerModel)


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


# ---------------------------------------------------------- float-row route
FMAX = np.finfo(np.float32).max


def _edge_rows(edges, n, seed):
    """Float32 rows [n, F] against ``edges`` [F, E]: lognormal values, with a
    third of the cells an edge value, the next float above or below one, or
    a special value."""
    rng = np.random.default_rng(seed)
    F, E = edges.shape
    e = edges[np.arange(F)[None, :], rng.integers(0, E, (n, F))]
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 5e-40, -5e-40,
                        1.1754942e-38, FMAX, -FMAX], np.float32)
    x = rng.lognormal(size=(n, F)).astype(np.float32)
    kind = rng.integers(0, 9, (n, F))
    x = np.where(kind == 0, e, x)
    with np.errstate(over="ignore"):  # the float above float32 max is +inf
        x = np.where(kind == 1, np.nextafter(e, np.float32(np.inf)), x)
        x = np.where(kind == 2, np.nextafter(e, np.float32(-np.inf)), x)
    return np.where(kind == 3, special[rng.integers(0, len(special), (n, F))], x)


def _synthetic_edges():
    """Edge rows as ``fit_bin_edges`` writes them, with the awkward values:
    signed zeros and denormals among the edges, duplicates, float32-max pads,
    an all-zero row (a feature never seen) and a full row of 254."""
    rows = [np.array([-FMAX, -1.0, -1e-40, -0.0, 0.0, 1e-45, 1e-40, 1.1754942e-38, 0.5, 1.0,
                      1.0, 2.0], np.float32),
            np.zeros(254, np.float32),
            np.sort(np.random.default_rng(7).normal(size=254).astype(np.float32)),
            np.array([0.0], np.float32)]
    out = np.full((len(rows), 254), FMAX, np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _kernel_bins(x, packed_edges):
    """The kernel's binning in numpy: an 8-step branchless lower bound over
    the packed edges (255 slots), NaN -> 0."""
    e = packed_edges.numpy()
    F = e.shape[0]
    pos = np.zeros(x.shape, np.int64)
    for step in (128, 64, 32, 16, 8, 4, 2, 1):
        pos += np.where(e[np.arange(F)[None, :], pos + step - 1] < x, step, 0)
    return np.where(np.isnan(x), 0, pos + 1).astype(np.uint8)


def _kernel_emulation(bins, pack):
    """The forest kernel's arithmetic in numpy on its own pack: per 32-tree
    slice, each lane's tree walked by ``j = 2 j + sign(n - (bin << 7))`` over
    the heap words, the leaf read at row j, then the leaves added in tree
    order, each fold closed where its trees end, folds added in order and
    times float32(1 / n_folds)."""
    model = pack.model.numpy().view(np.uint32)
    ends, base = pack.fold_end.numpy(), pack.base.numpy()
    n_folds, T, rows = len(ends), pack.n_trees, np.arange(len(bins))
    fold, s, acc = 0, np.full(len(bins), base[0], np.float32), None
    for sl in range(model.shape[0]):
        tile = np.empty((len(bins), 32), np.float32)
        for lane in range(32):
            j = np.ones(len(bins), np.uint32)
            for _ in range(pack.depth):
                n = model[sl, j, lane]
                d = n - (bins[rows, n & 127].astype(np.uint32) << 7)
                j = (j << 1) | (d >> 31)
            tile[:, lane] = model[sl, j, lane].view(np.float32)
        for t in range(min(32, T - 32 * sl)):
            while fold < n_folds and 32 * sl + t == ends[fold]:
                acc = s if acc is None else acc + s
                fold += 1
                s = np.full(len(bins), base[min(fold, n_folds - 1)], np.float32)
            s = s + tile[:, t]
    while fold < n_folds:
        acc = s if acc is None else acc + s
        fold += 1
        s = np.full(len(bins), base[min(fold, n_folds - 1)], np.float32)
    return acc * np.float32(1.0 / n_folds)


def test_bin_rows_twin_bit_equal_to_bin_features(models):
    """The twin's binning and the kernel's search equal numpy's
    ``bin_features`` on the committed edges and on synthetic ones."""
    jm, _ = models["clicks"]
    for edges, n in ((jm.edges, 3000), (_synthetic_edges(), 4000)):
        x = _edge_rows(edges, n, 11)
        want = jg.bin_features(x, edges)
        packed = tf.pack_edges(edges, device="cpu")
        assert packed.shape == (edges.shape[0], 256) and torch.isinf(packed[:, 254:]).all()
        np.testing.assert_array_equal(tf._bin_rows_reference(torch.from_numpy(x), packed).numpy(),
                                      want)
        np.testing.assert_array_equal(_kernel_bins(x, packed), want)
    # the specials against a hand count: -0.0 == +0.0 and an edge value goes low
    e = _synthetic_edges()[:1]
    x = np.array([[np.nan, -np.inf, -FMAX, -0.0, 0.0, 1e-45, 1e-40, 1.0, FMAX, np.inf]],
                 np.float32).T
    got = tf._bin_rows_reference(torch.from_numpy(np.ascontiguousarray(x)),
                                 tf.pack_edges(e, device="cpu")).numpy()[:, 0]
    np.testing.assert_array_equal(got, [0, 1, 1, 4, 4, 6, 7, 10, 13, 255])
    np.testing.assert_array_equal(got, jg.bin_features(x, e)[:, 0])


@pytest.mark.parametrize("etype", TYPES)
@pytest.mark.parametrize("n", [1, 115, 1500])
def test_predict_rows_bit_equal_to_jax_predict(models, etype, n):
    """Float rows through the port's float-row route (twin binning, twin
    routing) and through ``otto_tpu``'s ``bin_features`` + ``predict``."""
    jm, tm = models[etype]
    x = _edge_rows(jm.edges, n, 20 + n)
    want = jm.predict(x[None], np.ones((1, n), bool), batch=1024)[0]
    got = tm.predict_rows(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(tm.predict(x[None], np.ones((1, n), bool),
                                                   device="cpu")[0]), _bits(want))


@pytest.mark.parametrize("etype", TYPES)
def test_kernel_arithmetic_on_its_pack_equals_twins(models, etype):
    """The kernel's binning and routing replayed on its pack (folds of 50-120
    trees end inside 32-tree slices) equal the float-row twin bit for bit."""
    _, tm = models[etype]
    x = _edge_rows(tm.edges, 700, 5)
    pack, edges = tm.packed("cpu"), tm.packed_edges("cpu")
    assert any(int(e) % 32 for e in pack.fold_end[:-1])
    got = _kernel_emulation(_kernel_bins(x, edges), pack)
    want = tf.predict_forest_rows(torch.from_numpy(x), edges, pack).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_kernel_arithmetic_with_ragged_and_empty_folds():
    """Folds of 5, 40, 0 and 29 trees (ends at 5, 45, 45, 74: inside slices,
    an empty fold, a ragged last slice) at depths 1, 3 and 7."""
    rng = np.random.default_rng(8)
    for depth in (1, 3, 7):
        folds = []
        for n_trees in (5, 40, 0, 29):
            ni = (1 << depth) - 1
            folds.append((rng.integers(0, 20, (n_trees, ni)).astype(np.int32),
                          rng.integers(0, 257, (n_trees, ni)).astype(np.int32),
                          rng.normal(size=(n_trees, ni + 1)).astype(np.float32),
                          float(rng.normal())))
        pack = tf.pack_forests(folds, device="cpu")
        assert pack.model.shape == (3, 2 << depth, 32)
        b = _binned_rows(300, depth, n_feat=20)
        want = tf.predict_forest(torch.from_numpy(b), pack).numpy()
        np.testing.assert_array_equal(_bits(_kernel_emulation(b, pack)), _bits(want))


def test_predict_forest_rows_checks_its_inputs(models):
    jm, tm = models["clicks"]
    pack, edges = tm.packed("cpu"), tm.packed_edges("cpu")
    x = torch.from_numpy(_edge_rows(jm.edges, 8, 1))
    with pytest.raises(TypeError):  # float64 rows: numpy would bin them in float64
        tf.predict_forest_rows(x.double(), edges, pack)
    with pytest.raises(TypeError):
        tm.predict(x.double().numpy()[None], np.ones((1, 8), bool), device="cpu")
    with pytest.raises(ValueError):  # a wrong F
        tf.predict_forest_rows(x[:, :54].contiguous(), edges, pack)
    with pytest.raises(ValueError):  # edges not packed
        tf.predict_forest_rows(x, torch.from_numpy(jm.edges), pack)
    with pytest.raises(ValueError):  # rows and edges on different devices
        tf.predict_forest_rows(x, torch.empty((55, 256), device="meta"), pack)
    with pytest.raises(ValueError):  # rows and model on different devices
        tf.predict_forest_rows(x.to("meta"), edges.to("meta"), pack)
    unsorted = jm.edges.copy()
    unsorted[3, :2] = (1.0, -1.0)
    with pytest.raises(ValueError):  # packing checks the edges' order
        tf.pack_edges(unsorted, device="cpu")
    nan = jm.edges.copy()
    nan[0, 0] = np.nan
    with pytest.raises(ValueError):
        tf.pack_edges(nan, device="cpu")
    with pytest.raises(ValueError):  # 255 edges would give bin 256
        tf.pack_edges(np.zeros((2, 255), np.float32), device="cpu")
    # a model reading feature 128 has no kernel pack (the kernel takes F <= 128)
    f = tm.forests[0]
    wide = tf.pack_forests([(np.full_like(f.feat, 128), f.thr, f.leaf, f.base)], device="cpu")
    assert wide.model is None
