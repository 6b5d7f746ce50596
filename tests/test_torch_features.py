"""The port's feature families against ``otto_tpu``, on the CPU.

Same seeded stores and candidate grids through both packages.  The port's
native segment-stats engine is a copy of the JAX package's, built by the
port into its own ``_build/``; the numpy path is reached only through
``force_numpy=True``.

Tolerances:
- port against ``otto_tpu``, each in the same mode (native or numpy):
  bit-equal, NaNs in the same places (the same code on the same inputs);
- native against numpy inside the port: the reference's own tolerances
  (``tests/test_features.py``): block statistics within 1e-12, aid
  features within rtol 1e-5 / atol 1e-6 (float64 sums in another order,
  then float32).
"""

import numpy as np
import pytest

from otto_tpu import features as jfeat
from otto_tpu.data.synthetic import synthetic_events_v2 as j_synth_v2
from otto_tpu.features import base as jbase
from otto_tpu_torch import features as tfeat
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.features import base as tbase

N_AIDS = 400


@pytest.fixture(scope="module")
def stores():
    kw = dict(n_sessions=600, n_aids=N_AIDS, mean_length=10.0, max_length=32, n_clusters=20,
              seed=5)
    return j_synth_v2(**kw), synthetic_events_v2(**kw)


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("force_numpy", [False, True])
def test_aid_features_equal(stores, force_numpy):
    js, ts = stores
    _same(tfeat.compute_aid_features(ts, N_AIDS, force_numpy=force_numpy),
          jfeat.compute_aid_features(js, N_AIDS, force_numpy=force_numpy))


def test_aid_features_native_matches_numpy(stores):
    _, ts = stores
    f1 = tfeat.compute_aid_features(ts, N_AIDS)
    f2 = tfeat.compute_aid_features(ts, N_AIDS, force_numpy=True)
    assert set(f1) == set(f2)
    for k in f1:
        np.testing.assert_allclose(f1[k], f2[k], rtol=1e-5, atol=1e-6, equal_nan=True,
                                   err_msg=k)


def test_block_stats_native_matches_numpy_and_jax(stores):
    _, ts = stores
    rng = np.random.default_rng(7)
    n_ev = len(ts.aid)
    ids, sess = ts.aid.astype(np.int64), ts.session_idx.astype(np.int64)
    day = rng.integers(1, 366, n_ev).astype(np.int32)
    ts_f = ts.ts.astype(np.float64)
    cols = np.ascontiguousarray(rng.normal(size=(3, n_ev)))
    for mask in (None, ts.type == 1, np.zeros(n_ev, bool)):
        a = tbase.block_stats(ids, sess, day, ts_f, cols, N_AIDS, mask=mask)
        b = tbase.block_stats(ids, sess, day, ts_f, cols, N_AIDS, mask=mask, force_numpy=True)
        c = jbase.block_stats(ids, sess, day, ts_f, cols, N_AIDS, mask=mask)
        for x, y, z, name in zip(a, b, c, ("count", "sess_nu", "day_nu", "ts_min", "ts_max",
                                           "sums", "sumsqs")):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12, equal_nan=True,
                                       err_msg=name)
            np.testing.assert_array_equal(x, z, err_msg=name)


def test_session_and_interaction_features_and_assembly_equal(stores):
    js, ts = stores
    aidf = jfeat.compute_aid_features(js, N_AIDS)
    _same(tfeat.compute_session_features(ts, aidf), jfeat.compute_session_features(js, aidf))
    sf = jfeat.compute_session_features(js, aidf)
    rng = np.random.default_rng(1)
    S, C = js.n_sessions, 24
    cands = rng.integers(0, N_AIDS, (S, C)).astype(np.int32)
    cands[:, -3:] = -1
    cands[::7, 5:] = -1  # ragged rows
    # candidates drawn from the session itself, so occurrence counts are live
    last = js.last_aid()
    cands[:, 0] = last
    scores = rng.random((S, C)).astype(np.float32)
    ji = jfeat.compute_interaction_features(js, cands, scores, N_AIDS)
    ti = tfeat.compute_interaction_features(ts, cands, scores, N_AIDS)
    _same(ti, ji)
    feats = tfeat.RANKER_FEATURES + ["candidate_rank"]
    assert tfeat.RANKER_FEATURES == jfeat.RANKER_FEATURES
    X = tfeat.assemble_features(feats, ti, aidf, sf, cands)
    np.testing.assert_array_equal(X, jfeat.assemble_features(feats, ji, aidf, sf, cands))
    assert X.shape == (S, C, len(feats)) and X.dtype == np.float32
    with pytest.raises(KeyError):
        tfeat.assemble_features(["no_such_feature"], ti, aidf, sf, cands)


def test_primitives_equal():
    rng = np.random.default_rng(3)
    ts = rng.integers(1_650_000_000, 1_670_000_000, 500)
    for k, v in jbase.calendar(ts).items():
        np.testing.assert_array_equal(tbase.calendar(ts)[k], v, err_msg=k)
    v = np.round(rng.normal(size=300), 1)
    v[::9] = np.nan
    np.testing.assert_array_equal(tbase.rank_pct(v), jbase.rank_pct(v))
    ids = rng.integers(0, 20, 300)
    vals = rng.normal(size=300)
    for name in ("seg_mean", "seg_std", "seg_nanmean", "seg_nanmax", "seg_min", "seg_max"):
        np.testing.assert_array_equal(getattr(tbase, name)(ids, vals, 20),
                                      getattr(jbase, name)(ids, vals, 20), err_msg=name)
    np.testing.assert_array_equal(tbase.seg_nunique(ids, ids % 3, 20),
                                  jbase.seg_nunique(ids, ids % 3, 20))


def test_failed_native_build_raises(stores, monkeypatch, tmp_path):
    """No quiet numpy fallback: a build that cannot run raises, and only
    ``force_numpy=True`` skips the engine."""
    _, ts = stores

    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(tbase, "_segstats_lib", None)
    monkeypatch.setattr(tbase, "_segstats_path", lambda: tmp_path / "libotto_segstats_x.so")
    monkeypatch.setattr(tbase.subprocess, "run", no_compiler)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tfeat.compute_aid_features(ts, N_AIDS)
    assert "aid_count" in tfeat.compute_aid_features(ts, N_AIDS, force_numpy=True)
