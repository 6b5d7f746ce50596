"""The port's two-stage prediction path against ``otto_tpu``, on the CPU.

The committed fold models of ``artifacts/bench_e2e`` score a small
``synthetic_events_v2`` store through both packages: covisitation tables
built by ``otto_tpu``, the heuristic on the host routes (both packages pick
them on a CPU), candidates, heuristic union, features, fold-averaged GBDT,
prior blend, top-20.  Sessions are at most 32 events long, so the JAX
package compiles one width bucket.

Tolerances: top-20 lists bit-equal per type (the candidate grids, features,
bins and forest scores are bit-equal, tests/test_torch_{candidates,features,
gbdt_predict}.py, and the blend is the same numpy); recall counts, the
per-session recalls and the paired bootstrap equal; MAP@k within (S - 1) *
2^-24 relative: the ranking is the same (float32 total order, ties to the
lower column, as ``jax.lax.top_k``), but the mean over S sessions is a
float32 sum that XLA and torch reduce in other orders.  The ``slow`` case replays the bench's
artifact mode (``bench.py::e2e_artifact_bench``) on 1,000 training-disjoint
sessions through both packages.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from otto_tpu import EVENT_TYPES
from otto_tpu import streaming as jstream
from otto_tpu import twostage as jts
from otto_tpu.config import RankerConfig as JRankerConfig
from otto_tpu.data.splits import split_by_time as j_split_by_time
from otto_tpu.data.synthetic import synthetic_events_v2 as j_synth_v2
from otto_tpu.eval import harness as jh
from otto_tpu.eval import metrics as jmet
from otto_tpu.models import gbdt as jg
from otto_tpu.models.covisitation import build_covisitation as j_build
from otto_tpu_torch import streaming as tstream
from otto_tpu_torch import twostage as tts
from otto_tpu_torch.data.splits import split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.eval import harness as th
from otto_tpu_torch.eval import metrics as tmet
from otto_tpu_torch.models import gbdt as tg
from otto_tpu_torch.models.covisitation import CovisitationMatrices

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "artifacts" / "bench_e2e"
N_AIDS = 1500
CHUNK = 64


def _artifacts(pkg, gbdt, matrices, meta):
    rankers = {n: gbdt.load_ranker_model(BENCH / f"ranker_{n}.npz")
               for n in meta["ranker_names"]}
    return pkg.TwoStageArtifacts(
        matrices=matrices, sgns=None, candidates=None, rankers=rankers, predictions={},
        report=None, max_recall=meta.get("max_recall", {}),
        heuristic_union=meta.get("heuristic_union", True), feature_list=meta["feature_list"])


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_sessions=360, n_aids=N_AIDS, mean_length=12.0, max_length=32, n_clusters=40,
              seed=31)
    jsp = j_split_by_time(j_synth_v2(**kw), val_fraction=0.5, seed=0)
    tsp = split_by_time(synthetic_events_v2(**kw), val_fraction=0.5, seed=0)
    jm = j_build(jsp.train, N_AIDS, chunk_sessions=256)
    tm = CovisitationMatrices({k: (np.asarray(a), np.asarray(w))
                               for k, (a, w) in jm.tables.items()}, N_AIDS)
    meta = json.loads((BENCH / "meta.json").read_text())
    ja, ta = _artifacts(jts, jg, jm, meta), _artifacts(tts, tg, tm, meta)
    want = jts.predict_two_stage(ja, jsp.train, jsp.val_input, N_AIDS, chunk_sessions=CHUNK)
    return jsp, tsp, ja, ta, want


def _same_lists(got, want):
    for t in EVENT_TYPES:
        assert got[t].dtype == np.int32 and got[t].shape == want[t].shape
        np.testing.assert_array_equal(got[t], want[t], err_msg=t)


def test_predict_two_stage_lists_bit_equal(setup):
    jsp, tsp, _, ta, want = setup
    stats = {}
    got = tts.predict_two_stage(ta, tsp.train, tsp.val_input, N_AIDS, chunk_sessions=CHUNK,
                                stats_out=stats, device="cpu")
    _same_lists(got, want)
    S = tsp.val_input.n_sessions
    assert stats["rows_clicks"] == S * 184  # 64 history + 100 votes + 20 heuristic
    assert all(stats[k] >= 0 for k in ("candidates_s", "heuristic_s", "features_s",
                                       "binning_s", "forest_s", "blend_s"))


def test_streamed_prediction_with_prior_blend_bit_equal(setup):
    """Prediction-only streaming over the training-disjoint sessions, in two
    shards, with a finite prior alpha (0.5: the ranker blended with the
    heuristic prior) on every ranker."""
    jsp, tsp, ja, ta, _ = setup
    kw = dict(train_sessions=30, train_subset_seed=23, exclude_train_subset=True,
              shard_sessions=60, max_stream_sessions=120, chunk_sessions=CHUNK, n_boot=50)
    try:
        for a in (ja, ta):
            for m in a.rankers.values():
                m.prior_alpha = 0.5
        want = jstream.run_two_stage_streamed(jsp.train, jsp.val_input, N_AIDS,
                                              labels=jsp.val_labels, artifacts=ja, **kw)
        got = tstream.run_two_stage_streamed(tsp.train, tsp.val_input, N_AIDS,
                                             labels=tsp.val_labels, artifacts=ta, device="cpu",
                                             **kw)
    finally:
        for a in (ja, ta):
            for m in a.rankers.values():
                m.prior_alpha = float("inf")
    np.testing.assert_array_equal(got.streamed_idx, want.streamed_idx)
    _same_lists(got.predictions, want.predictions)
    _same_lists(got.heuristic_predictions, want.heuristic_predictions)
    for a, b in ((got.report, want.report), (got.heuristic_report, want.heuristic_report)):
        assert (a.clicks_n, a.carts_n, a.orders_n) == (b.clicks_n, b.carts_n, b.orders_n)
        assert a.weighted == pytest.approx(b.weighted, rel=1e-6)
    assert got.bootstrap_vs_heuristic == want.bootstrap_vs_heuristic
    assert got.timings["ranker_rows_predicted"] == want.timings["ranker_rows_predicted"]
    assert [r["sessions"] for r in got.shard_times] == [60, 60]
    assert got.timings["stream_capped_at"] == 120


def test_streamed_aid_features_saved_and_resumed(setup, tmp_path, monkeypatch):
    """With ``artifact_dir`` the global aid features are written once and
    read back on the next run (not recomputed), which predicts the same
    lists."""
    _, tsp, _, ta, _ = setup
    kw = dict(max_stream_sessions=40, shard_sessions=40, chunk_sessions=CHUNK, n_boot=0,
              artifacts=ta, artifact_dir=tmp_path, device="cpu")
    first = tstream.run_two_stage_streamed(tsp.train, tsp.val_input, N_AIDS, **kw)
    assert (tmp_path / "aid_feats.npz").exists()

    def recompute(*args, **kwargs):
        raise AssertionError("aid features recomputed despite aid_feats.npz")

    monkeypatch.setattr(tstream, "compute_aid_features", recompute)
    again = tstream.run_two_stage_streamed(tsp.train, tsp.val_input, N_AIDS, **kw)
    _same_lists(again.predictions, first.predictions)
    assert first.report is None and first.bootstrap_vs_heuristic is None


def test_training_modes_raise(setup):
    """Training trains a GBDTConfig (tests/test_torch_twostage_train.py);
    what still raises: the listwise tower's config, and streamed training
    without labels."""
    _, tsp, _, _, _ = setup
    with pytest.raises(NotImplementedError, match="M12"):  # no trained rankers to resume
        tts.run_two_stage(tsp.train, tsp.val_input, N_AIDS, labels=tsp.val_labels,
                          ranker_config=JRankerConfig(), device="cpu")
    with pytest.raises(ValueError, match="requires labels"):
        tstream.run_two_stage_streamed(tsp.train, tsp.val_input, N_AIDS, device="cpu")


def test_artifacts_directory_round_trips_both_ways(setup, tmp_path):
    _, tsp, ja, ta, want = setup
    ta.predictions = dict(want)
    ja.predictions = dict(want)
    try:
        ta.save(tmp_path / "port")
        ja.save(tmp_path / "jax")
        from_port = jts.TwoStageArtifacts.load(tmp_path / "port")
        from_jax = tts.TwoStageArtifacts.load(tmp_path / "jax", device="cpu")
    finally:
        ta.predictions, ja.predictions = {}, {}
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == json.loads(
        (tmp_path / "jax" / "meta.json").read_text())
    for a in (from_port, from_jax):
        assert sorted(a.rankers) == ["carts", "clicks", "orders"] and a.sgns is None
        assert a.heuristic_union and a.feature_list == ta.feature_list
        _same_lists(a.predictions, want)
        for kind, (ids, w) in ta.matrices.tables.items():
            np.testing.assert_array_equal(a.matrices.tables[kind][0], ids)
            np.testing.assert_array_equal(a.matrices.tables[kind][1], w)
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(from_jax.rankers[t].forests[2].leaf,
                                      ta.rankers[t].forests[2].leaf)


def test_bootstrap_recalls_and_map_equal(setup):
    jsp, tsp, _, _, want = setup
    rng = np.random.default_rng(8)
    other = {t: np.where(rng.random(want[t].shape) < 0.3, -1, want[t]) for t in EVENT_TYPES}
    for t in EVENT_TYPES:
        other[t][:, :3] = rng.integers(0, N_AIDS, (other[t].shape[0], 3))
    jr = jh.per_session_recalls(jsp.val_labels, want["clicks"], want["carts"], want["orders"])
    tr = th.per_session_recalls(tsp.val_labels, want["clicks"], want["carts"], want["orders"])
    for t in EVENT_TYPES:
        for a, b in zip(tr[t], jr[t]):
            np.testing.assert_array_equal(a, b)
    for seed in (0, 17):
        assert (th.paired_bootstrap_lift(tsp.val_labels, want, other, n_boot=200, seed=seed)
                == jh.paired_bootstrap_lift(jsp.val_labels, want, other, n_boot=200,
                                            seed=seed))
    import jax.numpy as jnp

    S, C = 200, 40
    scores = np.round(rng.normal(size=(S, C)), 1).astype(np.float32)  # ties
    labels = (rng.random((S, C)) < 0.1).astype(np.int32)
    mask = rng.random((S, C)) < 0.9
    labels[:20] = 0  # sessions without positives are left out
    for k in (5, 20, 50):
        j = float(jmet.map_at_k(jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(mask),
                                k=k))
        t = tmet.map_at_k(torch.from_numpy(scores), torch.from_numpy(labels),
                          torch.from_numpy(mask), k=k)
        assert t.dtype == torch.float32
        assert float(t) == pytest.approx(j, rel=(S - 1) * 2.0**-24), k


@pytest.mark.slow
def test_bench_artifact_replay_1000_sessions():
    """``bench.py::e2e_artifact_bench`` on its data (200,000 sessions,
    ``split_by_time(0.5)``, the committed tables and fold models) for the
    first 1,000 training-disjoint sessions, through both packages."""
    from otto_tpu.eval.harness import evaluate_predictions as j_eval
    from otto_tpu.features import compute_aid_features as j_aid_features
    from otto_tpu.models.covisitation import CovisitationMatrices as JMatrices
    from otto_tpu.models.covisitation import covisit_heuristic_predictions
    from otto_tpu.models.frequency import FrequencyStatistics

    fit = json.loads((BENCH / "bench_fit.json").read_text())
    meta = json.loads((BENCH / "meta.json").read_text())
    kw = dict(n_sessions=fit["sessions"], n_aids=fit["aids"], seed=fit["seed"])
    jsp = j_split_by_time(j_synth_v2(**kw), val_fraction=fit["val_fraction"], seed=fit["seed"])
    tsp = split_by_time(synthetic_events_v2(**kw), val_fraction=fit["val_fraction"],
                        seed=fit["seed"])
    S = jsp.val_input.n_sessions
    train = jstream.train_subset_indices(S, fit["train_sessions"], fit["train_subset_seed"])
    np.testing.assert_array_equal(
        tstream.train_subset_indices(S, fit["train_sessions"], fit["train_subset_seed"]), train)
    keep = np.ones(S, bool)
    keep[train] = False
    eval_idx = np.flatnonzero(keep)[:1000]
    emask = np.zeros(S, bool)
    emask[eval_idx] = True
    jsub, tsub = jsp.val_input.select_sessions(emask), tsp.val_input.select_sessions(emask)
    jm = JMatrices.load(BENCH / "covisitation")
    tm = CovisitationMatrices.load(BENCH / "covisitation")
    aid_feats = j_aid_features(jstream._union_stats_store(jsp.train, jsp.val_input), fit["aids"])
    stats = FrequencyStatistics.compute(jsp.train, n_aids=fit["aids"])
    heur = covisit_heuristic_predictions(
        jsub, jm, {t: stats.top_by_type[t] for t in EVENT_TYPES}, chunk_sessions=512,
        recency_host_f64=True, covisit_host=True)
    want = jts.predict_two_stage(_artifacts(jts, jg, jm, meta), jsp.train, jsp.val_input
                                 .select_sessions(emask), fit["aids"], aid_feats=aid_feats,
                                 heuristic_preds=heur, chunk_sessions=512)
    from otto_tpu_torch.features import compute_aid_features as t_aid_features

    t_feats = t_aid_features(tstream._union_stats_store(tsp.train, tsp.val_input), fit["aids"])
    for k, v in aid_feats.items():
        np.testing.assert_array_equal(t_feats[k], v, err_msg=k)
    got = tts.predict_two_stage(_artifacts(tts, tg, tm, meta), tsp.train, tsub, fit["aids"],
                                aid_feats=t_feats, heuristic_preds=heur, chunk_sessions=512,
                                device="cpu")
    _same_lists(got, want)
    rep = j_eval(jsp.val_labels.take(eval_idx), want["clicks"], want["carts"], want["orders"])
    assert 0.5 < rep.weighted < 0.8
