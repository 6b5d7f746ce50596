"""The training branch of the port's ``run_two_stage``, streamed training and
the CLI's training paths, on the CPU.

Against ``otto_tpu``: both packages' ``run_two_stage`` train on the same
labeled sessions of the bench's data (the first 300 target sessions of at
most 32 events, the first 3,000 training sessions as ``train``, the
committed covisitation tables), with ``_train_engine`` stubbed in both to
return one fixed model (a committed fold model of ``artifacts/bench_e2e``)
and its own package's scores of the grid, so that everything around the
fit is compared: the training data it is handed, the selection-restricted
recall it is given, the second ranker's blend, the prior blend's alpha, the
lists, the reports and the saved files, all equal (recalls to 1e-6: the same
float32 sums in other orders).  The fits themselves are compared in
``test_torch_gbdt_train.py``.

The CLI trains for real at a tiny size (600 sessions, a 4-tree GBDT):
``two_stage validation`` into an empty directory, then the same command
resuming from it; ``two_stage_streamed validation``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from otto_tpu import EVENT_TYPES
from otto_tpu import twostage as jts
from otto_tpu.data.splits import split_by_time as j_split_by_time
from otto_tpu.data.synthetic import synthetic_events_v2 as j_synth_v2
from otto_tpu.models import gbdt as jg
from otto_tpu.models.covisitation import CovisitationMatrices as JMatrices
from otto_tpu.models.gbdt import GBDTConfig as JGBDTConfig
from otto_tpu_torch import pipelines as tpipe
from otto_tpu_torch import twostage as tts
from otto_tpu_torch.config import GBDTConfig
from otto_tpu_torch.data.splits import split_by_fraction, split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.models import gbdt as tg
from otto_tpu_torch.models.covisitation import CovisitationMatrices
from test_torch_twostage_resume import _cut, _same_report

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "artifacts" / "bench_e2e"
CHUNK = 64


@pytest.fixture(scope="module")
def data():
    fit = json.loads((BENCH / "bench_fit.json").read_text())
    kw = dict(n_sessions=fit["sessions"], n_aids=fit["aids"], seed=fit["seed"])
    j = _cut(j_split_by_time(j_synth_v2(**kw), val_fraction=fit["val_fraction"],
                             seed=fit["seed"]), 3000, 300)
    t = _cut(split_by_time(synthetic_events_v2(**kw), val_fraction=fit["val_fraction"],
                           seed=fit["seed"]), 3000, 300)
    return fit["aids"], j, t


def _stub_engine(pkg, calls: list):
    """``_train_engine`` returning the committed clicks model for the first
    ranker config (seed 1) and the carts model for the second (seed 2), with
    its package's scores of the grid; records what the fit was handed."""
    def engine(data, cfg, eval_recall, **kw):
        name = "clicks" if cfg.seed == 1 else "carts"
        if pkg is jts:
            model = jg.load_ranker_model(BENCH / f"ranker_{name}.npz")
            scores = model.predict(data.features, data.mask)
        else:
            model = tg.load_ranker_model(BENCH / f"ranker_{name}.npz")
            scores = model.predict(data.features, data.mask, device=kw["device"])
        model.prior_alpha = float("nan")
        S = data.mask.shape[0]
        calls.append({"seed": cfg.seed, "features": data.features, "labels": data.labels,
                      "mask": data.mask, "candidates": data.candidates,
                      "names": list(data.feature_names),
                      "recall": eval_recall(np.arange(S), scores),
                      "recall_half": eval_recall(np.arange(S // 2), scores[:S // 2])})
        return model, scores
    return engine


def _sum_engine(pkg, calls: list):
    """``_train_engine`` returning the committed clicks model with the sum
    of each row's finite features as its scores: the same scores in both
    packages wherever they are handed the same rows, with no forest pass."""
    def engine(data, cfg, eval_recall, **kw):
        model = (jg if pkg is jts else tg).load_ranker_model(BENCH / "ranker_clicks.npz")
        model.prior_alpha = float("nan")
        x = np.where(np.isfinite(data.features), data.features, 0.0).sum(axis=-1)
        calls.append({"features": data.features, "candidates": data.candidates})
        return model, np.where(data.mask, x, -np.inf).astype(np.float32)
    return engine


def test_run_two_stage_without_prior_blend_equal_to_jax(data, tmp_path, monkeypatch):
    """``prior_blend=False``: the lists rank the ranker's scores, no alpha
    is selected or stored, as in the JAX package."""
    n_aids, (j_train, j_target, j_labels), (t_train, t_target, t_labels) = data
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jts, "_train_engine", _sum_engine(jts, calls["jax"]))
    monkeypatch.setattr(tts, "_train_engine", _sum_engine(tts, calls["port"]))
    want = jts.run_two_stage(j_train, j_target, n_aids, labels=j_labels, prior_blend=False,
                             ranker_config=JGBDTConfig(),
                             matrices=JMatrices.load(BENCH / "covisitation"),
                             artifact_dir=tmp_path / "jax", chunk_sessions=CHUNK)
    got = tts.run_two_stage(t_train, t_target, n_aids, labels=t_labels, prior_blend=False,
                            matrices=CovisitationMatrices.load(BENCH / "covisitation"),
                            artifact_dir=tmp_path / "port", chunk_sessions=CHUNK,
                            device="cpu")
    for g, w in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(g["features"], w["features"])
    for t in EVENT_TYPES:
        assert np.isnan(got.rankers[t].prior_alpha) and np.isnan(want.rankers[t].prior_alpha)
        np.testing.assert_array_equal(got.predictions[t], want.predictions[t], err_msg=t)
    _same_report(got.report, want.report)
    blended = tts.run_two_stage(t_train, t_target, n_aids, labels=t_labels,
                                matrices=CovisitationMatrices.load(BENCH / "covisitation"),
                                chunk_sessions=CHUNK, device="cpu")
    assert any((blended.predictions[t] != got.predictions[t]).any() for t in EVENT_TYPES)


def test_trained_run_two_stage_equal_to_jax(data, tmp_path, monkeypatch):
    """A first and a second ranker a type, blended half and half."""
    n_aids, (j_train, j_target, j_labels), (t_train, t_target, t_labels) = data
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jts, "_train_engine", _stub_engine(jts, calls["jax"]))
    monkeypatch.setattr(tts, "_train_engine", _stub_engine(tts, calls["port"]))
    jkw = dict(ranker_config=JGBDTConfig(seed=1), second_ranker_config=JGBDTConfig(seed=2))
    tkw = dict(ranker_config=GBDTConfig(seed=1), second_ranker_config=GBDTConfig(seed=2))
    want = jts.run_two_stage(j_train, j_target, n_aids, labels=j_labels,
                             matrices=JMatrices.load(BENCH / "covisitation"),
                             artifact_dir=tmp_path / "jax", chunk_sessions=CHUNK, **jkw)
    stats = {}
    got = tts.run_two_stage(t_train, t_target, n_aids, labels=t_labels,
                            matrices=CovisitationMatrices.load(BENCH / "covisitation"),
                            artifact_dir=tmp_path / "port", chunk_sessions=CHUNK,
                            stats_out=stats, device="cpu", **tkw)

    assert len(calls["port"]) == len(calls["jax"]) == 6
    for g, w in zip(calls["port"], calls["jax"]):
        assert g["seed"] == w["seed"] and g["names"] == w["names"]
        for k in ("features", "labels", "mask", "candidates"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in ("recall", "recall_half"):
            assert g[k] == pytest.approx(w[k], abs=1e-6), k
    names = sorted(want.rankers)
    assert sorted(got.rankers) == names == sorted(EVENT_TYPES
                                                  + tuple(f"{t}_b" for t in EVENT_TYPES))
    for t in EVENT_TYPES:
        assert got.rankers[t].prior_alpha == want.rankers[t].prior_alpha, t
        np.testing.assert_array_equal(got.predictions[t], want.predictions[t], err_msg=t)
    _same_report(got.report, want.report)
    _same_report(got.report_disjoint, want.report_disjoint)
    for name in names:
        with np.load(tmp_path / "port" / f"ranker_{name}.npz", allow_pickle=True) as g, \
                np.load(tmp_path / "jax" / f"ranker_{name}.npz", allow_pickle=True) as w:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                if k != "__config":
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} {k}")
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == \
        json.loads((tmp_path / "jax" / "meta.json").read_text())
    with np.load(tmp_path / "port" / "predictions.npz") as g, \
            np.load(tmp_path / "jax" / "predictions.npz") as w:
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert stats["train_s"] > 0 and stats["forest_s"] == 0


def test_train_engine_takes_gbdt_configs_only(monkeypatch):
    """``_train_engine`` dispatches on the config's type: a ``GBDTConfig``
    to ``train_gbdt_ranker``, a ``RankerConfig`` to the tower's
    ``train_ranker``; any other config raises."""
    from otto_tpu_torch.config import RankerConfig

    calls = []
    for name in ("train_gbdt_ranker", "train_ranker"):
        monkeypatch.setattr(tts, name, lambda data, cfg, eval_recall, device, _n=name:
                            calls.append((_n, cfg)) or (_n, None))
    cpu = torch.device("cpu")
    assert tts._train_engine(None, GBDTConfig(), None, device=cpu)[0] == "train_gbdt_ranker"
    assert tts._train_engine(None, RankerConfig(), None, device=cpu)[0] == "train_ranker"
    assert calls == [("train_gbdt_ranker", GBDTConfig()), ("train_ranker", RankerConfig())]
    with pytest.raises(TypeError, match="object"):
        tts._train_engine(None, object(), None, device=cpu)


# ---------------------------------------------------------------- the CLI
N_AIDS = 500
TINY = "n_trees: 4\nn_folds: 2\nmax_depth: 3\nn_bins: 16\nmin_data_in_leaf: 20\nloss: bce\n" \
       "eval_every: 2\nearly_stopping_rounds: 4\n"


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_train")
    store = synthetic_events_v2(n_sessions=600, n_aids=N_AIDS, max_length=32, seed=5)
    store.to_parquet(d / "events.parquet")
    (d / "tiny.yaml").write_text(TINY)
    return d, store


def _argv(d: Path, *model) -> list[str]:
    return [*model, "--events", str(d / "events.parquet"), "--n-aids", str(N_AIDS),
            "--val-fraction", "0.5", "--seed", "0", "--ranker", "gbdt", "--config",
            str(d / "tiny.yaml"), "--device", "cpu"]


def test_cli_two_stage_trains_then_resumes(cli_files, tmp_path, monkeypatch):
    """``two_stage validation`` trains a ranker a type into an empty
    directory and saves them; the same command then resumes them (no fit),
    reuses their stored alphas, and its lists equal ``predict_two_stage``
    with the saved artifacts on the same split."""
    d, store = cli_files
    fits = []
    real = tts.train_gbdt_ranker

    def counted(*args, **kwargs):
        fits.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(tts, "train_gbdt_ranker", counted)
    adir = tmp_path / "art"
    argv = _argv(d, "two_stage", "validation") + ["--artifact-dir", str(adir)]
    first = tpipe.main(argv)
    assert len(fits) == 3 and all(c == GBDTConfig.from_yaml(d / "tiny.yaml") for c in fits)
    assert {f"ranker_{t}.npz" for t in EVENT_TYPES} <= {p.name for p in adir.iterdir()}
    assert 0 < first.report.weighted <= 1
    with np.load(adir / "predictions.npz") as z:
        for t in EVENT_TYPES:
            np.testing.assert_array_equal(z[t], first.predictions[t])
    alphas = {t: tg.load_ranker_model(adir / f"ranker_{t}.npz").prior_alpha
              for t in EVENT_TYPES}
    assert all(not np.isnan(a) for a in alphas.values())

    second = tpipe.main(argv)
    assert len(fits) == 3  # resumed: nothing fit
    for t in EVENT_TYPES:
        assert tg.load_ranker_model(adir / f"ranker_{t}.npz").prior_alpha == alphas[t]
    sp = split_by_fraction(store, val_fraction=0.5, seed=0)
    want = tts.predict_two_stage(tts.TwoStageArtifacts.load(adir, device="cpu"), sp.train,
                                 sp.val_input, N_AIDS, device="cpu")
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(second.predictions[t], want[t], err_msg=t)


def test_cli_two_stage_streamed_validation_trains(cli_files, capsys):
    d, store = cli_files
    res = tpipe.main(_argv(d, "two_stage_streamed", "validation") + ["--train-sessions", "150"])
    sp = split_by_fraction(store, val_fraction=0.5, seed=0)
    n_stream = sp.val_input.n_sessions - 150
    assert all(res.predictions[t].shape == (n_stream, 20) for t in EVENT_TYPES)
    assert 0 < res.report.weighted <= 1
    assert "lift vs heuristic" in capsys.readouterr().out


@pytest.mark.slow
def test_trained_run_two_stage_quality_as_jax(tmp_path):
    """Both packages train for real (20 trees, 3 folds, bce; the JAX package
    on its scatter histograms) on the first 600 target sessions of at most
    32 events of the bench's data, with the committed covisitation tables:
    the reports on those sessions (out-of-fold scores, the selected alpha)
    and on their selection-disjoint half agree within 0.01; the bags differ,
    so the fits are not equal.  About two minutes on one CPU."""
    fit = json.loads((BENCH / "bench_fit.json").read_text())
    kw = dict(n_sessions=fit["sessions"], n_aids=fit["aids"], seed=fit["seed"])
    j = _cut(j_split_by_time(j_synth_v2(**kw), val_fraction=0.5, seed=0), 3000, 600)
    t = _cut(split_by_time(synthetic_events_v2(**kw), val_fraction=0.5, seed=0), 3000, 600)
    cfg = dict(n_trees=20, n_folds=3, early_stopping_rounds=10, min_data_in_leaf=50, loss="bce")
    want = jts.run_two_stage(*j[:2], fit["aids"], labels=j[2],
                             ranker_config=JGBDTConfig(**cfg, hist_impl="scatter"),
                             matrices=JMatrices.load(BENCH / "covisitation"), chunk_sessions=256)
    got = tts.run_two_stage(*t[:2], fit["aids"], labels=t[2], ranker_config=GBDTConfig(**cfg),
                            matrices=CovisitationMatrices.load(BENCH / "covisitation"),
                            chunk_sessions=256, device="cpu")
    print(f"in-sample weighted: jax {want.report.weighted:.6f} port {got.report.weighted:.6f}; "
          f"disjoint half: jax {want.report_disjoint.weighted:.6f} port "
          f"{got.report_disjoint.weighted:.6f}")
    assert got.max_recall == pytest.approx(want.max_recall, abs=1e-6)
    assert abs(got.report.weighted - want.report.weighted) <= 0.01
    assert abs(got.report_disjoint.weighted - want.report_disjoint.weighted) <= 0.01
