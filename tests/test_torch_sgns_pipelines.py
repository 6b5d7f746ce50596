"""The SGNS entry points of the port against ``otto_tpu``, on the CPU:
``run_embedding_knn``, ``run_doc2vec`` and ``run_two_stage``'s SGNS branch,
on a tiny synthetic store (600 sessions over 500 aids, at most 32 events).

The two packages train SGNS on the same host draws; where the objective is
``ns`` the port's negative uniforms are JAX's (``JaxUniforms``), so the two
trained tables agree within 1e-5.  This store was chosen (size and seeds)
so that the two trained tables give equal neighbor tables, which each test
asserts before comparing what follows from them: embedding-kNN lists then
equal, reports equal to 4 decimals (doc2vec's session vectors agree within
1e-6, so a near-tie of two similar sessions could swap: its reports are
held to 4 decimals too).

``run_two_stage`` is compared with its fits stubbed in both packages
(``test_torch_twostage_train._sum_engine``: a committed fold model, the
rows' feature sums as its scores), the covisitation tables built once by
the JAX package and read by both: candidates, lists and reports equal.
"""


import numpy as np
import pytest
import torch

from otto_tpu import EVENT_TYPES
from otto_tpu import pipelines as jpipe
from otto_tpu import twostage as jts
from otto_tpu.config import SGNSConfig as JSGNSConfig
from otto_tpu.data.splits import split_by_fraction as j_split
from otto_tpu.data.synthetic import synthetic_events_v2 as j_synth_v2
from otto_tpu.models import covisitation as jcov
from otto_tpu.models import embeddings as jemb
from otto_tpu.models.gbdt import GBDTConfig as JGBDTConfig
from otto_tpu_torch import pipelines as tpipe
from otto_tpu_torch import twostage as tts
from otto_tpu_torch.config import GBDTConfig, SGNSConfig
from otto_tpu_torch.data.splits import split_by_fraction
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.models import embeddings as temb
from otto_tpu_torch.models.covisitation import CovisitationMatrices
from test_torch_sgns import JaxUniforms
from test_torch_twostage_resume import _same_report
from test_torch_twostage_train import TINY, _sum_engine

torch.set_num_threads(1)

N_AIDS = 500
SGNS_YAML = ("dim: 16\nwindow: 4\nnegatives: 5\nepochs: 2\nbatch_centers: 1024\n"
             "steps_per_call: 4\nsubsample_t: 0.001\nseed: 42\n")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sgns_world")
    kw = dict(n_sessions=600, n_aids=N_AIDS, max_length=32, seed=5)
    sp_j = j_split(j_synth_v2(**kw), 0.5, seed=0)
    sp_t = split_by_fraction(synthetic_events_v2(**kw), 0.5, seed=0)
    (d / "sgns.yaml").write_text(SGNS_YAML)
    (d / "sgns_hs.yaml").write_text(SGNS_YAML + "objective: hs\n")
    (d / "tiny.yaml").write_text(TINY)
    jcov.build_covisitation(sp_j.train, N_AIDS).save(d / "covisitation")
    return d, sp_j, sp_t


def _capture(monkeypatch, module, into: list):
    real = module.train_sgns

    def train(*args, **kwargs):
        into.append(real(*args, **kwargs))
        return into[-1]

    monkeypatch.setattr(module, "train_sgns", train)


@pytest.mark.parametrize("objective", ["ns", "hs"])
@pytest.mark.parametrize("runner", ["run_embedding_knn", "run_doc2vec"])
def test_sgns_runner_matches_jax(world, monkeypatch, runner, objective):
    d, sp_j, sp_t = world
    cfg = d / ("sgns.yaml" if objective == "ns" else "sgns_hs.yaml")
    if objective == "ns":
        monkeypatch.setattr(temb, "negative_uniforms", JaxUniforms(42))
    models = {"jax": [], "port": []}
    _capture(monkeypatch, jemb, models["jax"])
    _capture(monkeypatch, temb, models["port"])
    want = getattr(jpipe, runner)(sp_j.train, sp_j.val_input, N_AIDS, sp_j.val_labels,
                                  config_path=str(cfg))
    got = getattr(tpipe, runner)(sp_t.train, sp_t.val_input, N_AIDS, sp_t.val_labels,
                                 config_path=str(cfg), device="cpu")
    (jm,), (tm,) = models["jax"], models["port"]
    np.testing.assert_allclose(tm.w_in.numpy(), jm.w_in, atol=1e-5)
    np.testing.assert_array_equal(tm.neighbor_table(k=21), jm.neighbor_table(k=21))
    if runner == "run_embedding_knn":
        for t in EVENT_TYPES:
            np.testing.assert_array_equal(got.predictions[t], want.predictions[t], err_msg=t)
    for f in ("clicks", "carts", "orders", "weighted"):
        assert round(getattr(got.report, f), 4) == round(getattr(want.report, f), 4), f
    assert 0 < got.report.weighted < 1


def test_run_two_stage_trains_saves_and_resumes_sgns(world, tmp_path, monkeypatch):
    """The first run trains SGNS (and the rankers) and saves ``sgns.npz``;
    the second resumes both, trains nothing, and its lists equal
    ``predict_two_stage`` with the saved artifacts; a third, given that
    model as ``sgns``, uses it as it is.  (The first run's lists
    rank out-of-fold scores, the second's the fold average, as in both
    packages, so those two differ.)  ``ft_k`` keeps its default 20, the
    width ``predict_two_stage`` takes in both packages."""
    d, _, sp_t = world
    trained, tables = [], []
    _capture(monkeypatch, tts, trained)
    real_table = temb.SGNSModel.neighbor_table

    def table(self, k, **kw):
        tables.append(k)
        return real_table(self, k, **kw)

    monkeypatch.setattr(temb.SGNSModel, "neighbor_table", table)
    kw = dict(labels=sp_t.val_labels, ranker_config=GBDTConfig.from_yaml(d / "tiny.yaml"),
              sgns_config=SGNSConfig.from_yaml(d / "sgns.yaml"),
              artifact_dir=tmp_path / "art", device="cpu")
    stats = {}
    first = tts.run_two_stage(sp_t.train, sp_t.val_input, N_AIDS, stats_out=stats, **kw)
    assert len(trained) == 1 and tables == [20] and stats["sgns_s"] > 0
    saved = temb.SGNSModel.load(tmp_path / "art" / "sgns.npz", device="cpu")
    np.testing.assert_array_equal(saved.w_in.numpy(), trained[0].w_in.numpy())
    assert first.sgns is trained[0] and 0 < first.report.weighted <= 1
    second = tts.run_two_stage(sp_t.train, sp_t.val_input, N_AIDS, **kw)
    assert len(trained) == 1 and tables == [20, 20]
    np.testing.assert_array_equal(second.sgns.w_in.numpy(), saved.w_in.numpy())
    art = tts.TwoStageArtifacts.load(tmp_path / "art", device="cpu")
    want = tts.predict_two_stage(art, sp_t.train, sp_t.val_input, N_AIDS, device="cpu")
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(second.predictions[t], want[t], err_msg=t)
    given = tts.run_two_stage(sp_t.train, sp_t.val_input, N_AIDS, sgns=saved,
                              **dict(kw, sgns_config=None))
    assert given.sgns is saved and len(trained) == 1 and tables == [20] * 4
    for t in EVENT_TYPES:  # the same model as the one in the directory
        np.testing.assert_array_equal(given.predictions[t], want[t], err_msg=t)


def test_run_two_stage_sgns_branch_equal_to_jax(world, tmp_path, monkeypatch):
    """``sgns_config`` (hs, trained in both packages on the same draws) with
    ``ft_k=10`` and ``prior_blend=False``; fits stubbed: the neighbor
    tables, the candidates, the lists and the reports equal, and
    ``sgns.npz`` saved."""
    d, sp_j, sp_t = world
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jts, "_train_engine", _sum_engine(jts, calls["jax"]))
    monkeypatch.setattr(tts, "_train_engine", _sum_engine(tts, calls["port"]))
    kw = dict(ft_k=10, prior_blend=False, chunk_sessions=64)
    want = jts.run_two_stage(sp_j.train, sp_j.val_input, N_AIDS, labels=sp_j.val_labels,
                             ranker_config=JGBDTConfig(),
                             sgns_config=JSGNSConfig.from_yaml(d / "sgns_hs.yaml"),
                             matrices=jcov.CovisitationMatrices.load(d / "covisitation"),
                             artifact_dir=tmp_path / "jax", **kw)
    got = tts.run_two_stage(sp_t.train, sp_t.val_input, N_AIDS, labels=sp_t.val_labels,
                            sgns_config=SGNSConfig.from_yaml(d / "sgns_hs.yaml"),
                            matrices=CovisitationMatrices.load(d / "covisitation"),
                            artifact_dir=tmp_path / "port", device="cpu", **kw)
    np.testing.assert_array_equal(got.sgns.neighbor_table(k=10),
                                  want.sgns.neighbor_table(k=10))
    assert len(calls["port"]) == len(calls["jax"]) == 3
    for g, w in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(g["candidates"], w["candidates"])
    for t in EVENT_TYPES:
        assert np.isnan(got.rankers[t].prior_alpha)
        np.testing.assert_array_equal(got.predictions[t], want.predictions[t], err_msg=t)
    _same_report(got.report, want.report)
    assert (tmp_path / "port" / "sgns.npz").exists()
