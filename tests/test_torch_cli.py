"""The port's file CLI and the submission end of the main path against
``otto_tpu``, on the CPU: JSONL ingest (native and Python routes), the
chunked parquet writers, the submission writer (both routes), the file
ensemble, and ``pipelines.main`` end to end on a tiny parquet and a tiny
``.jsonl``.

Tolerances: parsed arrays, stores, blended lists and decompressed
submission text bit-equal; recall counts equal and recalls within 1e-6
(the same float32 sums in other orders).  The covisitation heuristic's
device recency route may swap two aids whose float64 scores lie within
1e-5 relative against JAX's (ROADMAP §3; ``test_torch_heuristic.py``
holds the route to that): its lists are bit-equal on the covisitation
route and equal up to such swaps on the recency route.  Sessions are at
most 32 events long, so the JAX package compiles one width bucket.
"""

import gzip
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from otto_tpu import EVENT_TYPES
from otto_tpu import pipelines as jpipe
from otto_tpu.data import ingest as jingest
from otto_tpu.data import submission as jsub
from otto_tpu.data import writers as jwriters
from otto_tpu.data.events import EventStore as JStore
from otto_tpu.data.splits import split_by_fraction as j_split_by_fraction
from otto_tpu.eval import oracle as orc
from otto_tpu.models import covisitation as jcov
from otto_tpu.models import ensemble as jens
from otto_tpu_torch import pipelines as tpipe
from otto_tpu_torch.data import ingest as tingest
from otto_tpu_torch.data import submission as tsub
from otto_tpu_torch.data import writers as twriters
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.splits import split_by_fraction, split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.models import ensemble as tens
from otto_tpu_torch.models.covisitation import session_unique_counts
from otto_tpu_torch.utils import native as tnative
from test_torch_heuristic import _assert_near_tie_swaps, _recency_scores

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "artifacts" / "bench_e2e"
N_AIDS = 500
TYPE_NAMES = ("clicks", "carts", "orders")


def _same_store(got, want):
    for f in ("session_ids", "offsets", "session_idx", "aid", "ts", "type"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def write_jsonl(store, path, seed: int = 0) -> None:
    """``store`` as a raw OTTO ``.jsonl``: timestamps in milliseconds (the
    store's seconds times 1000 plus a random 0-999), one line a session,
    keys in a random order and stray whitespace."""
    rng = np.random.default_rng(seed)
    ms = store.ts.astype(np.int64) * 1000 + rng.integers(0, 1000, store.n_events)
    with open(path, "w") as f:
        for s, sid in enumerate(store.session_ids):
            lo, hi = store.offsets[s], store.offsets[s + 1]
            events = [{"aid": int(a), "ts": int(t), "type": TYPE_NAMES[y]}
                      for a, t, y in zip(store.aid[lo:hi], ms[lo:hi], store.type[lo:hi])]
            if rng.random() < 0.3:
                events = [dict(reversed(list(e.items()))) for e in events]
                f.write(json.dumps({"events": events, "session": int(sid)}) + " \n")
            else:
                f.write(json.dumps({"session": int(sid), "events": events}) + "\n")


# ---------------------------------------------------------------- ingest
@pytest.fixture(scope="module")
def jsonl_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("jsonl")
    rows = [  # tests/test_ingest.py's file: an empty session is dropped
        {"session": 10, "events": [{"aid": 100, "ts": 1661724000123, "type": "clicks"},
                                   {"aid": 200, "ts": 1661724060456, "type": "carts"}]},
        {"session": 11, "events": [{"aid": 300, "ts": 1661724120789, "type": "orders"}]},
        {"session": 12, "events": []},
    ]
    (d / "basic.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    (d / "key_order.jsonl").write_text(
        '{"events": [{"ts": 5000, "type": "carts", "aid": 7}], "session": 3}\n')
    write_jsonl(synthetic_events_v2(n_sessions=300, n_aids=2000, max_length=32, seed=4),
                d / "synthetic.jsonl")
    return d


@pytest.mark.parametrize("name", ["basic", "key_order", "synthetic"])
@pytest.mark.parametrize("route", ["native", "python"])
def test_read_jsonl_equal_to_jax(jsonl_files, name, route):
    path = jsonl_files / f"{name}.jsonl"
    got = (tingest._parse_python if route == "python" else tingest._parse_native)(path)
    want = jingest._parse_python(path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    _same_store(tingest.read_jsonl(path, force_python=route == "python"),
                jingest.read_jsonl(path))


def test_empty_inputs_and_unreadable_file(tmp_path):
    """An empty ``.jsonl`` parses to an empty store, a submission of no
    sessions holds the header alone, and a missing file raises."""
    (tmp_path / "empty.jsonl").write_text("")
    for force_python in (False, True):
        assert tingest.read_jsonl(tmp_path / "empty.jsonl",
                                  force_python=force_python).n_events == 0
        out = tmp_path / f"empty_{force_python}.csv.gz"
        tsub.write_submission(out, np.zeros(0, np.int64),
                              {t: np.zeros((0, 20), np.int32) for t in EVENT_TYPES},
                              force_python=force_python)
        assert gzip.open(out, "rt").read() == "session_type,labels\n"
    with pytest.raises(OSError, match="missing.jsonl"):
        tingest.read_jsonl(tmp_path / "missing.jsonl")


@pytest.mark.parametrize("lib", ["jsonl", "submission"])
def test_failed_native_build_raises(tmp_path, monkeypatch, lib):
    """No quiet Python fallback: a build that cannot run raises and names the
    keyword that skips the library, and only that keyword does."""
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(tnative, "_loaded", {})
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative.subprocess, "run", no_compiler)
    path = tmp_path / "x.jsonl"
    path.write_text('{"session": 1, "events": [{"aid": 2, "ts": 3000, "type": "clicks"}]}\n')
    preds = {t: np.array([[5, -1]], np.int32) for t in EVENT_TYPES}
    if lib == "jsonl":
        with pytest.raises(RuntimeError, match=r"g\+\+.*force_python=True"):
            tingest.read_jsonl(path)
        assert tingest.read_jsonl(path, force_python=True).n_events == 1
    else:
        with pytest.raises(RuntimeError, match=r"g\+\+.*force_python=True"):
            tsub.write_submission(tmp_path / "s.csv.gz", [1], preds)
        tsub.write_submission(tmp_path / "s.csv.gz", [1], preds, force_python=True)
        assert tsub.read_submission(tmp_path / "s.csv.gz")["carts"] == {1: [5]}


# ----------------------------------------------------- writers, submission
def test_chunked_parquet_and_truncated_train_store_equal_to_jax(tmp_path):
    store = synthetic_events_v2(n_sessions=500, n_aids=800, max_length=32, seed=8)
    paths = twriters.write_chunked_parquet(store, tmp_path / "port", chunk_sessions=70)
    jpaths = jwriters.write_chunked_parquet(JStore.from_parquet(paths[0]), tmp_path / "jax",
                                            chunk_sessions=30)
    assert [p.name for p in paths] == [f"events_{i}.parquet" for i in range(8)]
    assert len(jpaths) == 3
    _same_store(twriters.read_chunked_parquet(tmp_path / "port"), store)
    _same_store(twriters.read_chunked_parquet(tmp_path / "port"),
                jwriters.read_chunked_parquet(tmp_path / "port"))
    _same_store(twriters.read_chunked_parquet(tmp_path / "jax"),
                jwriters.read_chunked_parquet(tmp_path / "jax"))
    cutoff = int(np.median(store.session_ids))
    for seed in (0, 42):
        _same_store(twriters.truncated_train_store(store, cutoff, seed=seed),
                    jwriters.truncated_train_store(jwriters.read_chunked_parquet(
                        tmp_path / "port"), cutoff, seed=seed))


@pytest.mark.parametrize("route", ["native", "python"])
def test_write_submission_text_equal_to_jax(tmp_path, route):
    rng = np.random.default_rng(0)
    S = 3000  # more than one writer thread's share of rows
    sids = np.arange(12899779, 12899779 + S, dtype=np.int64)
    preds = {t: np.where(rng.random((S, w)) < 0.15, -1, rng.integers(0, 1_855_604, (S, w)))
             .astype(np.int32) for t, w in zip(EVENT_TYPES, (20, 12, 20))}
    preds["orders"][:5] = -1  # empty lists
    tsub.write_submission(tmp_path / "port.csv.gz", sids, preds,
                          force_python=route == "python")
    jsub.write_submission(tmp_path / "jax.csv.gz", sids, preds)
    got = gzip.open(tmp_path / "port.csv.gz", "rt").read()
    assert got == gzip.open(tmp_path / "jax.csv.gz", "rt").read()
    assert got.count("\n") == 1 + 3 * S
    assert tsub.read_submission(tmp_path / "port.csv.gz") == \
        jsub.read_submission(tmp_path / "jax.csv.gz")


# -------------------------------------------------------------- ensemble
@pytest.fixture(scope="module")
def blend_setup(tmp_path_factory):
    """tests/test_ensemble_cli.py's setup: two models' prediction files per
    type (the port's runners on the CPU) and a manifest."""
    tmp = tmp_path_factory.mktemp("ens")
    store = synthetic_events_v2(n_sessions=2500, n_aids=800, n_clusters=30, seed=21)
    split = split_by_time(store, val_fraction=0.25, seed=1)
    runs = {"freq": tpipe.run_aid_frequency(split.train, split.val_input, 800, device="cpu"),
            "covisit": tpipe.run_covisit_heuristic(split.train, split.val_input, 800,
                                                   device="cpu")}
    manifest = {}
    for etype in EVENT_TYPES:
        manifest[etype] = {}
        for (name, res), w, ext in zip(runs.items(), (0.2, 0.8), (".npz", ".parquet")):
            p = res.predictions[etype]
            keep = np.ones(len(p), bool)
            keep[::7] = False  # sessions some model has no predictions for
            scores = np.where(p >= 0, np.arange(p.shape[1], 0, -1, dtype=np.float32), 0)
            mp = tens.candidate_set_predictions(p[keep], scores[keep],
                                                split.val_input.session_ids[keep])
            path = tmp / f"{name}_{etype}{ext}"
            tens.save_predictions(path, mp.session, mp.aid, mp.score)
            manifest[etype][name] = {"path": str(path), "weight": w}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    return split, manifest, tmp


def test_blend_files_and_align_equal_to_jax(blend_setup):
    split, manifest, _ = blend_setup
    got, want = tens.blend_files(manifest), jens.blend_files(manifest)
    sessions = np.concatenate([[0], split.val_input.session_ids, [10 ** 9]])
    for t in EVENT_TYPES:
        for g, w in zip(got[t], want[t]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tens.align_to_sessions(sessions, got[t]),
                                      jens.align_to_sessions(sessions, want[t]))
        preds = {n: tens.read_predictions(spec["path"]) for n, spec in manifest[t].items()}
        jpreds = {n: jens.read_predictions(spec["path"]) for n, spec in manifest[t].items()}
        weights = {n: spec["weight"] for n, spec in manifest[t].items()}
        for scale in (True, False):
            for g, w in zip(tens.blend(preds, weights, k=7, scale=scale),
                            jens.blend(jpreds, weights, k=7, scale=scale)):
                np.testing.assert_array_equal(g, w)


def _same_report(got, want):
    assert (got.clicks_n, got.carts_n, got.orders_n) == \
        (want.clicks_n, want.carts_n, want.orders_n)
    for f in ("clicks", "carts", "orders", "weighted", "corpus_weighted"):
        assert abs(getattr(got, f) - getattr(want, f)) <= 1e-6, f


@pytest.mark.parametrize("mode", ["validation", "submission"])
def test_run_ensemble_and_its_cli_equal_to_jax(blend_setup, tmp_path, mode):
    split, manifest, tmp = blend_setup
    if mode == "validation":
        got = tpipe.run_ensemble(manifest, split.val_labels, holdout_fraction=0.3, device="cpu")
        want = jpipe.run_ensemble(manifest, split.val_labels, holdout_fraction=0.3)
        _same_report(got.report, want.report)
    else:
        got, want = tpipe.run_ensemble(manifest, device="cpu"), jpipe.run_ensemble(manifest)
        args = ["ensemble", "submission", "--manifest", str(tmp / "manifest.json")]
        tpipe.main(args + ["--output", str(tmp_path / "port.csv.gz"), "--device", "cpu"])
        jpipe.main(args + ["--output", str(tmp_path / "jax.csv.gz")])
        assert gzip.open(tmp_path / "port.csv.gz", "rt").read() == \
            gzip.open(tmp_path / "jax.csv.gz", "rt").read()
    assert got.predictions.keys() == want.predictions.keys()
    for k in want.predictions:
        np.testing.assert_array_equal(got.predictions[k], want.predictions[k], err_msg=k)


# ------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A tiny store as parquet and as raw ``.jsonl`` (millisecond stamps);
    both read back equal to it."""
    d = tmp_path_factory.mktemp("cli")
    store = synthetic_events_v2(n_sessions=600, n_aids=N_AIDS, mean_length=10.0,
                                max_length=32, n_clusters=30, seed=5)
    store.to_parquet(d / "events.parquet")
    write_jsonl(store, d / "events.jsonl")
    _same_store(EventStore.from_parquet(d / "events.parquet"), store)
    _same_store(tingest.read_jsonl(d / "events.jsonl"), store)
    return d, store, {}


def _lists(sub: dict, session_ids) -> dict:
    """A read-back submission as [S, 20] arrays in ``session_ids``' order."""
    out = {}
    for t in EVENT_TYPES:
        out[t] = np.full((len(session_ids), 20), -1, np.int32)
        for i, s in enumerate(session_ids):
            out[t][i, :len(sub[t][int(s)])] = sub[t][int(s)]
    return out


@pytest.mark.parametrize("fmt", ["parquet", "jsonl"])
@pytest.mark.parametrize("mode", ["validation", "submission"])
@pytest.mark.parametrize("model", ["aid_frequency", "aid_weight", "covisitation"])
def test_main_equal_to_jax(cli_files, tmp_path, model, mode, fmt):
    d, store, jax_runs = cli_files
    args = [model, mode, "--n-aids", str(N_AIDS)]
    got = tpipe.main(args + ["--events", str(d / f"events.{fmt}"), "--device", "cpu",
                             "--output", str(tmp_path / "port.csv.gz")])
    if (model, mode) not in jax_runs:  # both files hold the same store: JAX runs once
        jout = d / f"{model}_{mode}.csv.gz"
        jax_runs[model, mode] = jpipe.main(args + ["--events", str(d / "events.parquet"),
                                                   "--output", str(jout)])
    want = jax_runs[model, mode]
    if mode == "validation":
        sp = split_by_fraction(store, val_fraction=0.1, seed=42)
        train, target = sp.train, sp.val_input
        _same_report(got.report, want.report)
    else:
        train = target = store
        assert got.report is None
        if model != "covisitation":  # (its near-tie swaps: below)
            assert tsub.read_submission(tmp_path / "port.csv.gz") == \
                jsub.read_submission(d / f"{model}_{mode}.csv.gz")
        for t, p in _lists(tsub.read_submission(tmp_path / "port.csv.gz"),
                           target.session_ids).items():
            np.testing.assert_array_equal(p, got.predictions[t][:, :20])
    if model != "covisitation":
        for t in EVENT_TYPES:
            np.testing.assert_array_equal(got.predictions[t], want.predictions[t])
        return
    recency = session_unique_counts(target) >= 20
    mats = jcov.build_covisitation(j_split_by_fraction(JStore.from_parquet(
        d / "events.parquet"), 0.1, 42).train if mode == "validation" else
        JStore.from_parquet(d / "events.parquet"), N_AIDS)
    tables = {k: orc.table_to_dict(mats.tables[k][0], 15) for k in mats.tables}
    aid_lists, type_lists = orc.store_to_lists(target)
    for t in EVENT_TYPES:
        g, w = got.predictions[t], want.predictions[t]
        np.testing.assert_array_equal(g[~recency], w[~recency])
        _assert_near_tie_swaps(g, w, set(np.flatnonzero(recency).tolist()),
                               lambda r: _recency_scores(aid_lists[r], type_lists[r], tables,
                                                         [], t))


def test_main_two_stage_equal_to_in_memory_calls(tmp_path):
    """``two_stage`` in both modes and ``two_stage_streamed`` in submission
    mode, each from its own copy of the committed artifacts, over the
    bench's 20,000 aids (sessions of at most 32 events): validation equals
    ``run_two_stage`` on the same split; submission (a separate
    ``--test-events`` file) equals ``predict_two_stage`` with the artifacts
    the resumed run saved, and streaming equals the streamed path with them
    (one shard; the aid features that the artifact directory holds)."""
    from otto_tpu_torch.config import GBDTConfig
    from otto_tpu_torch.streaming import run_two_stage_streamed
    from otto_tpu_torch.twostage import TwoStageArtifacts, predict_two_stage, run_two_stage

    store = synthetic_events_v2(n_sessions=200, n_aids=20_000, max_length=32, seed=2)
    test = synthetic_events_v2(n_sessions=60, n_aids=20_000, max_length=32, seed=3)
    store.to_parquet(tmp_path / "events.parquet")
    test.to_parquet(tmp_path / "test.parquet")
    common = ["--events", str(tmp_path / "events.parquet"), "--n-aids", "20000",
              "--val-fraction", "0.5", "--seed", "0", "--ranker", "gbdt", "--device", "cpu"]
    runs = {}
    for name, mode in (("two_stage", "validation"), ("two_stage", "submission"),
                       ("two_stage_streamed", "submission")):
        adir = tmp_path / f"{name}_{mode}"
        shutil.copytree(BENCH, adir)
        out = tmp_path / f"{name}_{mode}.csv.gz"
        extra = ["--test-events", str(tmp_path / "test.parquet")] if mode == "submission" else []
        runs[name, mode] = (tpipe.main([name, mode, *common, *extra, "--artifact-dir",
                                        str(adir), "--output", str(out)]), adir, out)
    got, adir, _ = runs["two_stage", "validation"]
    shutil.rmtree(adir)
    shutil.copytree(BENCH, adir)
    sp = split_by_fraction(store, val_fraction=0.5, seed=0)
    want = run_two_stage(sp.train, sp.val_input, 20_000, labels=sp.val_labels,
                         ranker_config=GBDTConfig(), artifact_dir=adir, device="cpu")
    _same_report(got.report, want.report)
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(got.predictions[t], want.predictions[t])
    art = TwoStageArtifacts.load(runs["two_stage", "submission"][1], device="cpu")
    want = predict_two_stage(art, store, test, 20_000, device="cpu")
    streamed = run_two_stage_streamed(store, test, 20_000, artifacts=art, n_boot=0,
                                      artifact_dir=runs["two_stage_streamed", "submission"][1],
                                      device="cpu").predictions
    for (name, mode), preds in ((("two_stage", "submission"), want),
                                (("two_stage_streamed", "submission"), streamed)):
        got, _, out = runs[name, mode]
        assert got.report is None
        lists = _lists(tsub.read_submission(out), test.session_ids)
        for t in EVENT_TYPES:
            np.testing.assert_array_equal(got.predictions[t], preds[t], err_msg=name)
            np.testing.assert_array_equal(lists[t], preds[t], err_msg=name)


TINY_SEQUENCE = ("architecture: gru\ndim: 8\nhidden: 8\nmax_len: 5\nbatch_size: 256\n"
                 "epochs: 1\nn_negatives: 8\n")


@pytest.mark.parametrize("mode", ["validation", "submission"])
def test_main_serves_sequence(cli_files, tmp_path, mode):
    """What raised before the sequence models were ported: ``sequence``
    trains the encoder of ``--config`` (a ``SequenceModelConfig`` YAML) in
    both modes.  The report, or the submission file, equals
    ``run_sequence`` on the same split (the same CPU arithmetic: equal)."""
    d, store, _ = cli_files
    cfg = tmp_path / "sequence.yaml"
    cfg.write_text(TINY_SEQUENCE)
    out = tmp_path / "sub.csv.gz"
    got = tpipe.main(["sequence", mode, "--events", str(d / "events.parquet"), "--n-aids",
                      str(N_AIDS), "--config", str(cfg), "--output", str(out),
                      "--device", "cpu"])
    if mode == "validation":
        sp = split_by_fraction(store, val_fraction=0.1, seed=42)
        want = tpipe.run_sequence(sp.train, sp.val_input, N_AIDS, sp.val_labels,
                                  config_path=str(cfg), device="cpu")
        assert got.report == want.report and 0 < got.report.weighted < 1
    else:
        want = tpipe.run_sequence(store, store, N_AIDS, None, config_path=str(cfg),
                                  device="cpu")
        assert got.report is None
        lists = _lists(tsub.read_submission(out), store.session_ids)
        for t in EVENT_TYPES:
            np.testing.assert_array_equal(lists[t], want.predictions[t], err_msg=t)
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(got.predictions[t], want.predictions[t], err_msg=t)


TINY_TOWER = "hidden_dims: [16, 8]\nn_folds: 2\nepochs: 1\ndropout: 0.0\n"


@pytest.mark.parametrize("argv", [
    ["two_stage", "validation", "--ranker", "tower"],
    ["two_stage_streamed", "submission"],
    ["two_stage_streamed", "validation", "--ranker", "tower"],
    ["two_stage", "submission"],
    ["tfidf", "validation"],
], ids=["two_stage_validation", "two_stage_streamed_submission",
        "two_stage_streamed_validation", "two_stage_submission", "tfidf_validation"])
def test_main_serves_the_tower_and_tfidf(cli_files, tmp_path, argv):
    """What raised before the tower and TF-IDF were ported: ``--ranker
    tower`` (the default) trains the towers of ``--config`` (a
    ``RankerConfig`` YAML) in both modes of ``two_stage`` and
    ``two_stage_streamed``; ``tfidf`` serves.  Validation reports equal the
    in-memory calls on the same split (the same CPU arithmetic: equal); a
    submission file holds the returned lists."""
    from otto_tpu_torch.config import RankerConfig
    from otto_tpu_torch.twostage import run_two_stage

    d, store, _ = cli_files
    cfg = tmp_path / "tower.yaml"
    cfg.write_text(TINY_TOWER)
    out = tmp_path / "sub.csv.gz"
    extra = ["--train-sessions", "30"] if argv[0] == "two_stage_streamed" else []
    got = tpipe.main(argv + ["--events", str(d / "events.parquet"), "--n-aids", str(N_AIDS),
                             "--config", str(cfg), "--output", str(out), "--device", "cpu",
                             *extra])
    sp = split_by_fraction(store, val_fraction=0.1, seed=42)
    if argv[1] == "submission":
        assert got.report is None
        lists = _lists(tsub.read_submission(out), store.session_ids)
        for t in EVENT_TYPES:
            np.testing.assert_array_equal(lists[t], got.predictions[t][:, :20], err_msg=t)
        return
    if argv[0] == "two_stage_streamed":
        n_stream = sp.val_input.n_sessions - 30
        assert all(got.predictions[t].shape == (n_stream, 20) for t in EVENT_TYPES)
        assert 0 < got.report.weighted <= 1
        return
    if argv[0] == "tfidf":
        want = tpipe.run_tfidf(sp.train, sp.val_input, N_AIDS, sp.val_labels, device="cpu")
    else:
        want = run_two_stage(sp.train, sp.val_input, N_AIDS, labels=sp.val_labels,
                             ranker_config=RankerConfig.from_yaml(cfg), device="cpu")
    assert got.report == want.report and 0 < got.report.weighted <= 1
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(got.predictions[t], want.predictions[t], err_msg=t)


@pytest.mark.parametrize("mode", ["validation", "submission"])
@pytest.mark.parametrize("model", ["embedding_knn", "doc2vec"])
def test_main_serves_sgns_models(cli_files, tmp_path, model, mode):
    """``embedding_knn`` and ``doc2vec`` train SGNS with ``--config`` (an
    ``SGNSConfig`` YAML): the report, or the submission file, equals the
    runner's on the same split (the same CPU arithmetic: equal)."""
    from otto_tpu_torch.config import SGNSConfig

    d, store, _ = cli_files
    cfg = tmp_path / "sgns.yaml"
    cfg.write_text("dim: 16\nwindow: 4\nnegatives: 5\nepochs: 1\nbatch_centers: 1024\n")
    out = tmp_path / "sub.csv.gz"
    got = tpipe.main([model, mode, "--events", str(d / "events.parquet"), "--n-aids",
                      str(N_AIDS), "--config", str(cfg), "--output", str(out),
                      "--device", "cpu"])
    assert SGNSConfig.from_yaml(cfg).epochs == 1
    runner = tpipe.MODEL_RUNNERS[model]
    if mode == "validation":
        sp = split_by_fraction(store, val_fraction=0.1, seed=42)
        want = runner(sp.train, sp.val_input, N_AIDS, sp.val_labels, config_path=str(cfg),
                      device="cpu")
        assert got.report == want.report and 0 < got.report.weighted < 1
    else:
        want = runner(store, store, N_AIDS, None, config_path=str(cfg), device="cpu")
        assert got.report is None
        lists = _lists(tsub.read_submission(out), store.session_ids)
        for t in EVENT_TYPES:
            np.testing.assert_array_equal(lists[t], want.predictions[t], err_msg=t)
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(got.predictions[t], want.predictions[t], err_msg=t)


def test_main_device_defaults_to_cuda_and_never_falls_back(cli_files, monkeypatch):
    d, _, _ = cli_files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tpipe.main(["aid_weight", "validation", "--events", str(d / "events.parquet")])
