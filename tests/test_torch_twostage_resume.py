"""The port's ``run_two_stage`` (its resume branch) against ``otto_tpu``'s,
on the CPU.

Both packages resume from their own copy of ``artifacts/bench_e2e`` (the
committed covisitation tables and GBDT fold models; ``run_two_stage`` saves
back into its ``artifact_dir``, so never into the committed one) and score
the same labeled sessions of the bench's data (``bench_fit.json``:
``synthetic_events_v2`` then ``split_by_time``): the first 300 target
sessions of at most 32 events, with the first 3,000 training sessions as
``train``.  The heuristic runs on the host routes (both packages pick them
on a CPU).  Two cases of the stored ``prior_alpha``: the committed ``inf``
of every type (the ranker alone), and the copies' clicks set to 0.5
(``prior + 0.5 * ranker``) and carts and orders to NaN (the alpha is
selected over ``PRIOR_ALPHAS`` on the selection sessions and stored).

Tolerances: the widened candidate grids, their labels, the top-20 lists,
the selected alpha, the saved ``meta.json`` and ``predictions.npz``
bit-equal (the grids, features and forest scores are bit-equal,
tests/test_torch_{candidates,features,gbdt_predict}.py, and the blend is the
same numpy); recall counts equal and recalls to 6 decimals.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from otto_tpu import EVENT_TYPES
from otto_tpu import twostage as jts
from otto_tpu.data.splits import split_by_time as j_split_by_time
from otto_tpu.data.synthetic import synthetic_events_v2 as j_synth_v2
from otto_tpu.models.candidates import CandidateSet as JCandidateSet
from otto_tpu.models.gbdt import GBDTConfig as JGBDTConfig
from otto_tpu_torch import twostage as tts
from otto_tpu_torch.config import GBDTConfig, RankerConfig
from otto_tpu_torch.data.splits import split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.models.candidates import CandidateSet
from otto_tpu_torch.models.gbdt import GBDTRankerModel, load_ranker_model
from otto_tpu_torch.models.ranker import RankerModel

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "artifacts" / "bench_e2e"
CHUNK = 64


def _cut(split, n_train: int, n_target: int):
    """The first ``n_train`` training sessions, and the first ``n_target``
    target sessions of at most 32 events with their labels."""
    keep = np.zeros(split.train.n_sessions, bool)
    keep[:n_train] = True
    train = split.train.select_sessions(keep)
    idx = np.flatnonzero(split.val_input.lengths <= 32)[:n_target]
    keep = np.zeros(split.val_input.n_sessions, bool)
    keep[idx] = True
    return train, split.val_input.select_sessions(keep), split.val_labels.take(idx)


@pytest.fixture(scope="module")
def data():
    fit = json.loads((BENCH / "bench_fit.json").read_text())
    kw = dict(n_sessions=fit["sessions"], n_aids=fit["aids"], seed=fit["seed"])
    j = _cut(j_split_by_time(j_synth_v2(**kw), val_fraction=fit["val_fraction"],
                             seed=fit["seed"]), 3000, 300)
    t = _cut(split_by_time(synthetic_events_v2(**kw), val_fraction=fit["val_fraction"],
                           seed=fit["seed"]), 3000, 300)
    np.testing.assert_array_equal(t[1].aid, j[1].aid)
    return fit["aids"], j, t


def _copy_bench(dst: Path, alphas: dict[str, float]) -> Path:
    """A copy of the committed artifacts, the stored ``__prior_alpha`` of
    the rankers named in ``alphas`` set to their value."""
    shutil.copytree(BENCH, dst)
    for t, alpha in alphas.items():
        path = dst / f"ranker_{t}.npz"
        with np.load(path, allow_pickle=True) as z:
            arrays = {k: z[k] for k in z.files}
        arrays["__prior_alpha"] = np.float64(alpha)
        np.savez_compressed(path, **arrays)
    return dst


def _stored_alpha(directory: Path, etype: str) -> float:
    with np.load(directory / f"ranker_{etype}.npz", allow_pickle=True) as z:
        return float(z["__prior_alpha"])


def _same_report(got, want):
    assert (got.clicks_n, got.carts_n, got.orders_n) == \
        (want.clicks_n, want.carts_n, want.orders_n)
    for f in ("clicks", "carts", "orders", "weighted", "corpus_weighted"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), abs=1e-6), f


@pytest.mark.parametrize("alphas", [{}, {"clicks": 0.5, "carts": np.nan, "orders": np.nan}],
                         ids=["inf", "finite_and_nan"])
def test_resumed_run_two_stage_equal_to_jax(data, tmp_path, alphas):
    n_aids, (j_train, j_target, j_labels), (t_train, t_target, t_labels) = data
    jdir = _copy_bench(tmp_path / "jax", alphas)
    tdir = _copy_bench(tmp_path / "port", alphas)
    want = jts.run_two_stage(j_train, j_target, n_aids, labels=j_labels,
                             ranker_config=JGBDTConfig(), artifact_dir=jdir,
                             chunk_sessions=CHUNK)
    stats = {}
    got = tts.run_two_stage(t_train, t_target, n_aids, labels=t_labels, artifact_dir=tdir,
                            chunk_sessions=CHUNK, stats_out=stats, device="cpu")

    for t in EVENT_TYPES:
        np.testing.assert_array_equal(got.candidates.candidates[t],
                                      want.candidates.candidates[t], err_msg=t)
        np.testing.assert_array_equal(got.candidates.labels[t], want.candidates.labels[t],
                                      err_msg=t)
        assert got.predictions[t].dtype == np.int32
        np.testing.assert_array_equal(got.predictions[t], want.predictions[t], err_msg=t)
        a, b = _stored_alpha(tdir, t), _stored_alpha(jdir, t)
        assert a == b or (np.isnan(a) and np.isnan(b)), (t, a, b)
        assert not np.isnan(a)  # a NaN alpha is selected and stored
        assert a == alphas.get(t, np.inf) or np.isnan(alphas[t])
    np.testing.assert_array_equal(got.selection_mask, want.selection_mask)
    _same_report(got.report, want.report)
    _same_report(got.report_disjoint, want.report_disjoint)
    for k, v in want.max_recall.items():
        assert got.max_recall[k] == pytest.approx(v, abs=1e-6), k
    assert json.loads((tdir / "meta.json").read_text()) == \
        json.loads((jdir / "meta.json").read_text())
    with np.load(tdir / "predictions.npz") as g, np.load(jdir / "predictions.npz") as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert stats["forest_s"] > 0 and stats["covisit_s"] >= 0


def test_union_relabels_widened_grid_and_prior_blend_selects_alpha_as_jax():
    """``_union_heuristic`` with labels relabels the widened grid, and
    ``_prior_blend`` with ``_recall_eval_fn`` picks the same alpha and scores
    as the JAX package's, on random grids with ties in the ranker scores."""
    from otto_tpu.data.labels import SessionLabels as JLabels
    from otto_tpu_torch.data.labels import SessionLabels

    rng = np.random.default_rng(7)
    S, C, n_aids = 120, 30, 60
    cands = {t: np.stack([rng.permutation(n_aids)[:C] for _ in range(S)]).astype(np.int32)
             for t in EVENT_TYPES}
    for c in cands.values():
        c[rng.random((S, C)) < 0.2] = -1
    scores = {t: rng.random((S, C)).astype(np.float32) for t in EVENT_TYPES}
    heur = {t: np.where(rng.random((S, 20)) < 0.1, -1,
                        np.stack([rng.permutation(n_aids)[:20] for _ in range(S)]))
            .astype(np.int32) for t in EVENT_TYPES}
    n_cart, n_order = rng.integers(0, 4, S), rng.integers(0, 3, S)
    lab = dict(session_ids=np.arange(S, dtype=np.int64),
               click=np.where(rng.random(S) < 0.8, rng.integers(0, n_aids, S), -1)
               .astype(np.int32),
               cart_flat=rng.integers(0, n_aids, n_cart.sum()).astype(np.int32),
               cart_offsets=np.concatenate([[0], np.cumsum(n_cart)]),
               order_flat=rng.integers(0, n_aids, n_order.sum()).astype(np.int32),
               order_offsets=np.concatenate([[0], np.cumsum(n_order)]))
    jl, tl = JLabels(**lab), SessionLabels(**lab)

    def copy(cls):
        return cls(np.arange(S), {t: c.copy() for t, c in cands.items()},
                   {t: s.copy() for t, s in scores.items()}, None)

    jc, tc = copy(JCandidateSet), copy(CandidateSet)
    want_rank = jts._union_heuristic(jc, heur, jl)
    got_rank = tts._union_heuristic(tc, heur, tl, torch.device("cpu"))
    sel = rng.random(S) < 0.5
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(tc.candidates[t], jc.candidates[t])
        np.testing.assert_array_equal(tc.labels[t], jc.labels[t])
        np.testing.assert_array_equal(got_rank[t], want_rank[t])
        c = tc.candidates[t]
        ranker = np.round(rng.normal(size=c.shape), 1).astype(np.float32)  # ties
        ranker[c < 0] = -np.inf
        evals = []
        for pkg, labels, kw in ((jts, jl, {}), (tts, tl, {"device": "cpu"})):
            raw = pkg._recall_eval_fn(labels, c, t, **kw)
            evals.append(lambda i, s, _raw=raw: _raw(i[sel[i]], s[sel[i]]))
        want_s, want_a = jts._prior_blend(c, ranker, evals[0], heur_rank=want_rank[t])
        got_s, got_a = tts._prior_blend(c, ranker, evals[1], heur_rank=got_rank[t])
        assert got_a == want_a, t
        np.testing.assert_array_equal(got_s, want_s)
    assert tts.PRIOR_ALPHAS == jts.PRIOR_ALPHAS


TINY_TOWER = RankerConfig(hidden_dims=(16, 8), n_folds=2, epochs=1, dropout=0.0)


@pytest.mark.parametrize("case", ["no_artifact_dir", "missing_ranker", "second_ranker",
                                  "no_labels"])
def test_what_would_train_raises_and_names_its_item(data, tmp_path, case):
    """What raised before the tower was ported now trains: a tower config
    with no artifacts; the types a directory lacks (the one it holds, a
    GBDT, resumes by its marker); a GBDT paired with a tower through
    ``second_ranker_config``.  Without labels ``run_two_stage`` still raises
    ``ValueError``, as in the reference."""
    n_aids, _, (train, target, labels) = data
    rankers = ["clicks"] if case == "missing_ranker" else list(EVENT_TYPES)
    tmp_path.joinpath("art").mkdir()
    for t in rankers:  # the rankers alone: nothing that could be written over
        shutil.copy(BENCH / f"ranker_{t}.npz", tmp_path / "art")
    kw = dict(labels=labels, artifact_dir=tmp_path / "art", ranker_config=TINY_TOWER,
              chunk_sessions=CHUNK, device="cpu")
    if case == "no_labels":
        kw["labels"] = None
        with pytest.raises(ValueError, match="predict_two_stage"):
            tts.run_two_stage(train, target, n_aids, **kw)
        return
    if case == "no_artifact_dir":
        kw["artifact_dir"] = None
        engines = dict.fromkeys(EVENT_TYPES, RankerModel)
    elif case == "missing_ranker":
        engines = {"clicks": GBDTRankerModel, "carts": RankerModel, "orders": RankerModel}
    else:
        kw["artifact_dir"] = None
        kw["ranker_config"] = GBDTConfig(n_trees=3, n_folds=2, min_data_in_leaf=50)
        kw["second_ranker_config"] = TINY_TOWER
        engines = {**dict.fromkeys(EVENT_TYPES, GBDTRankerModel),
                   **{f"{t}_b": RankerModel for t in EVENT_TYPES}}
    art = tts.run_two_stage(train, target, n_aids, **kw)
    assert {k: type(v) for k, v in art.rankers.items()} == engines
    assert 0 < art.report.weighted <= 1 and 0 < art.report_disjoint.weighted <= 1
    for t in EVENT_TYPES:
        assert art.predictions[t].shape == (target.n_sessions, 20)
    if case == "missing_ranker":
        for t in ("carts", "orders"):
            saved = load_ranker_model(tmp_path / "art" / f"ranker_{t}.npz", TINY_TOWER)
            assert isinstance(saved, RankerModel) and saved.config == TINY_TOWER
            assert not np.isnan(saved.prior_alpha)
