"""The port's candidate generators against ``otto_tpu``, on the CPU.

Same seeded store, covisitation tables (built by ``otto_tpu``) and kNN table
through both packages.  Sessions are at most 32 events long, so the JAX
package serves them in one width bucket (one XLA compile a program).

Tolerances: candidate grids and labels bit-equal everywhere.  Regular,
covisitation and kNN scores bit-equal (history ranks, vote counts, the
table's own values).  The recency generator's scores are float32 sums of
the same positive recency weights, which XLA's dot and the port's einsum
(the session-vote twin) add in other orders: they agree within (n - 1) *
2^-24 of the score for n <= 32 summed events (ROADMAP §3).
"""

import numpy as np
import pytest
import torch

from otto_tpu import EVENT_TYPES
from otto_tpu.config import CovisitConfig as JCovisitConfig
from otto_tpu.data.splits import split_by_time as j_split_by_time
from otto_tpu.data.synthetic import synthetic_events_v2 as j_synth_v2
from otto_tpu.models import candidates as jc
from otto_tpu.models.covisitation import build_covisitation as j_build
from otto_tpu_torch.data.splits import split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.models import candidates as tc
from otto_tpu_torch.models.covisitation import CovisitationMatrices

torch.set_num_threads(1)

N_AIDS = 600
CHUNK = 64


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_sessions=400, n_aids=N_AIDS, mean_length=12.0, max_length=32, n_clusters=30,
              seed=21)
    jsp = j_split_by_time(j_synth_v2(**kw), val_fraction=0.5, seed=0)
    tsp = split_by_time(synthetic_events_v2(**kw), val_fraction=0.5, seed=0)
    jm = j_build(jsp.train, N_AIDS, JCovisitConfig(top_k_wide=20), chunk_sessions=256)
    tm = CovisitationMatrices({k: (np.asarray(a), np.asarray(w))
                               for k, (a, w) in jm.tables.items()}, N_AIDS)
    rng = np.random.default_rng(2)
    ft = rng.integers(0, N_AIDS, (N_AIDS, 20)).astype(np.int32)
    ft_scores = rng.random((N_AIDS, 20)).astype(np.float32)
    return jsp, tsp, jm, tm, ft, ft_scores


def _same_sets(got, want):
    np.testing.assert_array_equal(got.session_ids, want.session_ids)
    for t in EVENT_TYPES:
        assert got.candidates[t].dtype == np.int32 and got.scores[t].dtype == np.float32
        np.testing.assert_array_equal(got.candidates[t], want.candidates[t], err_msg=t)
        np.testing.assert_array_equal(got.scores[t].view(np.int32),
                                      np.asarray(want.scores[t], np.float32).view(np.int32),
                                      err_msg=t)
        if want.labels is None:
            assert got.labels is None
        else:
            assert got.labels[t].dtype == np.int8
            np.testing.assert_array_equal(got.labels[t], want.labels[t], err_msg=t)


@pytest.mark.parametrize("with_ft", [False, True])
def test_regular_candidates_equal(setup, with_ft):
    jsp, tsp, jm, tm, ft, _ = setup
    kw = dict(uniq_cap=64, wide_k=20, k_covisit=100, chunk_sessions=CHUNK)
    want = jc.regular_candidates(jsp.val_input, jm, ft_neighbors=ft if with_ft else None,
                                 labels=jsp.val_labels, **kw)
    got = tc.regular_candidates(tsp.val_input, tm, ft_neighbors=ft if with_ft else None,
                                labels=tsp.val_labels, device="cpu", **kw)
    _same_sets(got, want)
    assert got.width("clicks") == 164
    rep_j, rep_t = want.max_recall_report(jsp.val_labels), got.max_recall_report(
        tsp.val_labels, device="cpu")
    assert rep_t.keys() == rep_j.keys()
    for k in rep_j:
        assert rep_t[k] == pytest.approx(rep_j[k], rel=1e-6, abs=1e-7), k
    for t in EVENT_TYPES:
        for a, b in zip(got.flatten(t), want.flatten(t)):
            np.testing.assert_array_equal(a, b)


def test_covisit_candidates_equal(setup):
    jsp, tsp, jm, tm, _, _ = setup
    _same_sets(tc.covisit_candidates(tsp.val_input, tm, labels=tsp.val_labels,
                                     chunk_sessions=CHUNK, device="cpu"),
               jc.covisit_candidates(jsp.val_input, jm, labels=jsp.val_labels,
                                     chunk_sessions=CHUNK))


def test_recency_candidates_equal(setup):
    jsp, tsp, _, _, _, _ = setup
    got = tc.recency_candidates(tsp.val_input, labels=tsp.val_labels, chunk_sessions=CHUNK,
                                device="cpu")
    want = jc.recency_candidates(jsp.val_input, labels=jsp.val_labels, chunk_sessions=CHUNK)
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(got.candidates[t], want.candidates[t], err_msg=t)
        np.testing.assert_array_equal(got.labels[t], want.labels[t], err_msg=t)
        w = np.asarray(want.scores[t])
        assert got.scores[t].dtype == np.float32 and (w >= 0).all()
        np.testing.assert_array_less(np.abs(got.scores[t] - w), 31 * 2.0**-24 * w + 1e-30,
                                     err_msg=t)


def test_embedding_candidates_and_label_dict_equal(setup):
    jsp, tsp, _, _, ft, ft_scores = setup
    _same_sets(tc.embedding_candidates(tsp.val_input, ft, ft_scores, labels=tsp.val_labels,
                                       device="cpu"),
               jc.embedding_candidates(jsp.val_input, ft, ft_scores, labels=jsp.val_labels))
    rng = np.random.default_rng(4)
    S = jsp.val_input.n_sessions
    grid = {t: rng.integers(-1, N_AIDS, (S, 37)).astype(np.int32) for t in EVENT_TYPES}
    want = jc._label_dict(grid, jsp.val_labels)
    got = tc._label_dict(grid, tsp.val_labels, device="cpu")
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(got[t], want[t])


def test_sharded_serving_is_not_ported(setup):
    _, tsp, _, tm, _, _ = setup
    with pytest.raises(TypeError, match="DeviceMesh"):
        tc.regular_candidates(tsp.val_input, tm, mesh=object(), device="cpu")
