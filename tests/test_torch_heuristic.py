"""The port's frequency statistics, baselines, covisitation heuristic and
pipeline runners against ``otto_tpu``, and against its brute-force oracle
(``otto_tpu/eval/oracle.py``, duck-typed on the event store).

Same seeded numpy inputs through both packages, on the CPU.  The heuristic
runs on covisitation tables built by ``otto_tpu`` (the build's own parity is
``tests/test_torch_covisit.py``).

Tolerances:
- frequency statistics (many tied counts), prediction lists of every
  baseline, of the covisitation route and of the host routes, with and
  without the kNN list: bit-equal;
- the device recency route against JAX's: the float32 per-aid sums run in
  another order (the port's run totals against XLA's scan tree), so two
  aids whose float64 scores lie within 1e-5 relative may swap.  Rows that
  differ must be rare, and at every differing position the two aids'
  scores must be such a near-tie;
- the host routes against the oracle (``Counter`` semantics, float64):
  bit-equal lists;
- the device covisitation route against the host one: bit-equal (unit votes);
- recall reports: the counts equal, the recalls within 1e-6.

Both packages serve in chunks of ``CHUNK`` sessions (the results do not
depend on the chunk size).  The sessions are at most 32 events long, so the
JAX package serves them in one width bucket: with the small chunk this keeps
XLA's compile on the CPU short.
"""

import functools
from collections import Counter

import numpy as np
import pytest
import torch

from otto_tpu import EVENT_TYPES
from otto_tpu import pipelines as jpipe
from otto_tpu.data.splits import split_by_time as j_split_by_time
from otto_tpu.data.synthetic import synthetic_events_v2 as j_synth_v2
from otto_tpu.eval import oracle as orc
from otto_tpu.models import covisitation as jcov
from otto_tpu.models import frequency as jfreq
from otto_tpu.models import recency as jrec
from otto_tpu_torch import pipelines as tpipe
from otto_tpu_torch.data.splits import split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.models import covisitation as tcov
from otto_tpu_torch.models import frequency as tfreq
from otto_tpu_torch.models import recency as trec

torch.set_num_threads(1)

N_AIDS = 700
CHUNK = 32


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_sessions=1500, n_aids=N_AIDS, mean_length=16.0, max_length=32, n_clusters=40,
              seed=11)
    sp_j = j_split_by_time(j_synth_v2(**kw), val_fraction=0.25, seed=3)
    sp_t = split_by_time(synthetic_events_v2(**kw), val_fraction=0.25, seed=3)
    np.testing.assert_array_equal(sp_t.val_input.aid, sp_j.val_input.aid)
    mats_j = jcov.build_covisitation(sp_j.train, N_AIDS, chunk_sessions=CHUNK)
    mats_t = tcov.CovisitationMatrices(mats_j.tables, N_AIDS)
    stats_j = jfreq.FrequencyStatistics.compute(sp_j.train, n_aids=N_AIDS)
    rng = np.random.default_rng(5)
    ft = np.argsort(rng.random((N_AIDS, N_AIDS)), axis=1)[:, :21].astype(np.int32)
    ft = np.stack([row[row != a][:20] for a, row in enumerate(ft)])  # no self
    ft[rng.random(N_AIDS) < 0.1, 15:] = -1  # some short rows
    counts = tcov.session_unique_counts(sp_t.val_input)
    assert (counts >= 20).sum() >= 5 and (counts < 20).sum() >= 100  # both routes run
    return dict(sp_j=sp_j, sp_t=sp_t, mats_j=mats_j, mats_t=mats_t, stats_j=stats_j, ft=ft,
                counts=counts)


def _stats_top(stats):
    return {t: stats.top_by_type[t] for t in EVENT_TYPES}


def _recency_scores(aids, types, tables, similar, etype):
    """float64 Counter of one recency-route session (the oracle's sums)."""
    lo = 0.1 if etype == "clicks" else 0.5
    w = np.logspace(lo, 1, len(aids), base=2, endpoint=True) - 1
    c = Counter()
    for a, t, x in zip(aids, types, w):
        c[a] += x * orc.EVENT_TYPE_COEFFICIENT[t]
    for a in similar:
        c[a] += 0.15 if etype == "orders" else 0.05
    keep, kind = {"clicks": ((0,), "time_weighted"), "carts": ((0, 1), "cart_weighted"),
                  "orders": ((1, 2), "cart_order")}[etype]
    for q in sorted({a for a, t in zip(aids, types) if t in keep}):
        for a in tables[kind].get(q, []):
            c[a] += 0.15 if etype == "orders" else 0.05
    return c


def _assert_near_tie_swaps(got, want, rows, scores_of):
    """Rows of ``got`` and ``want`` differ only where two aids' float64
    scores lie within 1e-5 relative; such rows are at most 2."""
    bad = np.flatnonzero((got != want).any(axis=1))
    assert len(bad) <= 2, bad
    for r in bad:
        assert r in rows, r
        c = scores_of(r)
        for a, b in zip(got[r][got[r] != want[r]], want[r][got[r] != want[r]]):
            assert abs(c[int(a)] - c[int(b)]) <= 1e-5 * max(c[int(a)], c[int(b)]), (r, a, b)


def test_frequency_statistics_match_jax_ties_included(setup, tmp_path):
    sp_t, stats_j = setup["sp_t"], setup["stats_j"]
    stats_t = tfreq.FrequencyStatistics.compute(sp_t.train, n_aids=N_AIDS, device="cpu")
    assert stats_t.top_all.dtype == np.int32
    np.testing.assert_array_equal(stats_t.top_all, stats_j.top_all)
    np.testing.assert_array_equal(stats_t.counts_all, stats_j.counts_all)
    ties = 0
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(stats_t.top_by_type[t], stats_j.top_by_type[t])
        np.testing.assert_array_equal(stats_t.counts_by_type[t], stats_j.counts_by_type[t])
        ties += int((np.diff(stats_t.counts_by_type[t]) == 0).sum())
    assert ties >= 5  # ties break toward the lower aid, as jax.lax.top_k's
    np.testing.assert_array_equal(
        tfreq.aid_counts(torch.from_numpy(sp_t.train.aid), N_AIDS).numpy(),
        np.bincount(sp_t.train.aid, minlength=N_AIDS).astype(np.float32))

    stats_t.save(tmp_path / "t")
    back = jfreq.FrequencyStatistics.load(tmp_path / "t")
    stats_j.save(tmp_path / "j")
    loaded = tfreq.FrequencyStatistics.load(tmp_path / "j")
    for a, b in ((back, stats_t), (loaded, stats_j)):
        np.testing.assert_array_equal(a.top_all, b.top_all)
        for t in EVENT_TYPES:
            np.testing.assert_array_equal(a.top_by_type[t], b.top_by_type[t])
            np.testing.assert_array_equal(a.counts_by_type[t], b.counts_by_type[t])


def test_baseline_predictions_match_jax(setup):
    sp_j, sp_t, stats_j = setup["sp_j"], setup["sp_t"], setup["stats_j"]
    pj, pt = jpipe._packed(sp_j.val_input), tpipe._packed(sp_t.val_input)
    stats_t = tfreq.FrequencyStatistics.compute(sp_t.train, n_aids=N_AIDS, device="cpu")
    jf = jfreq.aid_frequency_predictions(pj, stats_j)
    tf = tfreq.aid_frequency_predictions(pt, stats_t, device="cpu")
    for coeffs in (trec.VALIDATION_COEFFICIENTS, trec.SUBMISSION_COEFFICIENTS):
        jw = jrec.aid_weight_predictions(pj, coefficients=coeffs)
        tw = trec.aid_weight_predictions(pt, coefficients=coeffs, device="cpu")
        for t in EVENT_TYPES:
            np.testing.assert_array_equal(tw[t], jw[t])
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(tf[t], jf[t])
        assert tf[t].shape == (sp_t.val_input.n_sessions, 20) and (tf[t] >= 0).all()


@pytest.mark.parametrize("with_ft", [False, True])
def test_heuristic_routes_match_jax_and_oracle(setup, with_ft):
    sp_j, sp_t, stats_j = setup["sp_j"], setup["sp_t"], setup["stats_j"]
    ft = setup["ft"] if with_ft else None
    top = _stats_top(stats_j)
    dev_t = tcov.covisit_heuristic_predictions(sp_t.val_input, setup["mats_t"], top,
                                               ft_neighbors=ft, chunk_sessions=CHUNK,
                                               device="cpu")
    dev_j = jcov.covisit_heuristic_predictions(sp_j.val_input, setup["mats_j"], top,
                                               ft_neighbors=ft, chunk_sessions=CHUNK)
    host_t = tcov.covisit_heuristic_predictions(sp_t.val_input, setup["mats_t"], top,
                                                ft_neighbors=ft, recency_host_f64=True,
                                                covisit_host=True, device="cpu")
    host_j = jcov.covisit_heuristic_predictions(sp_j.val_input, setup["mats_j"], top,
                                                ft_neighbors=ft, recency_host_f64=True,
                                                covisit_host=True)

    aid_lists, type_lists = orc.store_to_lists(sp_t.val_input)
    tables = {k: orc.table_to_dict(setup["mats_t"].tables[k][0], 15)
              for k in setup["mats_t"].tables}
    freq = {t: [int(a) for a in top[t]] for t in EVENT_TYPES}
    oracle = orc.oracle_heuristic(aid_lists, type_lists, tables, freq,
                                   orc.neighbor_lists(ft) if with_ft else None)
    cov = setup["counts"] < 20
    similar = orc.neighbor_lists(ft) if with_ft else None
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(dev_t[t][cov], dev_j[t][cov], err_msg=t)
        _assert_near_tie_swaps(
            dev_t[t], dev_j[t], set(np.flatnonzero(~cov).tolist()),
            lambda r: _recency_scores(aid_lists[r], type_lists[r], tables,
                                      similar[aid_lists[r][-1]] if with_ft else [], t))
        np.testing.assert_array_equal(host_t[t], host_j[t], err_msg=t)
        np.testing.assert_array_equal(dev_t[t][cov], host_t[t][cov], err_msg=t)
        rows = [[int(x) for x in r if x >= 0] for r in host_t[t]]
        assert rows == oracle[t], t


def test_heuristic_zero_length_rows_and_mesh():
    aids = torch.tensor([[5, 6, 0], [7, 0, 0], [0, 0, 0]], dtype=torch.int32)
    mask, last = tcov._derive_mask_last(aids, torch.tensor([2, 1, 0]))
    assert mask.tolist() == [[True, True, False], [True, False, False], [False] * 3]
    assert last[:, 0].tolist() == [6, 7, 0]
    with pytest.raises(NotImplementedError, match="M15"):
        tcov.covisit_heuristic_predictions(None, None, {}, mesh=object(), device="cpu")


def test_pipeline_runners_match_jax(setup, monkeypatch):
    """The slice as a whole: the three runners of ``pipelines``, each with
    and without labels, against ``otto_tpu``'s.  The heuristic's lists are
    bit-equal on the covisitation route and equal up to near-tie swaps on
    the device recency route (see the module docstring)."""
    sp_j, sp_t = setup["sp_j"], setup["sp_t"]
    assert set(tpipe.MODEL_RUNNERS) == {"aid_frequency", "aid_weight", "covisitation"}
    for name in ("build_covisitation", "covisit_heuristic_predictions"):
        monkeypatch.setattr(jcov, name,
                            functools.partial(getattr(jcov, name), chunk_sessions=CHUNK))
    runs = [
        (tpipe.run_aid_frequency(sp_t.train, sp_t.val_input, N_AIDS, sp_t.val_labels,
                                 device="cpu"),
         jpipe.run_aid_frequency(sp_j.train, sp_j.val_input, N_AIDS, sp_j.val_labels)),
        (tpipe.run_aid_weight(sp_t.val_input, sp_t.val_labels, device="cpu"),
         jpipe.run_aid_weight(sp_j.val_input, sp_j.val_labels)),
        (tpipe.run_aid_weight(sp_t.val_input, device="cpu"),
         jpipe.run_aid_weight(sp_j.val_input)),
        (tpipe.run_covisit_heuristic(sp_t.train, sp_t.val_input, N_AIDS, sp_t.val_labels,
                                     device="cpu"),
         jpipe.run_covisit_heuristic(sp_j.train, sp_j.val_input, N_AIDS, sp_j.val_labels)),
    ]
    cov = setup["counts"] < 20
    aid_lists, type_lists = orc.store_to_lists(sp_t.val_input)
    tables = {k: orc.table_to_dict(setup["mats_t"].tables[k][0], 15)
              for k in setup["mats_t"].tables}
    for i, (tr, jr) in enumerate(runs):
        for t in EVENT_TYPES:
            if i < 3:
                np.testing.assert_array_equal(tr.predictions[t], jr.predictions[t])
                continue
            np.testing.assert_array_equal(tr.predictions[t][cov], jr.predictions[t][cov])
            _assert_near_tie_swaps(
                tr.predictions[t], jr.predictions[t], set(np.flatnonzero(~cov).tolist()),
                lambda r: _recency_scores(aid_lists[r], type_lists[r], tables, [], t))
        if jr.report is None:
            assert tr.report is None
            continue
        assert (tr.report.clicks_n, tr.report.carts_n, tr.report.orders_n) == \
            (jr.report.clicks_n, jr.report.carts_n, jr.report.orders_n)
        for f in ("clicks", "carts", "orders", "weighted", "corpus_weighted"):
            assert abs(getattr(tr.report, f) - getattr(jr.report, f)) <= 1e-6, f
        assert 0.0 < tr.report.weighted < 1.0
