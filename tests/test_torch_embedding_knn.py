"""The embedding-kNN serving slice of the port against ``otto_tpu``.

Same numpy inputs through both packages, on the CPU.  At these sizes both
retrievers take their exact dense path; the kernels' coverage is in
``tests/test_torch_retrieval_kernels.py`` and on the card.

Tolerances:
- neighbor tables and exact-scan rows: equal, except where two candidates'
  scores lie within 1e-5 (relative) of each other: float32 sums taken in
  another order may swap such a pair, inside a row or at its k-th place.
  Those rows are counted and must be rare;
- recency scores within 1e-5 relative: ``exp2`` differs by one ulp between
  the two frameworks on ~17% of inputs, and the per-aid sums of up to 256
  weights run in another order (measured worst case 1.4e-6).  Lists equal,
  except where two adjacent scores of a row lie within that same 1e-5; such
  rows are counted and must be rare;
- end to end: predictions equal, weighted recall within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import SGNSConfig as JSGNSConfig
from otto_tpu.data.splits import split_by_fraction as j_split
from otto_tpu.data.synthetic import synthetic_events as j_synth
from otto_tpu.data.synthetic import synthetic_events_v2 as j_synth_v2
from otto_tpu.eval.harness import evaluate_predictions as j_eval
from otto_tpu.models import embeddings as jemb
from otto_tpu.ops import retrieval as jret
from otto_tpu.ops import sessions as jses
from otto_tpu_torch.config import SGNSConfig
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.data.splits import split_by_fraction
from otto_tpu_torch.eval.harness import evaluate_predictions
from otto_tpu_torch.models import embeddings as temb
from otto_tpu_torch.ops import retrieval as tret
from otto_tpu_torch.ops import sessions as tses
from otto_tpu_torch.utils.runtime import resolve_device

torch.set_num_threads(1)


def _table(n, d=32, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _near_tie_mismatches(t_rows, j_rows, queries, items, metric, tol):
    """Count rows where the two tables differ.  At every differing position
    the two items' float64 scores must lie within ``tol`` (relative to the
    row's scale) of each other: a near-tie that float32 sums in another
    order may swap, inside the row or at its k-th place."""
    bad = np.flatnonzero((t_rows != j_rows).any(axis=1))
    x = items.astype(np.float64)
    for r in bad:
        diff = t_rows[r] != j_rows[r]

        def score(idx):
            s = x[idx] @ queries[r].astype(np.float64)
            return 2.0 * s - (x[idx] ** 2).sum(1) if metric == "euclidean" else s

        st, sj = score(t_rows[r][diff]), score(j_rows[r][diff])
        scale = max(1.0, np.abs(score(j_rows[r])).max())
        assert np.abs(st - sj).max() <= tol * scale, (r, st, sj)
    return len(bad)


# ------------------------------------------------------------- retrieval ----
@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_topk_scan_matches_jax(metric):
    items = _table(4000)
    q = _table(64, seed=1)
    js, ji = jret.topk_scan(jnp.asarray(q), jnp.asarray(items), k=21, block=1024,
                            metric=metric)
    ts, ti = tret.topk_scan(torch.from_numpy(q), torch.from_numpy(items), k=21, block=1024,
                            metric=metric)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-4)
    assert _near_tie_mismatches(ti.numpy(), np.asarray(ji), q, items, metric, 1e-5) <= 1


def test_topk_scan_pads_short_tables():
    items = _table(5)
    ts, ti = tret.topk_scan(torch.from_numpy(items), torch.from_numpy(items), k=8)
    assert (ti.numpy()[:, 5:] == -1).all() and (ts.numpy()[:, 5:] < -1e38).all()


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_build_neighbor_table_matches_jax(exact, exclude_self):
    items = _table(4000, seed=2)
    kw = dict(k=21, metric="euclidean", exclude_self=exclude_self, query_batch=1024,
              scores_out=True, exact=exact)
    jt, _ = jret.build_neighbor_table(items, backend="compensated", **kw)
    tt, _ = tret.build_neighbor_table(items, device="cpu", **kw)
    assert tt.dtype == np.int32 and tt.shape == (4000, 21)
    if exclude_self:
        assert not (tt == np.arange(4000)[:, None]).any()
    else:
        assert (tt[:, 0] == np.arange(4000)).all()
    assert _near_tie_mismatches(tt, jt, items, items, "euclidean", 1e-5) <= 4


def test_build_neighbor_table_rejects_partial_reduce_backends():
    """The reference's PartialReduce backends run on the port's own routes
    (``tests/test_torch_retrieval_backends.py`` holds them to ``otto_tpu``);
    a name no package knows still raises."""
    items = _table(10)
    want = tret.build_neighbor_table(items, k=2, exact=True, device="cpu")
    for backend in ("hybrid", "approx", "int8"):
        got = tret.build_neighbor_table(items, k=2, backend=backend, device="cpu")
        assert got.shape == (10, 2) and got.dtype == np.int32
        if backend != "int8":  # int8 ranks by the quantized scores
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown backend"):
        tret.build_neighbor_table(items, k=2, backend="annoy", device="cpu")


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        tret.build_neighbor_table(_table(10), k=2, device="cuda")


# --------------------------------------------------------------- recency ----
def _packed_long_sessions():
    es = j_synth(n_sessions=160, n_aids=120, mean_length=90.0, max_length=600, seed=3)
    assert es.lengths.max() > 256  # keep='last' clipping is exercised
    return es.pack(max_len=256, keep="last")


def test_recency_weighted_top_aids_matches_jax():
    p = _packed_long_sessions()
    coef = np.array([1.0, 6.0, 3.0], np.float32)
    jt, js = jses.recency_weighted_top_aids(
        jnp.asarray(p.aids), jnp.asarray(p.types), jnp.asarray(p.mask),
        jnp.asarray(p.lengths), jnp.asarray(coef), k=20, lo=0.1, hi=1.0)
    jt, js = np.asarray(jt), np.asarray(js)
    for chunk in (1024, 7):  # the result does not depend on the chunk size
        tt, ts = tses.recency_weighted_top_aids(
            torch.from_numpy(p.aids), torch.from_numpy(p.types), torch.from_numpy(p.mask),
            torch.from_numpy(p.lengths), torch.from_numpy(coef), k=20, lo=0.1, hi=1.0,
            chunk=chunk)
        tt, ts = tt.numpy(), ts.numpy()
        assert tt.dtype == np.int32 and tt.shape == jt.shape
        np.testing.assert_allclose(ts, js, rtol=1e-5)
        bad = np.flatnonzero((tt != jt).any(axis=1))
        for r in bad:  # only near-ties may swap
            gaps = np.abs(np.diff(ts[r][ts[r] > -1e38]))
            assert gaps.min() <= 1e-5 * np.abs(ts[r]).max(), r
        assert len(bad) <= 2


# ------------------------------------------------------------ end to end ----
@pytest.fixture(scope="module")
def slice_inputs(tmp_path_factory):
    n_aids = 4000
    es_j = j_synth_v2(n_sessions=3000, n_aids=n_aids, seed=5)
    es_t = synthetic_events_v2(n_sessions=3000, n_aids=n_aids, seed=5)
    sp_j, sp_t = j_split(es_j, 0.2), split_by_fraction(es_t, 0.2)
    rng = np.random.default_rng(6)
    w_in = (rng.normal(size=(n_aids, 32)) * 0.3).astype(np.float32)
    w_out = np.zeros_like(w_in)
    counts = np.bincount(sp_j.train.aid, minlength=n_aids).astype(np.float32)
    jmodel = jemb.SGNSModel(w_in, w_out, counts, JSGNSConfig())
    path = tmp_path_factory.mktemp("sgns") / "sgns.npz"
    jmodel.save(path)
    jtable = jmodel.neighbor_table(k=21, backend="compensated")
    return dict(sp_j=sp_j, sp_t=sp_t, jmodel=jmodel, path=path, jtable=jtable,
                w_in=w_in, w_out=w_out, counts=counts)


def test_sgns_model_load_and_from_jax_arrays(slice_inputs):
    tm = temb.SGNSModel.load(slice_inputs["path"], SGNSConfig(), device="cpu")
    tm2 = temb.SGNSModel.from_jax_arrays(slice_inputs["w_in"], slice_inputs["w_out"],
                                         slice_inputs["counts"], SGNSConfig(), device="cpu")
    for m in (tm, tm2):
        np.testing.assert_array_equal(m.w_in.numpy(), slice_inputs["w_in"])
        np.testing.assert_array_equal(m.counts.numpy(), slice_inputs["counts"])
        assert m.embeddings.device.type == "cpu"
    table = tm.neighbor_table(k=21)
    np.testing.assert_array_equal(table, tm2.neighbor_table(k=21))
    np.testing.assert_array_equal(table, slice_inputs["jtable"])


@pytest.mark.parametrize("recursive", [False, True])
def test_embedding_knn_slice_matches_jax(slice_inputs, recursive):
    sp_j, sp_t = slice_inputs["sp_j"], slice_inputs["sp_t"]
    tm = temb.SGNSModel.load(slice_inputs["path"], device="cpu")
    ttable = tm.neighbor_table(k=21)
    np.testing.assert_array_equal(ttable, slice_inputs["jtable"])

    jp = jemb.embedding_knn_predictions(sp_j.val_input, slice_inputs["jtable"],
                                        recursive=recursive)
    tp = temb.embedding_knn_predictions(sp_t.val_input, ttable, recursive=recursive,
                                        device="cpu")
    assert set(tp) == {"clicks", "carts", "orders"}
    n_rec = int((np.asarray([len(np.unique(sp_t.val_input.aid[a:b])) for a, b in
                             zip(sp_t.val_input.offsets[:-1], sp_t.val_input.offsets[1:])])
                 >= 20).sum())
    assert n_rec > 0  # both serving routes run
    for et in tp:
        np.testing.assert_array_equal(tp[et], jp[et])

    jr = j_eval(sp_j.val_labels, jp["clicks"], jp["carts"], jp["orders"])
    tr = evaluate_predictions(sp_t.val_labels, tp["clicks"], tp["carts"], tp["orders"],
                              device="cpu")
    assert abs(tr.weighted - jr.weighted) <= 1e-6
    assert abs(tr.corpus_weighted - jr.corpus_weighted) <= 1e-6
    assert (tr.clicks_n, tr.carts_n, tr.orders_n) == (jr.clicks_n, jr.carts_n, jr.orders_n)
    assert 0.0 < tr.weighted < 1.0
