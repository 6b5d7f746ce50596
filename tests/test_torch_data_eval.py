"""The port's copied data modules and its metrics against ``otto_tpu``.

The data modules are numpy copies: same inputs, equal arrays.  The metrics
run on torch tensors; recalls are float32 ratios in both packages, so they
agree to float32 rounding of the final sums (1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.data import labels as jlab
from otto_tpu.data import splits as jspl
from otto_tpu.data import synthetic as jsyn
from otto_tpu.eval import harness as jhar
from otto_tpu.eval import metrics as jmet
from otto_tpu_torch.data import labels as tlab
from otto_tpu_torch.data import splits as tspl
from otto_tpu_torch.data import synthetic as tsyn
from otto_tpu_torch.eval import harness as thar
from otto_tpu_torch.eval import metrics as tmet

torch.set_num_threads(1)

STORE_FIELDS = ("session_idx", "aid", "ts", "type", "offsets", "session_ids")


def _assert_stores_equal(a, b):
    for f in STORE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("gen", ["synthetic_events", "synthetic_events_v2"])
def test_synthetic_generators_equal(gen):
    kw = dict(n_sessions=400, n_aids=900, seed=11)
    _assert_stores_equal(getattr(tsyn, gen)(**kw), getattr(jsyn, gen)(**kw))


@pytest.mark.parametrize("keep", ["last", "first"])
def test_pack_equal(keep):
    es_t = tsyn.synthetic_events(n_sessions=200, n_aids=300, mean_length=40.0, seed=12)
    es_j = jsyn.synthetic_events(n_sessions=200, n_aids=300, mean_length=40.0, seed=12)
    pt, pj = es_t.pack(max_len=32, keep=keep), es_j.pack(max_len=32, keep=keep)
    for f in ("aids", "types", "ts", "mask", "lengths", "session_ids"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f), err_msg=f)
    np.testing.assert_array_equal(es_t.last_aid(), es_j.last_aid())


def test_build_labels_and_split_equal():
    es_t = tsyn.synthetic_events_v2(n_sessions=600, n_aids=800, seed=13)
    es_j = jsyn.synthetic_events_v2(n_sessions=600, n_aids=800, seed=13)
    cut_t = tlab.random_cutoffs(es_t, np.random.default_rng(1))
    cut_j = jlab.random_cutoffs(es_j, np.random.default_rng(1))
    np.testing.assert_array_equal(cut_t, cut_j)
    lt, lj = tlab.build_labels(es_t, cut_t), jlab.build_labels(es_j, cut_j)
    for f in ("session_ids", "click", "cart_flat", "cart_offsets", "order_flat",
              "order_offsets"):
        np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f), err_msg=f)
    st, sj = tspl.split_by_fraction(es_t, 0.25), jspl.split_by_fraction(es_j, 0.25)
    _assert_stores_equal(st.train, sj.train)
    _assert_stores_equal(st.val_input, sj.val_input)
    np.testing.assert_array_equal(st.cutoffs, sj.cutoffs)
    for kind in ("clicks", "carts", "orders"):
        np.testing.assert_array_equal(st.val_labels.padded(kind), sj.val_labels.padded(kind))


def _preds_and_labels(seed, s=300, k=20, n_aids=60):
    rng = np.random.default_rng(seed)
    preds = np.full((s, k), -1, np.int32)
    for i in range(s):
        n = rng.integers(0, k + 1)
        preds[i, :n] = rng.choice(n_aids, size=n, replace=False)
    labels = np.full((s, 25), -1, np.int32)
    for i in range(s):
        n = rng.integers(0, 26)
        labels[i, :n] = rng.choice(n_aids, size=n, replace=False)
    click = np.where(rng.random(s) < 0.8, rng.integers(0, n_aids, s), -1).astype(np.int32)
    return preds, labels, click


def test_metrics_match_jax():
    preds, labels, click = _preds_and_labels(14)
    tp, tl, tc = map(torch.from_numpy, (preds, labels, click))
    np.testing.assert_array_equal(tmet.hits_at_k(tp, tl).numpy(),
                                  np.asarray(jmet.hits_at_k(jnp.asarray(preds), jnp.asarray(labels))))
    for tfn, jfn, lab in ((tmet.click_recall_at_k, jmet.click_recall_at_k, click),
                          (tmet.cart_order_recall_at_k, jmet.cart_order_recall_at_k, labels)):
        tr, tn = tfn(tp, torch.from_numpy(lab))
        jr, jn = jfn(jnp.asarray(preds), jnp.asarray(lab))
        assert int(tn) == int(jn)
        assert abs(float(tr) - float(jr)) <= 1e-6
    assert abs(float(tmet.corpus_recall_at_k(tp, tl))
               - float(jmet.corpus_recall_at_k(jnp.asarray(preds), jnp.asarray(labels)))) <= 1e-6
    # no scored session: NaN, as in the reference
    r, n = tmet.click_recall_at_k(tp, torch.full_like(tc, -1))
    assert int(n) == 0 and np.isnan(float(r))


def test_evaluate_predictions_matches_jax():
    es = jsyn.synthetic_events_v2(n_sessions=500, n_aids=700, seed=15)
    sp = jspl.split_by_fraction(es, 0.3)
    rng = np.random.default_rng(16)
    preds = {t: rng.integers(-1, 700, (sp.val_labels.n_sessions, 20)).astype(np.int32)
             for t in ("clicks", "carts", "orders")}
    jr = jhar.evaluate_predictions(sp.val_labels, preds["clicks"], preds["carts"],
                                   preds["orders"])
    tr = thar.evaluate_predictions(sp.val_labels, preds["clicks"], preds["carts"],
                                   preds["orders"], device="cpu")
    for f in ("clicks", "carts", "orders", "weighted", "corpus_clicks", "corpus_carts",
              "corpus_orders", "corpus_weighted"):
        assert abs(getattr(tr, f) - getattr(jr, f)) <= 1e-6, f
    assert (tr.clicks_n, tr.carts_n, tr.orders_n) == (jr.clicks_n, jr.carts_n, jr.orders_n)
    assert str(tr).startswith("clicks  - n:")
