"""The port's TF-IDF recommender (``otto_tpu_torch/models/tfidf.py``,
``pipelines.run_tfidf``) against ``otto_tpu``'s, on the CPU.

Tolerances: ``tfidf_weights``, the IDF table and ``session_vectors`` bit-equal
(the same numpy, copied); the similar-session lists and ``run_tfidf``'s
lists equal, and its report equal (recall counts) and within 1e-6: the
float32 scan ranks the same corpus sessions here (near-ties of the scan
could order two sessions otherwise; none on these inputs).
"""

import numpy as np
import pytest
import torch

from otto_tpu import EVENT_TYPES
from otto_tpu import pipelines as jpipe
from otto_tpu.data.splits import split_by_fraction as j_split_by_fraction
from otto_tpu.data.synthetic import synthetic_events_v2 as j_synth_v2
from otto_tpu.models import tfidf as jtf
from otto_tpu_torch import pipelines as tpipe
from otto_tpu_torch.data.splits import split_by_fraction
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.models import tfidf as ttf

torch.set_num_threads(1)

N_AIDS = 400
KW = dict(n_sessions=500, n_aids=N_AIDS, mean_length=10.0, max_length=32, n_clusters=20,
          seed=13)


@pytest.fixture(scope="module")
def stores():
    return j_synth_v2(**KW), synthetic_events_v2(**KW)


def test_weights_and_vectors_bit_equal(stores):
    js, ts = stores
    assert (np.bincount(ts.session_idx * N_AIDS + ts.aid) > 1).any()  # repeated terms
    for a, b in zip(ttf.tfidf_weights(ts, N_AIDS), jtf.tfidf_weights(js, N_AIDS)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for dim, seed in ((256, 0), (64, 3)):
        got = ttf.session_vectors(ts, N_AIDS, dim, seed)
        assert got.shape == (ts.n_sessions, dim)
        np.testing.assert_array_equal(got, jtf.session_vectors(js, N_AIDS, dim, seed))


def test_similar_session_predictions_equal(stores):
    js, ts = stores
    jm, tm = jtf.TfIdfModel.fit(js, N_AIDS, dim=64), ttf.TfIdfModel.fit(ts, N_AIDS, dim=64)
    np.testing.assert_array_equal(tm.vectors, jm.vectors)
    qmask = np.zeros(ts.n_sessions, bool)
    qmask[::3] = True
    want = jm.similar_session_predictions(js.select_sessions(qmask), n_similar=3, k=12,
                                          query_batch=64)
    got = tm.similar_session_predictions(ts.select_sessions(qmask), n_similar=3, k=12,
                                         query_batch=64, device="cpu")
    for t in EVENT_TYPES:
        assert got[t].dtype == np.int32 and got[t].shape == (int(qmask.sum()), 12)
        np.testing.assert_array_equal(got[t], want[t])


@pytest.mark.parametrize("mode", ["validation", "submission"])
def test_run_tfidf_equal_to_jax(stores, mode):
    js, ts = stores
    if mode == "validation":
        jsp, tsp = j_split_by_fraction(js, 0.2, 1), split_by_fraction(ts, 0.2, 1)
        want = jpipe.run_tfidf(jsp.train, jsp.val_input, N_AIDS, jsp.val_labels)
        got = tpipe.run_tfidf(tsp.train, tsp.val_input, N_AIDS, tsp.val_labels, device="cpu")
        assert (got.report.clicks_n, got.report.carts_n, got.report.orders_n) == \
            (want.report.clicks_n, want.report.carts_n, want.report.orders_n)
        assert got.report.weighted == pytest.approx(want.report.weighted, abs=1e-6)
        assert 0 < got.report.weighted < 1
    else:
        want = jpipe.run_tfidf(js, js, N_AIDS)
        got = tpipe.run_tfidf(ts, ts, N_AIDS, device="cpu")
        assert got.report is None
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(got.predictions[t], want.predictions[t])
