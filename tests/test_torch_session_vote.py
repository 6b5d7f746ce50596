"""The port's session vote (K3's twin) and session ops against ``otto_tpu``.

Same seeded numpy inputs through both packages, on the CPU; the Pallas
kernel runs in interpret mode.  The kernel itself is held against the twin
on the card in ``tests/test_torch_cuda_kernels.py``.

Tolerances:
- ``first`` and ``firstpos``: bit-equal;
- ``agg``: within 2^-16 * sum_j |w_j| of its row (the sums run in another
  order); equal on integer weights;
- top-k lists on integer weights: bit-equal, and the summed weights equal;
- session ops on packed sessions (integer outputs): bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.data.synthetic import synthetic_events as j_synth
from otto_tpu.ops import pallas_sessions as jps
from otto_tpu.ops import sessions as jses
from otto_tpu_torch.ops import fused_sessions as tfs
from otto_tpu_torch.ops import sessions as tses

torch.set_num_threads(1)


def _vote_inputs(seed, S=20, L=128, n=12, integer=False):
    rng = np.random.default_rng(seed)
    aids = rng.integers(0, n, (S, L)).astype(np.int32)
    tail = rng.integers(0, L, S)
    aids[np.arange(L)[None, :] >= L - tail[:, None]] = -1  # -1 tails of every length
    w = (rng.integers(1, 5, (S, L)) if integer else rng.random((S, L))).astype(np.float32)
    w[aids < 0] = 0
    return aids, w


@pytest.mark.parametrize("integer", [False, True])
def test_vote_twin_matches_pallas_interpret(integer):
    aids, w = _vote_inputs(0, integer=integer)
    ja, jf, jp = map(np.asarray, jps.aid_vote_aggregate(aids, w, session_tile=4,
                                                        interpret=True))
    ta, tf, tp = (x.numpy() for x in tfs.aid_vote_aggregate(torch.from_numpy(aids),
                                                           torch.from_numpy(w)))
    valid = aids >= 0
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tp[valid], jp[valid])
    # padding comes out as agg 0, first 0, firstpos L
    assert (ta[~valid] == 0).all() and (tf[~valid] == 0).all() and (tp[~valid] == 128).all()
    bound = 2.0**-16 * np.abs(w).sum(axis=1, keepdims=True)
    if integer:
        np.testing.assert_array_equal(ta, ja)
    else:
        assert (np.abs(ta - ja) <= bound).all()


def test_vote_wrapper_rejects_bad_inputs():
    a = torch.zeros((2, 8), dtype=torch.int32)
    w = torch.zeros((2, 8))
    with pytest.raises(TypeError):
        tfs.aid_vote_aggregate(a.long(), w)
    with pytest.raises(TypeError):
        tfs.aid_vote_aggregate(a, w.double())
    with pytest.raises(ValueError):
        tfs.aid_vote_aggregate(a, w[:, :4])
    before = tfs.aid_vote_aggregate.launches
    tfs.aid_vote_aggregate(a, w)  # the CPU twin counts no launch
    assert tfs.aid_vote_aggregate.launches == before


@pytest.mark.parametrize("seed", [0, 1])
def test_per_aid_weight_top_both_conventions_match_jax(seed):
    rng = np.random.default_rng(seed)
    S, L = 30, 64
    aids = rng.integers(0, 15, (S, L)).astype(np.int32)
    w = rng.integers(1, 5, (S, L)).astype(np.float32)  # integer weights: exact ties
    mask = rng.random((S, L)) < 0.9
    mask[0] = False  # an empty row
    ta, tw, tm = torch.from_numpy(aids), torch.from_numpy(w), torch.from_numpy(mask)

    ja, jw = map(np.asarray, jps.per_aid_weight_top_pallas(aids, w, mask, k=10, session_tile=4,
                                                           interpret=True))
    fa, fw = (x.numpy() for x in tfs.per_aid_weight_top_fused(ta, tw, tm, k=10))
    np.testing.assert_array_equal(fa, ja)
    np.testing.assert_array_equal(fw, jw)  # padded with 0.0
    assert (fw[fa < 0] == 0.0).all()

    xa, xw = map(np.asarray, jses.per_aid_weight_top(aids, w, mask, k=10))
    pa, pw = (x.numpy() for x in tses.per_aid_weight_top(ta, tw, tm, k=10))
    np.testing.assert_array_equal(pa, xa)
    np.testing.assert_array_equal(pw, xw)  # padded with NEG
    assert (pw[pa < 0] < -1e38).all()
    np.testing.assert_array_equal(pa, fa)


@pytest.fixture(scope="module")
def packed_sessions():
    es = j_synth(n_sessions=120, n_aids=90, mean_length=60.0, max_length=600, seed=4)
    assert es.lengths.max() > 256 and es.lengths.min() < 5
    return es.pack(max_len=256, keep="last")


@pytest.mark.parametrize("k", [5, 20])
def test_distinct_lists_and_occurrences_match_jax(packed_sessions, k):
    p = packed_sessions
    ja, jm = jnp.asarray(p.aids), jnp.asarray(p.mask)
    ta, tm = torch.from_numpy(p.aids), torch.from_numpy(p.mask)
    for jf, tf in ((jses.distinct_recent_first, tses.distinct_recent_first),
                   (jses.distinct_first_seen, tses.distinct_first_seen)):
        np.testing.assert_array_equal(tf(ta, tm, k=k).numpy(), np.asarray(jf(ja, jm, k=k)))
    np.testing.assert_array_equal(tses.last_occurrence(ta, tm).numpy(),
                                  np.asarray(jses.last_occurrence(ja, jm)))
    np.testing.assert_array_equal(tses.first_occurrence(ta, tm).numpy(),
                                  np.asarray(jses.first_occurrence(ja, jm)))


def test_recency_weighted_top_aids_integer_coefficients_bit_equal(packed_sessions):
    """With ``lo == hi`` every recency weight is 2^lo - 1 = 1, so the per-aid
    sums are the integer type coefficients and the lists tie often: lists
    and sums bit-equal, through the K3 twin."""
    p = packed_sessions
    coef = np.array([1.0, 6.0, 3.0], np.float32)
    ja, jw = jses.recency_weighted_top_aids(
        jnp.asarray(p.aids), jnp.asarray(p.types), jnp.asarray(p.mask),
        jnp.asarray(p.lengths), jnp.asarray(coef), k=20, lo=1.0, hi=1.0)
    ta, tw = tses.recency_weighted_top_aids(
        torch.from_numpy(p.aids), torch.from_numpy(p.types), torch.from_numpy(p.mask),
        torch.from_numpy(p.lengths), torch.from_numpy(coef), k=20, lo=1.0, hi=1.0, chunk=16)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
