"""The port's segmented scans and multiset ops against ``otto_tpu``.

Same seeded numpy inputs through both packages, on the CPU.  Tolerance:
exact.  Inputs are integer-valued, so every sum is exact in both packages
whatever its order; the top-k lists tie often and must break the ties
alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.ops import multiset as jms
from otto_tpu.ops import scan as jscan
from otto_tpu_torch.ops import multiset as tms
from otto_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)


def _jit(fn):
    """The JAX scans run eagerly op by op unless jitted (seconds per call)."""
    return jax.jit(fn, static_argnames="axis")


def _runs(seed, shape, axis):
    rng = np.random.default_rng(seed)
    values = rng.integers(-3, 9, shape).astype(np.float32)
    head = rng.random(shape) < 0.3
    return values, head


@pytest.mark.parametrize("axis", [0, 1])
def test_scans_and_run_totals_match_jax(axis):
    values, head = _runs(axis, (37, 53), axis)
    tv, th = torch.from_numpy(values), torch.from_numpy(head)
    for jf, tf in ((jscan.segmented_cumsum, tscan.segmented_cumsum),
                   (jscan.segmented_propagate_first, tscan.segmented_propagate_first),
                   (jscan.run_totals, tscan.run_totals)):
        np.testing.assert_array_equal(tf(tv, th, axis=axis).numpy(),
                                      np.asarray(_jit(jf)(jnp.asarray(values), jnp.asarray(head),
                                                          axis=axis)))


def test_run_totals_broadcast_head_over_weight_columns():
    """The covisitation reduce passes head [S, M, 1] against weights [S, M, 7]."""
    rng = np.random.default_rng(3)
    values = rng.integers(0, 7, (5, 40, 7)).astype(np.float32)
    head = rng.random((5, 40, 1)) < 0.4
    np.testing.assert_array_equal(
        tscan.run_totals(torch.from_numpy(values), torch.from_numpy(head), axis=1).numpy(),
        np.asarray(_jit(jscan.run_totals)(jnp.asarray(values), jnp.asarray(head), axis=1)))


def _rows(seed, S=24, M=90, n=30):
    rng = np.random.default_rng(seed)
    values = rng.integers(-1, n, (S, M)).astype(np.int32)
    valid = rng.random((S, M)) < 0.85
    weights = rng.integers(1, 4, (S, M)).astype(np.float32)
    return values, valid, weights


@pytest.mark.parametrize("k", [1, 20, 200])
def test_row_weight_and_count_topk_match_jax(k):
    values, valid, weights = _rows(k)
    jv, jw = map(np.asarray, jms.row_weight_topk(values, weights, valid, k))
    tv, tw = tms.row_weight_topk(torch.from_numpy(values), torch.from_numpy(weights),
                                 torch.from_numpy(valid), k)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tw.numpy(), jw)
    jc, jcw = map(np.asarray, jms.row_count_topk(values, valid, k))
    tc, tcw = tms.row_count_topk(torch.from_numpy(values), torch.from_numpy(valid), k)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tcw.numpy(), jcw)


def test_member_mask_compaction_cascade_unique_and_gather_match_jax():
    rng = np.random.default_rng(5)
    S, k = 16, 20
    cand = rng.integers(-1, 25, (S, k)).astype(np.int32)
    members = rng.integers(-1, 25, (S, 9)).astype(np.int32)
    jm = np.asarray(jms.mask_members(cand, members))
    tm = tms.mask_members(torch.from_numpy(cand), torch.from_numpy(members)).numpy()
    np.testing.assert_array_equal(tm, jm)

    jc = np.asarray(jms.compact_rows(jm))
    tc = tms.compact_rows(torch.from_numpy(tm)).numpy()
    np.testing.assert_array_equal(tc, jc)

    primary = np.array(jms.compact_rows(rng.integers(-1, 25, (S, 12)).astype(np.int32)))
    primary[0] = -1  # a row with no session aids
    filler = rng.integers(0, 25, k).astype(np.int32)
    np.testing.assert_array_equal(
        tms.concat_unique_cascade(torch.from_numpy(primary), torch.from_numpy(tc),
                                  torch.from_numpy(filler), k).numpy(),
        np.asarray(jms.concat_unique_cascade(primary, jc, filler, k)))

    values, valid, _ = _rows(6, M=40)
    for u in (5, 40):
        np.testing.assert_array_equal(
            tms.sorted_unique_rows(torch.from_numpy(values), torch.from_numpy(valid), u).numpy(),
            np.asarray(jms.sorted_unique_rows(values, valid, u)))

    table = rng.integers(-1, 25, (25, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tms.gather_neighbors(torch.from_numpy(table), torch.from_numpy(members)).numpy(),
        np.asarray(jms.gather_neighbors(table, members)))
