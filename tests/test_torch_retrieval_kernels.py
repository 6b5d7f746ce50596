"""The port's retrieval kernels against the JAX package's Pallas kernels.

The same numpy inputs go through ``otto_tpu`` (Pallas kernels in interpret
mode, as ``tests/test_pallas_retrieval.py`` runs them) and through
``otto_tpu_torch`` (the kernels' plain-torch twins on the CPU).
``tests/test_torch_cuda_kernels.py`` holds each CUDA kernel against its twin
on the card.

Tolerances:
- the peel is pure selection: values and columns bit-equal;
- stage 1 on integer-valued inputs (|x| <= 8) is exact in float32 whatever
  the summation order: packed maxima bit-equal.  On normal data the two
  frameworks sum the products in different orders, so a window's packed
  maximum may move by one truncation step (2^7 ulps) and change its 7-bit
  position code: values within 2^8 ulps = 2^-15 relative, and the decoded
  item equal on >= 99.9% of windows (it differs only where two items of a
  window score within the 7 lane bits of each other);
- the retriever on integer-valued inputs: identical indices and scores.  On
  normal data: index overlap with JAX >= 0.99, recall against numpy brute
  force >= 0.9 (the bound of ``tests/test_pallas_retrieval.py``), exact
  scores within rtol 1e-5, atol 1e-4 of float64 numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.ops import pallas_retrieval as jpr
from otto_tpu.ops import row_topk as jrt
from otto_tpu_torch.ops import fused_retrieval as tfr
from otto_tpu_torch.ops import row_topk as trt

torch.set_num_threads(1)

N_ITEMS, DIM, N_Q, K = 5 * 16384 + 123, 32, 16, 20


def _int_data(rng, shape):
    return rng.integers(-8, 9, size=shape).astype(np.float32)


def _peel_input(rng, b, m):
    x = rng.normal(size=(b, m)).astype(np.float32)
    # ties inside windows: repeat a window's max at other slots, and a whole
    # window of equal values
    x[:, 5] = x[:, 7] = x[:, 100] = 9.0
    x[:, 128:256] = 3.0
    x[1, 300] = x[1, 301] = x[1].max() + 1.0
    return x


# ------------------------------------------------------------------ K2 ----
@pytest.mark.parametrize("rounds", [1, 6])
def test_peel_twin_bit_equal_to_pallas(rounds):
    rng = np.random.default_rng(0)
    x = _peel_input(rng, 16, 14 * 128)
    jv, jc = jrt.peel_rows(jnp.asarray(x), rounds, row_block=16, interpret=True)
    tv, tc = trt.peel_rows(torch.from_numpy(x), rounds)
    assert tv.dtype == torch.float32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _peel_edge_input(case, rng, b, m):
    """Windows that stress the peel's contract: ties, fewer distinct values
    than rounds, -inf slots and whole -inf windows, all-equal windows."""
    if case == "ties":
        return rng.integers(0, 6, (b, m)).astype(np.float32)
    if case == "few_distinct":
        x = rng.choice(np.array([-1.5, 0.25, 7.0], np.float32), size=(b, m))
        x[:, 128:256] = rng.choice(np.array([3.0, -2.0], np.float32), size=(b, 128))
        return x
    if case == "neginf":
        x = rng.normal(size=(b, m)).astype(np.float32)
        x[rng.random((b, m)) < 0.4] = -np.inf
        x[:, 128:256] = -np.inf
        x[:, 300:384] = -np.inf  # a window whose first live slot is past its start
        return x
    if case == "all_equal":
        x = np.full((b, m), 2.5, np.float32)
        x[:, 256:384] = rng.normal(size=(b, 128)).astype(np.float32)
        return x
    if case == "denormal":  # K1's pad windows: bit patterns in [0, 128)
        return rng.integers(0, 128, (b, m)).astype(np.int32).view(np.float32)
    raise ValueError(case)


def _peel_model(x, rounds):
    """The peel's contract in numpy: per 128-column window, its ``rounds``
    largest distinct values, each with its smallest column, then
    (-inf, the window's first column) once the values run out."""
    b, m = x.shape
    w = m // 128
    vals = np.full((b, rounds, w), -np.inf, np.float32)
    cols = np.tile((np.arange(w, dtype=np.int32) * 128)[None, None, :], (b, rounds, 1))
    for i in range(b):
        for j in range(w):
            win = x[i, 128 * j:128 * (j + 1)]
            live = np.unique(win[win > -np.inf])[::-1][:rounds]
            for r, v in enumerate(live):
                vals[i, r, j] = v
                cols[i, r, j] = 128 * j + int(np.flatnonzero(win == v)[0])
    return vals.reshape(b, -1), cols.reshape(b, -1)


@pytest.mark.parametrize("rounds", [1, 6, 21])
@pytest.mark.parametrize("case", ["ties", "few_distinct", "neginf", "all_equal", "denormal"])
def test_peel_twin_edge_cases_match_contract(case, rounds):
    """The twin against the numpy model of the contract.  Denormals stay
    distinct: the card's peel compares without flushing them."""
    x = _peel_edge_input(case, np.random.default_rng(13), 37, 4 * 128)
    mv, mc = _peel_model(x, rounds)
    tv, tc = trt.peel_rows(torch.from_numpy(x), rounds)
    np.testing.assert_array_equal(tv.numpy().view(np.int32), mv.view(np.int32))
    np.testing.assert_array_equal(tc.numpy(), mc)


@pytest.mark.parametrize("rounds", [1, 6, 21])
@pytest.mark.parametrize("case", ["ties", "few_distinct", "neginf", "all_equal"])
def test_peel_twin_edge_cases_bit_equal_to_pallas(case, rounds):
    """B = 37 is not a multiple of the Pallas row block, so the JAX input
    is padded with rows of zeros and its outputs cut back."""
    rng = np.random.default_rng(12)
    x = _peel_edge_input(case, rng, 37, 4 * 128)
    xp = np.concatenate([x, np.zeros((3, x.shape[1]), np.float32)])
    jv, jc = jrt.peel_rows(jnp.asarray(xp), rounds, row_block=8, interpret=True)
    tv, tc = trt.peel_rows(torch.from_numpy(x), rounds)
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv)[:37].view(np.int32))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:37])
    if case == "neginf" and rounds == 21:
        # an exhausted window repeats (-inf, its first column)
        w = tv.numpy().reshape(37, rounds, 4)[:, :, 1]
        c = tc.numpy().reshape(37, rounds, 4)[:, :, 1]
        assert np.isneginf(w).all() and (c == 128).all()


def test_peel_twin_int32_matches_pallas():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 50, (8, 512)).astype(np.int32)  # many ties
    jv, jc = jrt.peel_rows(jnp.asarray(x), 3, row_block=8, interpret=True)
    tv, tc = trt.peel_rows(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("k,rounds", [(20, None), (6, 6), (5, 2)])
def test_row_topk_matches_jax(k, rounds):
    rng = np.random.default_rng(2)
    x = _peel_input(rng, 32, 1024)
    jv, ji = jrt.row_topk(jnp.asarray(x), k=k, rounds=rounds, row_block=32, interpret=True)
    tv, ti = trt.row_topk(torch.from_numpy(x), k=k, rounds=rounds)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_row_topk_small_row_exact():
    x = np.random.default_rng(3).normal(size=(4, 100)).astype(np.float32)
    tv, ti = trt.row_topk(torch.from_numpy(x), k=5)
    np.testing.assert_array_equal(ti.numpy(), np.argsort(-x, axis=1, kind="stable")[:, :5])


def test_peel_rejects_ragged_rows():
    with pytest.raises(ValueError):
        trt.peel_rows(torch.zeros(2, 200), 1)


# ------------------------------------------------------------------ K1 ----
def _stage1_both(q, t, dtype):
    jd = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    jout = jpr._stage1(jnp.asarray(q, jd), jnp.asarray(t, jd), tile=8, block=16384,
                       interpret=True)
    tout = tfr.fused_stage1(torch.from_numpy(q).to(dtype), torch.from_numpy(t).to(dtype))
    return np.asarray(jout), tout.numpy()


# DA 257-510 are past the wgmma kernel's depth: on the card they take the
# deep wgmma route (294: a compensated table of 96 dims, 390: 128 dims, 510:
# 168 dims), which must give the same packed maxima
@pytest.mark.parametrize("da,dtype", [(34, torch.bfloat16), (102, torch.bfloat16),
                                      (34, torch.float32), (257, torch.bfloat16),
                                      (294, torch.bfloat16), (300, torch.bfloat16),
                                      (390, torch.bfloat16), (510, torch.bfloat16)])
def test_stage1_twin_bit_equal_on_integer_inputs(da, dtype):
    rng = np.random.default_rng(4)
    q = _int_data(rng, (8, da))
    t = _int_data(rng, (da, 2 * 16384))
    t[:, -300:] = 0.0  # pad columns score exactly 0
    j, p = _stage1_both(q, t, dtype)
    assert p.shape == (8, 2 * 128)
    np.testing.assert_array_equal(p.view(np.int32), j.view(np.int32))


@pytest.mark.parametrize("da,dtype", [(34, torch.float32), (34, torch.bfloat16),
                                      (102, torch.bfloat16), (294, torch.bfloat16)])
def test_stage1_twin_close_on_normal_inputs(da, dtype):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(8, da)).astype(np.float32)
    q[:, -1] = 64.0  # the positivity shift: every score > 0, as in the retriever
    t = rng.normal(size=(da, 2 * 16384)).astype(np.float32)
    t[-1] = 1.0
    j, p = _stage1_both(q, t, dtype)
    np.testing.assert_allclose(p, j, rtol=2.0**-15, atol=0)
    jb, pb = j.view(np.int32), p.view(np.int32)
    same_pos = (jb & 127) == (pb & 127)
    assert same_pos.mean() >= 0.999


def _pad_contraction(q, t, da_pad):
    """Zero-pad the contraction of q [B, DA] and t [DA, N] to da_pad."""
    da = q.shape[1]
    return (np.pad(q, ((0, 0), (0, da_pad - da))), np.pad(t, ((0, da_pad - da), (0, 0))))


# the path's contractions (34 single, 102 compensated), the compensated one
# of a 64-dim table (198), and the bf16 kernel's limits (1, 256)
@pytest.mark.parametrize("da", [1, 34, 102, 198, 256])
def test_stage1_twin_unchanged_by_zero_padded_contraction(da):
    """The invariant the bf16 kernel rests on: padding the contraction to
    wgmma's depth (a multiple of 16) with zeros in both operands leaves the
    packed maxima bit-equal.  The queries carry a positive shift in their
    last dimension, as the retriever's do: a query row of zeros would score
    -0.0 against negative entries unpadded and +0.0 padded."""
    rng = np.random.default_rng(11)
    q = _int_data(rng, (8, da))
    q[:, -1] = 64.0
    t = _int_data(rng, (da, 2 * 16384))
    t[:, -300:] = 0.0
    qp, tp = _pad_contraction(q, t, -(-da // 16) * 16)
    for dtype in (torch.bfloat16, torch.float32):
        base = tfr.fused_stage1(torch.from_numpy(q).to(dtype), torch.from_numpy(t).to(dtype))
        padded = tfr.fused_stage1(torch.from_numpy(qp).to(dtype), torch.from_numpy(tp).to(dtype))
        np.testing.assert_array_equal(padded.numpy().view(np.int32), base.numpy().view(np.int32))


@pytest.mark.parametrize("dtype,da,route", [
    (torch.bfloat16, 1, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 257, "wgmma_deep"), (torch.bfloat16, 294, "wgmma_deep"),
    (torch.bfloat16, tfr.K1_WGMMA_DEEP_MAX_DA, "wgmma_deep"),
    (torch.bfloat16, tfr.K1_WGMMA_DEEP_MAX_DA + 16, "fma"), (torch.bfloat16, 1816, "fma"),
    (torch.bfloat16, 1817, "fma"), (torch.bfloat16, 2048, "fma"), (torch.bfloat16, 2049, None),
    (torch.float32, 34, "fma"), (torch.float32, 300, "fma"), (torch.float32, 2048, "fma"),
    (torch.float32, 2049, None),
])
def test_stage1_route(dtype, da, route):
    """The card's kernel for each dtype and depth: bf16 on the tensor cores up
    to the deep kernel's limit (at least 512, a compensated table of 168
    dims), float32 (which the tensor cores would round to TF32) and deeper
    bf16 on the FMA kernel, nothing past the FMA kernel's 2,048 (its query
    tile of 16 rows beside two table tiles in shared memory)."""
    assert tfr.K1_WGMMA_DEEP_MAX_DA >= 512 and tfr.K1_FMA_MAX_DA == 2048
    if route is None:
        with pytest.raises(ValueError):
            tfr.stage1_route(dtype, da)
    else:
        assert tfr.stage1_route(dtype, da) == route


@pytest.mark.parametrize("q_shape,t_shape,dtypes,error", [
    ((4, 34), (33, 16384), (torch.bfloat16, torch.bfloat16), ValueError),  # DA differs
    ((4, 34), (34, 16384 + 128), (torch.bfloat16, torch.bfloat16), ValueError),  # ragged N_pad
    ((4, 34), (34, 16384), (torch.bfloat16, torch.float32), TypeError),  # mixed dtypes
    ((4, 34), (34, 16384), (torch.float16, torch.float16), TypeError),  # no float16 kernel
])
def test_stage1_rejects_bad_operands(q_shape, t_shape, dtypes, error):
    with pytest.raises(error):
        tfr.fused_stage1(torch.zeros(q_shape, dtype=dtypes[0]),
                         torch.zeros(t_shape, dtype=dtypes[1]))


def test_bf16_casts_round_to_nearest_even():
    """The compensated split needs JAX's and torch's f32->bf16 casts to agree
    (round to nearest, ties to even)."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.normal(size=4096).astype(np.float32) * 100,
                        # exact ties between two bf16 values
                        np.array([1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(1.0 + 2.0**-8)],
                                 np.float32)])
    j = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    t = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[-3:], [1.0, 1.0 + 4 * 2.0**-8, -1.0])


def _exact_power_of_two(c):
    return float(2.0 ** np.round(np.log2(float(c))))


def test_augment_queries_same_shift():
    """Same power of two as the reference.  JAX's ``jnp.exp2`` on the CPU is
    a few ulps off an exact power (8192.004 for 2^13); the port forms the
    power exactly, so it equals the reference's shift rounded to the nearest
    power of two (and to bf16, where the kernels read it)."""
    rng = np.random.default_rng(7)
    for scale in (0.1, 1.0, 7.3, 1000.0):
        q = (rng.normal(size=(16, 32)) * scale).astype(np.float32)
        max_sq = float(np.float32(scale * scale * 40.0))
        for metric in ("dot", "euclidean"):
            jq, jc = jpr._augment_queries(jnp.asarray(q), max_sq, metric)
            tq, tc = tfr._augment_queries(torch.from_numpy(q), max_sq, metric)
            assert tc == _exact_power_of_two(jc) == float(jnp.asarray(jc, jnp.bfloat16))
            np.testing.assert_array_equal(tq.numpy()[:, :-1], np.asarray(jq)[:, :-1])
            assert (tq.numpy()[:, -1] == tc).all()


# ----------------------------------------------------------- retriever ----
def _both_topk(kind, metric, precision, exact_scores):
    """(items, queries, port retriever, JAX scores, JAX indices)."""
    rng = np.random.default_rng(8 if kind == "int" else 9)
    if kind == "int":
        items = _int_data(rng, (N_ITEMS, DIM))
        queries = _int_data(rng, (N_Q, DIM))
    else:
        items = rng.normal(size=(N_ITEMS, DIM)).astype(np.float32)
        queries = rng.normal(size=(N_Q, DIM)).astype(np.float32)
    jr = jpr.PallasRetriever(items, metric=metric, precision=precision, interpret=True)
    js, ji = jr.topk(jnp.asarray(queries), k=K, tile=8, rounds=6, exact_scores=exact_scores)
    tr = tfr.FusedRetriever(items, metric=metric, precision=precision, device="cpu")
    return items, queries, tr, np.asarray(js), np.asarray(ji)


@pytest.mark.parametrize("exact_scores", [False, True])
@pytest.mark.parametrize("precision", ["single", "compensated"])
@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_retriever_identical_on_integer_inputs(metric, precision, exact_scores):
    _, queries, tr, js, ji = _both_topk("int", metric, precision, exact_scores)
    ts, ti = tr.topk(queries, k=K, rounds=6, exact_scores=exact_scores)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ji)
    if not exact_scores:
        # decoded scores subtract the shift C: the reference's CPU shift
        # exceeds the exact power of two (see test_augment_queries_same_shift)
        _, jc = jpr._augment_queries(jnp.asarray(queries), tr.max_sq, metric)
        js = js.astype(np.float64) + (float(jc) - _exact_power_of_two(jc))
    np.testing.assert_array_equal(ts.numpy(), js)


@pytest.mark.parametrize("exact_scores", [False, True])
@pytest.mark.parametrize("precision", ["single", "compensated"])
@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_retriever_matches_pallas_on_normal_inputs(metric, precision, exact_scores):
    items, queries, tr, js, ji = _both_topk("normal", metric, precision, exact_scores)
    ts, ti = tr.topk(queries, k=K, rounds=6, exact_scores=exact_scores)
    ts, ti = ts.numpy(), ti.numpy()
    overlap = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ti, ji))
    assert overlap / ji.size >= 0.99

    scores = queries.astype(np.float64) @ items.T.astype(np.float64)
    if metric == "euclidean":
        scores = 2.0 * scores - np.sum(items.astype(np.float64) ** 2, axis=1)[None, :]
    exact_i = np.argsort(-scores, axis=1)[:, :K]
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ti, exact_i))
    assert hits / ti.size >= 0.9
    assert ti.min() >= 0 and ti.max() < N_ITEMS
    picked = np.take_along_axis(scores, ti, axis=1)
    if exact_scores:
        np.testing.assert_allclose(ts, picked, rtol=1e-5, atol=1e-4)
    else:
        # decoded packed keys: the lane-bit truncation of the shifted score
        shift = 2.0 ** np.ceil(np.log2(2.0 + (queries ** 2).sum(1).max()
                                       + 2.0 * (items ** 2).sum(1).max()))
        tol = shift * (2.0**-15 if precision == "compensated" else 2.0**-6)
        assert np.abs(ts - picked).max() <= tol


def test_retriever_dense_fallback_matches_jax():
    rng = np.random.default_rng(10)
    items = rng.normal(size=(500, 16)).astype(np.float32)
    queries = rng.normal(size=(7, 16)).astype(np.float32)
    _, ji = jpr.PallasRetriever(items, metric="dot", interpret=True).topk(
        jnp.asarray(queries), k=10)
    ts, ti = tfr.FusedRetriever(items, metric="dot", device="cpu").topk(queries, k=10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), np.argsort(-(queries @ items.T), axis=1)[:, :10])


def test_retriever_rejects_compensated_f32_table():
    with pytest.raises(ValueError):
        tfr.FusedRetriever(np.zeros((10, 4), np.float32), precision="compensated",
                           table_dtype=torch.float32, device="cpu")
