"""The port's other retrieval backends against ``otto_tpu`` on the CPU:
``quantize_items_int8``, ``topk_hybrid_int8``, ``topk_hybrid``,
``topk_approx``, ``build_neighbor_table(backend="hybrid" | "approx" |
"int8")`` and ``FusedRetriever.topk(rescore_survivors=True)`` with
``rescore_dtype``.

The same numpy inputs go through both packages.  On the CPU the JAX
package's PartialReduce (``jax.lax.approx_max_k``) falls back to an exact
top-k and its Pallas kernels run in interpret mode; the port runs its
kernels' plain twins.  ``tests/test_torch_cuda_retrieval_backends.py`` holds
the int8 kernel against its twin on the card.

Tolerances:
- ``quantize_items_int8``: bit-equal (q8, scale, and sq for rows of up to 32
  dims, where XLA's CPU reduction adds the squares in ascending order as the
  port does; past 32 it sums in another order: within 2^-21 relative);
- the int8 twin against a numpy model of the kernel's contract (int64
  dots, the float32 epilogue in its order, the packing, the window max):
  bit-equal;
- int8 scores: bit-equal to the reference's formula ``f32(acc) * (qs *
  scale)`` (then ``2 s - sq``) evaluated in numpy on the returned ids, and
  within 2^-22 of the magnitude of its terms (``|s|``, or ``2|s| + sq``) of
  the JAX package's, whose CPU fusion rounds the rescale its own way (up to
  2.04 x 2^-24 of it, measured);
- int8 ids on the dense route: equal to JAX's but for quantized near-ties
  (scores within 2^-20 of the terms' magnitude), counted and expected 0;
- int8, hybrid and approx at 70,000 items and at 450,000: recall >= 0.99
  against JAX's exact lists.  At 70,000 the recall target sends them to
  the exact dense route: there the windows themselves would lose more (two
  of a row's top 22 share a 128-item window with probability ~3%, and six
  peel rounds over five stage-2 windows keep ~0.90, as
  ``expected_window_recall`` predicts and the windowed route measures); at
  450,000 they run windowed;
- float32 scores of shared ids within 1e-5 * (|s| + 1): the products are
  summed in another order;
- ``rescore_survivors`` on integer-valued inputs: ids and scores bit-equal
  to ``PallasRetriever``; on normal inputs by recall.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.models import embeddings as jemb
from otto_tpu.ops import pallas_retrieval as jpr
from otto_tpu.ops import retrieval as jret
from otto_tpu_torch.models import embeddings as temb
from otto_tpu_torch.ops import fused_retrieval as tfr
from otto_tpu_torch.ops import retrieval as tret

torch.set_num_threads(1)

CHUNK = tfr.CHUNK


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _queries(items, b, seed):
    """Rows of the table with a little noise: queries with near neighbors."""
    rng = np.random.default_rng(seed)
    q = items[rng.choice(len(items), b, replace=False)]
    return (q + 0.1 * rng.normal(size=q.shape)).astype(np.float32)


def _recall(got, want):
    return sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got, want)) / want.size


# ------------------------------------------------------------ quantize ----
@pytest.mark.parametrize("dim", [16, 32, 48])
def test_quantize_items_int8_bit_equal_to_jax(dim):
    rng = np.random.default_rng(dim)
    x = _normal((3000, dim), 0) * rng.uniform(1e-3, 1e3, (3000, 1)).astype(np.float32)
    x[0] = 0.0                                   # the 1e-30 floor
    x[1] = np.float32(3e29) * np.sign(x[1])      # near +-1e30: sq overflows to inf
    x[2, ::2] = -1e30
    x[3] = x[3] * np.float32(1e-38)              # denormal rows
    x[4, :] = 1.0                                # exact .5 ties: 127 * (1 / 1)
    x[5] = np.linspace(-1, 1, dim, dtype=np.float32)  # halves, rounded to even
    jq8, jsc, jsq = (np.asarray(a) for a in jret.quantize_items_int8(jnp.asarray(x)))
    tq8, tsc, tsq = (a.numpy() for a in tret.quantize_items_int8(x))
    assert tq8.dtype == np.int8 and tsc.dtype == np.float32 and tsq.dtype == np.float32
    np.testing.assert_array_equal(tq8, jq8)
    np.testing.assert_array_equal(tsc.view(np.int32), jsc.view(np.int32))
    assert tsc[0] == np.float32(1e-30) / np.float32(127.0) and (tq8[0] == 0).all()
    assert np.isinf(tsq[1]) and np.abs(tq8).max() == 127
    if dim <= 32:
        np.testing.assert_array_equal(tsq.view(np.int32), jsq.view(np.int32))
    else:
        np.testing.assert_allclose(tsq, jsq, rtol=2.0**-21)


# ---------------------------------------------------------- int8 twin ----
def _int8_operands(dim, n_items, b, seed):
    """Random int8 operands zero-padded to D_pad, positive scales (pads 0),
    norms as the bias, a zero query row; the shift from the data."""
    rng = np.random.default_rng(seed)
    d_pad = -(-dim // 32) * 32
    n_pad = -(-n_items // CHUNK) * CHUNK
    q8 = np.zeros((b, d_pad), np.int8)
    q8[:, :dim] = rng.integers(-127, 128, (b, dim))
    q8[3] = 0
    t8 = np.zeros((n_pad, d_pad), np.int8)
    t8[:n_items, :dim] = rng.integers(-127, 128, (n_items, dim))
    q_scale = rng.uniform(1e-3, 2e-2, b).astype(np.float32)
    item_scale = np.zeros(n_pad, np.float32)
    item_scale[:n_items] = rng.uniform(1e-3, 2e-2, n_items)
    item_bias = np.zeros(n_pad, np.float32)
    item_bias[:n_items] = rng.uniform(0.0, 60.0, n_items)
    return q8, q_scale, t8, item_scale, item_bias


def _int8_model(q8, q_scale, t8, item_scale, item_bias, n_items, shift, metric):
    """The kernel's contract in numpy."""
    acc = (q8.astype(np.int64) @ t8.astype(np.int64).T).astype(np.float32)
    s = acc * (q_scale[:, None] * item_scale[None, :])
    if metric == "euclidean":
        s = np.float32(2.0) * s - item_bias[None, :]
    key = s + np.float32(shift)
    key[:, n_items:] = 0.0
    b, n_pad = key.shape
    code = ((np.arange(n_pad) >> 7) & 127).astype(np.int32)
    packed = ((key.view(np.int32) & ~127) | code).view(np.float32)
    return packed.reshape(b, n_pad // CHUNK, 128, 128).max(axis=2).reshape(b, n_pad // 128)


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
@pytest.mark.parametrize("dim", [8, 16, 32, 48])
def test_int8_twin_bit_equal_to_contract(dim, metric):
    n_items = CHUNK + 100  # the second chunk: 100 live items, the rest pads
    ops = _int8_operands(dim, n_items, 19, seed=dim)
    shift = 64.0 if metric == "dot" else 512.0  # every live key >= 1
    want = _int8_model(*ops, n_items, shift, metric)
    got = tfr.fused_stage1_int8(*(torch.from_numpy(a) for a in ops), n_items=n_items,
                                shift=shift, metric=metric).numpy()
    assert got.shape == (19, 2 * 128) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    live = got.view(np.int32) >= tfr.LIVE_BITS
    # a window is live if one of its items is: the second chunk's windows
    # (lanes) 100-127 hold only pads and pack below 1.0
    assert live[:, :128 + 100].all() and not live[:, 128 + 100:].any()


@pytest.mark.parametrize("case", ["q8 dtype", "scale dtype", "ragged N_pad", "D_pad 48",
                                  "D_pad 288", "shapes", "metric", "n_items"])
def test_int8_twin_rejects_bad_operands(case):
    q8, qs, t8, isc, ib = (torch.from_numpy(a) for a in _int8_operands(32, 100, 4, seed=0))
    kw = {"n_items": 100, "shift": 64.0, "metric": "dot"}
    error = ValueError
    if case == "q8 dtype":
        q8, error = q8.to(torch.int32), TypeError
    elif case == "scale dtype":
        qs, error = qs.to(torch.float64), TypeError
    elif case == "ragged N_pad":
        t8, isc, ib = t8[:-128], isc[:-128], ib[:-128]
    elif case in ("D_pad 48", "D_pad 288"):
        d = int(case.split()[1])
        q8, t8 = torch.zeros((4, d), dtype=torch.int8), torch.zeros((CHUNK, d), dtype=torch.int8)
    elif case == "shapes":
        qs = qs[:3]
    elif case == "metric":
        kw["metric"] = "cosine"
    else:
        kw["n_items"] = CHUNK + 1
    with pytest.raises(error):
        tfr.fused_stage1_int8(q8, qs, t8, isc, ib, **kw)


# ------------------------------------------------------- int8 top-k ----
def _quantized_scores(q, q8, scale, sq, ids, metric):
    """The reference's float32 formula in numpy on ids [B, k]: queries
    quantized as ``topk_hybrid_int8`` does, f32(acc) * (qs * scale), then
    2 s - sq; also the magnitude of the terms."""
    qs = np.maximum(np.abs(q).max(axis=1), np.float32(1e-30)) / np.float32(127.0)
    qq = np.clip(np.round(q / qs[:, None]), -127, 127).astype(np.int64)
    acc = np.einsum("bd,bkd->bk", qq, q8[ids].astype(np.int64)).astype(np.float32)
    s = acc * (qs[:, None] * scale[ids])
    if metric == "dot":
        return s, np.abs(s)
    return np.float32(2.0) * s - sq[ids], np.abs(np.float32(2.0) * s) + sq[ids]


def _check_int8_scores(ts, ti, js, ji, q, quant, metric):
    """The port's scores are the reference's formula on its ids, to the bit;
    those of ids both lists hold within 2^-22 of the terms of JAX's."""
    want, _ = _quantized_scores(q, *quant, ti, metric)
    np.testing.assert_array_equal(ts.view(np.int32), want.view(np.int32))
    _, mag = _quantized_scores(q, *quant, ji, metric)
    for r in range(len(ti)):
        pos_j = {int(i): j for j, i in enumerate(ji[r])}
        for a, i in zip(ts[r], ti[r].tolist()):
            if i in pos_j:
                b = js[r, pos_j[i]]
                assert abs(float(a) - float(b)) <= 2.0**-22 * float(mag[r, pos_j[i]]), (r, i)


def _int8_both(n, dim, b, k, metric, seed):
    items = _normal((n, dim), seed)
    q = _queries(items, b, seed + 1)
    quant = tuple(np.asarray(a) for a in jret.quantize_items_int8(jnp.asarray(items)))
    js, ji = jret.topk_hybrid_int8(jnp.asarray(q), *(jnp.asarray(a) for a in quant), k=k,
                                   metric=metric, tile=64)
    ts, ti = tret.topk_hybrid_int8(q, *tret.quantize_items_int8(items), k=k, metric=metric)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    return q, quant, ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji)


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_topk_hybrid_int8_dense_route_matches_jax(metric):
    q, quant, ts, ti, js, ji = _int8_both(2048, 16, 64, 21, metric, seed=30)
    _check_int8_scores(ts, ti, js, ji, q, quant, metric)
    # ids equal but for near-ties of the quantized scores
    bad = np.flatnonzero((ti != ji).any(axis=1))
    for r in bad:
        diff = ti[r] != ji[r]
        st, _ = _quantized_scores(q[r:r + 1], *quant, ti[r:r + 1, diff], metric)
        sj, mag = _quantized_scores(q[r:r + 1], *quant, ji[r:r + 1, diff], metric)
        assert np.abs(st - sj).max() <= 2.0**-20 * mag.max(), r
    assert len(bad) == 0


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_topk_hybrid_int8_windowed_route_matches_jax(metric, monkeypatch):
    calls = []
    stage1 = tfr.fused_stage1_int8
    monkeypatch.setattr(tfr, "fused_stage1_int8",
                        lambda *a, **kw: calls.append(a[0].shape) or stage1(*a, **kw))
    q, quant, ts, ti, js, ji = _int8_both(450_000, 32, 64, 22, metric, seed=31)
    assert calls == [(64, 32)]  # the windowed route, one stage-1 call
    assert _recall(ti, ji) >= 0.99
    assert ti.min() >= 0 and ti.max() < 450_000
    _check_int8_scores(ts, ti, js, ji, q, quant, metric)


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_topk_hybrid_int8_meets_recall_target_at_70000(metric, monkeypatch):
    """The issue's size for the int8 route, 70,000 x 32, k 22: the windows
    would keep ~0.90, below the 0.99 target, so the route scores the
    quantized table exactly (no stage-1 call) and matches JAX's lists."""
    calls = []
    stage1 = tfr.fused_stage1_int8
    monkeypatch.setattr(tfr, "fused_stage1_int8",
                        lambda *a, **kw: calls.append(a[0].shape) or stage1(*a, **kw))
    q, quant, ts, ti, js, ji = _int8_both(70_000, 32, 64, 22, metric, seed=32)
    assert calls == []
    assert _recall(ti, ji) >= 0.99
    _check_int8_scores(ts, ti, js, ji, q, quant, metric)


# ---------------------------------------------------- recall target ----
@pytest.mark.parametrize("n, k, target, want", [
    (70_000, 22, 0.99, None),      # stage 1 alone keeps ~0.982: dense
    (70_000, 22, None, 6),         # no target: the rounds as given
    (150_000, 22, 0.99, 7),        # six rounds keep ~0.9875: one more
    (450_000, 22, 0.99, 6),
    (1_855_603, 22, 0.99, 6),      # the OTTO catalog
    (300_000, 60, 0.99, None),     # a deep k: stage 1 keeps ~0.988
    (4 * CHUNK, 5, 0.5, None),     # four chunks or fewer: dense
])
def test_window_rounds_meets_the_recall_target(n, k, target, want):
    n_pad = -(-n // CHUNK) * CHUNK
    assert tfr.window_rounds(n, n_pad, k, 6, target) == want
    if want is not None and target is not None:
        assert tfr.expected_window_recall(n, k, want) >= target
        assert want == 6 or tfr.expected_window_recall(n, k, want - 1) < target


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_expected_window_recall_predicts_the_windowed_route(metric):
    """At 70,000 x 16, k 22, six rounds and no target the windowed route
    runs; its recall against the exact scan is what the model says."""
    items = _normal((70_000, 16), 33)
    q = _queries(items, 256, 34)
    r = tfr.FusedRetriever(items, metric=metric, table_dtype=torch.float32, device="cpu")
    _, got = r.topk(q, k=22, rounds=6)
    _, want = tret.topk_scan(torch.from_numpy(q), torch.from_numpy(items), k=22, metric=metric)
    model = tfr.expected_window_recall(70_000, 22, 6)
    assert abs(_recall(got.numpy(), want.numpy()) - model) <= 0.03, model


# ------------------------------------------------- hybrid and approx ----
def _check_float_scores(ts, ti, js, ji):
    """Float32 scores of ids both lists hold within 1e-5 * (|s| + 1) of
    JAX's (the products are summed in another order)."""
    for r in range(len(ti)):
        pos_j = {int(i): j for j, i in enumerate(ji[r])}
        for j, i in enumerate(ti[r].tolist()):
            if i in pos_j:
                b = js[r, pos_j[i]]
                assert abs(ts[r, j] - b) <= 1e-5 * (abs(b) + 1), (r, i)


def _hybrid_both(fn, n, metric, seed, monkeypatch):
    """``fn`` of both packages on an n x 16 table, k 21; the port's stage-1
    routes recorded.  Checks recall >= 0.99 against JAX's lists and the
    scores of shared ids; returns the port's arrays, the inputs and the
    routes."""
    items = _normal((n, 16), seed)
    q = _queries(items, 64, seed + 1)
    js, ji = getattr(jret, fn)(jnp.asarray(q), jnp.asarray(items), k=21, metric=metric, tile=64)
    routes = []
    stage1 = tfr.fused_stage1
    monkeypatch.setattr(tfr, "fused_stage1",
                        lambda q_aug, t: routes.append(tfr.stage1_route(t.dtype, t.shape[0]))
                        or stage1(q_aug, t))
    ts, ti = (x.numpy() for x in getattr(tret, fn)(q, items, k=21, metric=metric))
    assert _recall(ti, np.asarray(ji)) >= 0.99
    _check_float_scores(ts, ti, np.asarray(js), np.asarray(ji))
    return items, q, ts, ti, routes


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
@pytest.mark.parametrize("fn", ["topk_hybrid", "topk_approx"])
def test_topk_hybrid_and_approx_match_jax(fn, metric, monkeypatch):
    items, q, ts, ti, routes = _hybrid_both(fn, 450_000, metric, 40, monkeypatch)
    assert routes == ["fma"]  # a float32 table: the FMA kernel on the card
    # returned scores are the exact float32 scores of the returned ids
    x = items.astype(np.float64)[ti]
    exact = np.einsum("bd,bkd->bk", q.astype(np.float64), x)
    if metric == "euclidean":
        exact = 2.0 * exact - (x * x).sum(axis=2)
    np.testing.assert_allclose(ts, exact, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
@pytest.mark.parametrize("fn", ["topk_hybrid", "topk_approx"])
def test_topk_hybrid_and_approx_meet_recall_target_at_70000(fn, metric, monkeypatch):
    """The issue's size, 70,000 x 16, k 21: below the target's reach of the
    windows, so the float32 scores are taken exactly (no stage-1 call)."""
    assert _hybrid_both(fn, 70_000, metric, 43, monkeypatch)[-1] == []


def test_topk_hybrid_bf16_items_take_the_wgmma_route(monkeypatch):
    routes = []
    stage1 = tfr.fused_stage1
    monkeypatch.setattr(tfr, "fused_stage1",
                        lambda q_aug, t: routes.append((q_aug.dtype, t.dtype)) or stage1(q_aug, t))
    items = torch.from_numpy(_normal((5 * CHUNK + 7, 16), 42)).to(torch.bfloat16)
    q = items[:32].to(torch.float32)
    s, i = tret.topk_hybrid(q, items, k=10, metric="dot")
    # compensated: a contraction of 3 (16 + 2), on the wgmma kernel
    assert routes == [(torch.bfloat16, torch.bfloat16)]
    assert tfr.stage1_route(torch.bfloat16, 54) == "wgmma"
    exact = q @ items.to(torch.float32).T
    assert _recall(i.numpy(), torch.topk(exact, 10).indices.numpy()) >= 0.99


# ------------------------------------------------- neighbor table ----
def _int8_table_near_ties(tt, jt, items, quant):
    """Rows where the two int8 tables differ; at every differing position
    the two items' quantized euclidean scores must lie within 2^-20 of their
    terms' magnitude (a near-tie that XLA's rounding may swap)."""
    bad = np.flatnonzero((tt != jt).any(axis=1))
    for r in bad:
        diff = tt[r] != jt[r]
        st, _ = _quantized_scores(items[r:r + 1], *quant, tt[r:r + 1, diff], "euclidean")
        sj, mag = _quantized_scores(items[r:r + 1], *quant, jt[r:r + 1, diff], "euclidean")
        assert np.abs(st - sj).max() <= 2.0**-20 * mag.max(), r
    return len(bad)


def _float_table_near_ties(tt, jt, items, tol):
    """Rows where the two float32 tables differ; at every differing position
    the two items' float64 euclidean scores must lie within ``tol`` of the
    row's scale (float32 sums in another order may swap a near-tie)."""
    bad = np.flatnonzero((tt != jt).any(axis=1))
    x = items.astype(np.float64)
    for r in bad:
        diff = tt[r] != jt[r]

        def score(idx):
            return 2.0 * x[idx] @ x[r] - (x[idx] ** 2).sum(axis=1)

        scale = max(1.0, np.abs(score(jt[r])).max())
        assert np.abs(score(tt[r][diff]) - score(jt[r][diff])).max() <= tol * scale, r
    return len(bad)


@pytest.mark.parametrize("backend", ["hybrid", "approx", "int8"])
def test_build_neighbor_table_backend_matches_jax(backend):
    items = _normal((2048, 16), 50)
    kw = dict(k=21, metric="euclidean", query_batch=512, scores_out=True)
    jt, js = jret.build_neighbor_table(items, backend=backend, **kw)
    tt, ts = tret.build_neighbor_table(items, backend=backend, device="cpu", **kw)
    assert tt.dtype == np.int32 and tt.shape == (2048, 21)
    assert not (tt == np.arange(2048)[:, None]).any()
    if backend == "int8":
        quant = tuple(np.asarray(a) for a in jret.quantize_items_int8(jnp.asarray(items)))
        assert _int8_table_near_ties(tt, jt, items, quant) == 0
    else:
        assert _float_table_near_ties(tt, jt, items, 1e-5) <= 2
        same = tt == jt
        np.testing.assert_allclose(ts[same], js[same], rtol=1e-5, atol=1e-4)


def test_sgns_neighbor_table_int8_matches_jax():
    w = _normal((2048, 32), 51)
    zeros = np.zeros_like(w)
    jt = jemb.SGNSModel(w, zeros, np.zeros(2048, np.float32), None).neighbor_table(
        k=21, backend="int8", query_batch=512)
    model = temb.SGNSModel.from_jax_arrays(w, zeros, np.zeros(2048, np.float32), device="cpu")
    tt = model.neighbor_table(k=21, backend="int8", query_batch=512)
    quant = tuple(np.asarray(a) for a in jret.quantize_items_int8(jnp.asarray(w)))
    assert _int8_table_near_ties(tt, np.asarray(jt), w, quant) == 0


# --------------------------------------------------- rescore_survivors ----
N_ITEMS, DIM, N_Q, K = 5 * CHUNK + 123, 32, 16, 20


def _both_survivors(kind, metric, precision, rescore_dtype=None):
    """(items, queries, port (scores, ids), JAX (scores, ids)) of
    ``topk(rescore_survivors=True)`` on the same table."""
    rng = np.random.default_rng(60 if kind == "int" else 61)
    if kind == "int":
        items = rng.integers(-8, 9, (N_ITEMS, DIM)).astype(np.float32)
        queries = rng.integers(-8, 9, (N_Q, DIM)).astype(np.float32)
    else:
        items = rng.normal(size=(N_ITEMS, DIM)).astype(np.float32)
        queries = rng.normal(size=(N_Q, DIM)).astype(np.float32)
    jkw = {} if rescore_dtype is None else {"rescore_dtype": jnp.bfloat16}
    tkw = {} if rescore_dtype is None else {"rescore_dtype": rescore_dtype}
    jr = jpr.PallasRetriever(items, metric=metric, precision=precision, interpret=True, **jkw)
    js, ji = jr.topk(jnp.asarray(queries), k=K, tile=8, rounds=6, rescore_survivors=True)
    tr = tfr.FusedRetriever(items, metric=metric, precision=precision, device="cpu", **tkw)
    ts, ti = tr.topk(queries, k=K, rounds=6, rescore_survivors=True)
    return items, queries, tr, (ts.numpy(), ti.numpy()), (np.asarray(js), np.asarray(ji))


@pytest.mark.parametrize("precision", ["single", "compensated"])
@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_rescore_survivors_identical_on_integer_inputs(metric, precision):
    _, _, _, (ts, ti), (js, ji) = _both_survivors("int", metric, precision)
    assert ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_rescore_survivors_recall_on_normal_inputs(metric):
    items, queries, tr, (ts, ti), (js, ji) = _both_survivors("normal", metric, "single")
    assert _recall(ti, ji) >= 0.99
    scores = queries.astype(np.float64) @ items.T.astype(np.float64)
    if metric == "euclidean":
        scores = 2.0 * scores - np.sum(items.astype(np.float64) ** 2, axis=1)[None, :]
    exact = np.argsort(-scores, axis=1)[:, :K]
    # at least the plain top-k's recall against the exact scan: the survivors'
    # float32 scores choose the k, not the bf16 keys
    _, plain = tr.topk(queries, k=K, rounds=6)
    assert _recall(ti, exact) >= max(0.9, _recall(plain.numpy(), exact))
    np.testing.assert_allclose(ts, np.take_along_axis(scores, ti, axis=1), rtol=1e-5, atol=1e-4)


def test_rescore_dtype_bf16_matches_reference():
    items, queries, tr, (ts, ti), (js, ji) = _both_survivors(
        "normal", "euclidean", "single", rescore_dtype=torch.bfloat16)
    assert tr.items.dtype == torch.bfloat16
    assert _recall(ti, ji) >= 0.99
    _check_float_scores(ts, ti, js, ji)
    # the scores are those of the bf16-rounded items (norms from float32)
    x = torch.from_numpy(items).to(torch.bfloat16).to(torch.float64).numpy()[ti]
    s = 2.0 * np.einsum("bd,bkd->bk", queries.astype(np.float64), x) \
        - (items.astype(np.float64) ** 2).sum(axis=1)[ti]
    np.testing.assert_allclose(ts, s, rtol=1e-5, atol=1e-4)
