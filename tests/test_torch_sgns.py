"""SGNS training and session embeddings of the port against ``otto_tpu``, on
the CPU.

Same numpy inputs through both packages.  Where the JAX package draws with
``jax.random``, its uniforms are re-derived here with ``jax.random.split``
/ ``uniform`` exactly as ``_sgns_multi_step`` and ``_sgns_device_chunk``
derive them, and fed to the port's steps.

Tolerances:
- ``skipgram_pairs``, ``build_huffman_paths``, the loader's batches and a
  checkpoint-resumed run: bit-equal (the same numpy draws, the same CPU
  arithmetic in the same order);
- one step: tables, accumulators and loss within 2e-6 absolute + 1e-5
  relative (the products and reductions are float32 sums taken in another
  order; duplicated rows add in index order in both);
- whole runs (2 epochs): tables within 1e-5 absolute; the few-ulp
  differences of the steps compound over a few hundred steps, measured at
  about 1e-6 here;
- the device pair sampler draws from torch's generator, so against JAX only
  its statistics are compared: kept pairs within 5 standard deviations of
  a binomial difference, and the cluster structure of
  ``tests/test_embeddings.py``;
- ``session_embeddings`` within 1e-6; the similar-session lists equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import SGNSConfig as JSGNSConfig
from otto_tpu.data.events import EventStore as JStore
from otto_tpu.data.loader import BatchLoader as JLoader
from otto_tpu.models import embeddings as jemb
from otto_tpu_torch.config import SGNSConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.loader import BatchLoader
from otto_tpu_torch.models import embeddings as temb
from otto_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

STEP_TOL = dict(rtol=1e-5, atol=2e-6)


def _stores(sess, aid, seed=0):
    L = np.bincount(sess)
    ts = np.concatenate([np.arange(n) for n in L]).astype(np.int64)
    typ = np.random.default_rng(seed).integers(0, 3, len(aid)).astype(np.int8)
    return JStore.from_flat(sess, aid, ts, typ), EventStore.from_flat(sess, aid, ts, typ)


def _random_stores(S=300, L=8, n_aids=30, seed=5):
    rng = np.random.default_rng(seed)
    return _stores(np.repeat(np.arange(S), L), rng.integers(0, n_aids, S * L))


def _cluster_stores(seed=0, S=2000, L=10, n_clusters=4, per=10):
    """Sessions confined to one of ``n_clusters`` blocks of ``per`` aids
    (``tests/test_embeddings.py``'s corpus)."""
    rng = np.random.default_rng(seed)
    clus = rng.integers(0, n_clusters, S)
    aid = (np.repeat(clus, L) * per + rng.integers(0, per, S * L)).astype(np.int64)
    return _stores(np.repeat(np.arange(S), L), aid)


def _cluster_ratio(emb, per):
    emb = np.asarray(emb)
    d = np.linalg.norm(emb[:, None] - emb[None], axis=-1)
    same = (np.arange(len(emb))[:, None] // per) == (np.arange(len(emb))[None] // per)
    off = ~np.eye(len(emb), dtype=bool)
    return d[same & off].mean() / d[~same].mean()


class JaxUniforms:
    """``train_sgns``'s negative uniforms as the JAX package draws them:
    one ``split`` of the carried key a step, ``uniform(sub, (B, neg))``."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, gen, shape):
        G, B, N = shape
        out = []
        for _ in range(G):
            self.key, sub = jax.random.split(self.key)
            out.append(np.asarray(jax.random.uniform(sub, (B, N))))
        return torch.from_numpy(np.stack(out))


# ----------------------------------------------------------- host draws ----
@pytest.mark.parametrize("subsample", [0.0, 0.01])
@pytest.mark.parametrize("window", [1, 4, 10])
def test_skipgram_pairs_bit_equal(window, subsample):
    js, ts = _random_stores(S=400, L=12, n_aids=200, seed=window)
    counts = np.bincount(js.aid, minlength=200).astype(np.float64)
    jc, jx = jemb.skipgram_pairs(js, window, np.random.default_rng(3), subsample, counts)
    tc, tx = temb.skipgram_pairs(ts, window, np.random.default_rng(3), subsample, counts)
    assert len(tc) > 0 and tc.dtype == jc.dtype == np.int32
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tx, jx)


@pytest.mark.parametrize("case", ["V1", "V2", "V3", "tied", "skewed"])
def test_huffman_paths_bit_equal(case):
    counts = {"V1": np.array([4.0]), "V2": np.array([1.0, 3.0]), "V3": np.array([2.0, 2.0, 1.0]),
              "tied": np.full(37, 5.0),
              "skewed": np.random.default_rng(0).zipf(1.5, size=3000).astype(np.float64)}[case]
    jn, jsg = jemb.build_huffman_paths(counts)
    tn, tsg = temb.build_huffman_paths(counts)
    assert tn.dtype == np.int32 and tsg.dtype == np.int8
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tsg, jsg)


# ----------------------------------------------------------------- steps ----
def _state(V, D, n_out=None, seed=0):
    rng = np.random.default_rng(seed)
    n_out = V if n_out is None else n_out
    return ((rng.normal(size=(V, D)) * 0.3).astype(np.float32),
            (rng.normal(size=(n_out, D)) * 0.3).astype(np.float32),
            rng.uniform(0, 0.5, (V, D)).astype(np.float32),
            rng.uniform(0, 0.5, (n_out, D)).astype(np.float32))


def _cdf(counts):
    p = np.asarray(counts, np.float64) ** 0.75
    return np.cumsum(p / p.sum()).astype(np.float32)


def _pairs(case, V, B, rng):
    if case == "duplicates":  # few distinct rows: duplicated centers and contexts
        return (rng.integers(0, 4, B).astype(np.int32), rng.integers(0, 4, B).astype(np.int32))
    return rng.integers(0, V, B).astype(np.int32), rng.integers(0, V, B).astype(np.int32)


def _same_state(got, want, tol=STEP_TOL):
    for g, w, name in zip(got, want, ("w_in", "w_out", "acc_in", "acc_out")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **tol)


@pytest.mark.parametrize("case", ["random", "duplicates"])
def test_sgns_step_matches_jax(case):
    V, D, B, N = 50, 8, 64, 5
    rng = np.random.default_rng(1)
    state = _state(V, D)
    centers, contexts = _pairs(case, V, B, rng)
    # the duplicate case concentrates the negatives on the contexts' rows
    counts = np.r_[np.full(4, 100.0), np.ones(V - 4)] if case == "duplicates" else \
        rng.integers(1, 50, V).astype(np.float64)
    cdf = _cdf(counts)
    key = jax.random.PRNGKey(7)
    *want, wloss = jemb._sgns_step_impl(*map(jnp.asarray, state), jnp.asarray(centers),
                                        jnp.asarray(contexts), jnp.asarray(cdf),
                                        jnp.float32(0.05), key, N)
    u = np.array(jax.random.uniform(key, (B, N)))  # the draw inside the step
    negs = temb.draw_negatives(torch.from_numpy(cdf), torch.from_numpy(u))
    if case == "duplicates":
        assert np.isin(negs.numpy(), contexts).mean() > 0.5
    got = temb.sgns_state_from_jax(*state, device="cpu")
    loss = temb.sgns_step(*got, torch.from_numpy(centers), torch.from_numpy(contexts), negs,
                          float(np.float32(0.05)))
    _same_state(got, want)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-6)


def _device_draws(key, m, batch, window):
    """The draws of one ``_sgns_device_chunk`` step, as it derives them."""
    key, k_e, k_d, k_dir, k_neg = jax.random.split(key, 5)
    u = jax.random.uniform(k_e, (batch,))
    e = jnp.minimum((u * m).astype(jnp.int32), m - 1)
    d = jax.random.randint(k_d, (batch,), 1, window + 1)
    sign = jnp.where(jax.random.bernoulli(k_dir, 0.5, (batch,)), 1, -1)
    b = jax.random.randint(jax.random.fold_in(k_d, 1), (batch,), 1, window + 1)
    return [torch.from_numpy(np.array(a).astype(np.int64)) for a in (e, d, sign, b)], k_neg


@pytest.mark.parametrize("n_shared", [0, 16])
def test_device_chunk_step_matches_jax(n_shared):
    """One step of ``_sgns_device_chunk`` (per-pair negatives: the weighted
    step; shared negatives) against the port's acceptance rule and step fed
    the same draws.  The stream is subsampled, so draws past its end must be
    rejected as the padded reference rejects them."""
    V, D, B, N, window = 40, 8, 256, 5, 4
    js, _ = _random_stores(S=30, L=7, n_aids=V, seed=2)
    keep = np.random.default_rng(0).random(js.n_events) < 0.8
    aid_k, sidx_k = js.aid[keep].astype(np.int32), js.session_idx[keep].astype(np.int32)
    m, n = len(aid_k), js.n_events
    aid_pad, sidx_pad = np.zeros(n, np.int32), np.full(n, -1, np.int32)
    aid_pad[:m], sidx_pad[:m] = aid_k, sidx_k
    state = _state(V, D, seed=3)
    cdf = _cdf(np.bincount(js.aid, minlength=V) + 1.0)
    key = jax.random.PRNGKey(11)
    lr = np.float32(0.05)
    *want, _, wloss, wkept = jemb._sgns_device_chunk(
        *map(jnp.asarray, state), jnp.asarray(aid_pad), jnp.asarray(sidx_pad), jnp.int32(m),
        jnp.asarray(cdf), jnp.asarray([lr]), key, n_steps=1, batch=B, window=window,
        n_negatives=N, n_shared=n_shared)
    (e, d, sign, b), k_neg = _device_draws(key, m, B, window)
    centers, contexts, w = temb._accept_pairs(
        torch.from_numpy(aid_k.astype(np.int64)), torch.from_numpy(sidx_k.astype(np.int64)),
        m, e, d, sign, b)
    assert 0 < float(w.sum()) < B and float(w.sum()) == float(wkept)
    assert (centers[w == 0] == 0).all() and (contexts[w == 0] == 0).all()
    got = temb.sgns_state_from_jax(*state, device="cpu")
    tcdf = torch.from_numpy(cdf)
    if n_shared:
        negs = temb.draw_negatives(tcdf, torch.from_numpy(np.array(
            jax.random.uniform(k_neg, (n_shared,)))))
        loss = temb.sgns_shared_neg_step(*got, centers, contexts, w, negs, float(lr), N)
    else:
        negs = temb.draw_negatives(tcdf, torch.from_numpy(np.array(
            jax.random.uniform(k_neg, (B, N)))))
        loss = temb.sgns_step(*got, centers, contexts, negs, float(lr), weight=w)
    _same_state(got, want)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-5)


def test_shared_neg_step_with_overlaps_matches_jax():
    """Duplicated centers and negatives, and contexts that are also
    negatives: both ``acc_out`` adds precede the ``w_out`` updates."""
    V, D, B, Nn = 30, 8, 48, 12
    rng = np.random.default_rng(4)
    state = _state(V, D, seed=5)
    centers, contexts = _pairs("duplicates", V, B, rng)
    weight = (rng.random(B) < 0.8).astype(np.float32)
    cdf = _cdf(np.r_[np.full(4, 200.0), np.ones(V - 4)])
    key = jax.random.PRNGKey(2)
    *want, wloss = jemb._sgns_shared_neg_step(
        *map(jnp.asarray, state), jnp.asarray(centers), jnp.asarray(contexts),
        jnp.asarray(weight), jnp.asarray(cdf), jnp.float32(0.05), key, 40, Nn)
    negs = temb.draw_negatives(torch.from_numpy(cdf), torch.from_numpy(
        np.array(jax.random.uniform(key, (Nn,)))))
    assert np.isin(negs.numpy(), contexts).any() and len(np.unique(negs.numpy())) < Nn
    got = temb.sgns_state_from_jax(*state, device="cpu")
    loss = temb.sgns_shared_neg_step(*got, torch.from_numpy(centers),
                                     torch.from_numpy(contexts), torch.from_numpy(weight),
                                     negs, float(np.float32(0.05)), 40)
    _same_state(got, want)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-5)


@pytest.mark.parametrize("case", ["random", "duplicates"])
def test_hs_step_matches_jax(case):
    V, D, B = 40, 8, 64
    rng = np.random.default_rng(6)
    nodes, signs = jemb.build_huffman_paths(rng.integers(1, 60, V).astype(np.float64))
    state = _state(V, D, n_out=V - 1, seed=7)
    centers, ctx = _pairs(case, V, B, rng)
    *want, wloss = jemb._hs_step_impl(*map(jnp.asarray, state), jnp.asarray(centers),
                                      jnp.asarray(nodes[ctx]), jnp.asarray(signs[ctx]),
                                      jnp.float32(0.05))
    assert (signs[ctx] == 0).any()  # pad positions scatter zeros into node 0
    got = temb.sgns_state_from_jax(*state, device="cpu")
    loss = temb.hs_step(*got, torch.from_numpy(centers),
                        torch.from_numpy(nodes[ctx].astype(np.int64)),
                        torch.from_numpy(signs[ctx]), float(np.float32(0.05)))
    _same_state(got, want)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-6)


def test_draw_negatives_stays_in_range():
    """A float32 CDF ending below 1: ``searchsorted`` alone would return
    ``len(cdf)`` for the uniforms above its last entry."""
    cdf = np.array([0.25, 0.5, 0.75, 0.9], np.float32)
    u = np.array([0.0, 0.25, 0.3, 0.9, 0.9000001, 0.95, np.nextafter(1, 0)], np.float32)
    want = np.asarray(jnp.searchsorted(jnp.asarray(cdf), jnp.asarray(u)))
    assert want.max() == len(cdf)  # what JAX's index does: out of range
    got = temb.draw_negatives(torch.from_numpy(cdf), torch.from_numpy(u)).numpy()
    assert got.max() == len(cdf) - 1
    np.testing.assert_array_equal(got, np.minimum(want, len(cdf) - 1))
    state = temb.sgns_state_from_jax(*_state(4, 3), device="cpu")
    temb.sgns_step(*state, torch.tensor([0, 1]), torch.tensor([2, 3]),
                   temb.draw_negatives(torch.from_numpy(cdf), torch.full((2, 3), 0.99)), 0.05)
    assert all(bool(torch.isfinite(t).all()) for t in state)


# -------------------------------------------------------------- trainers ----
CFG = dict(dim=8, window=3, negatives=4, epochs=2, batch_centers=512, subsample_t=0)


def test_train_sgns_hs_matches_jax():
    """hs draws only with numpy, so the whole run follows the JAX one."""
    js, ts = _random_stores()
    cfg = dict(CFG, objective="hs")
    want = jemb.train_sgns(js, 30, JSGNSConfig(**cfg))
    got = temb.train_sgns(ts, 30, SGNSConfig(**cfg), device="cpu")
    assert got.w_out.shape == (29, 8) and got.counts.dtype == torch.float32
    np.testing.assert_allclose(got.w_in.numpy(), want.w_in, atol=1e-5)
    np.testing.assert_allclose(got.w_out.numpy(), want.w_out, atol=1e-5)
    np.testing.assert_array_equal(got.counts.numpy(), want.counts)


def test_train_sgns_ns_matches_jax_with_its_draws(monkeypatch):
    js, ts = _random_stores()
    want = jemb.train_sgns(js, 30, JSGNSConfig(**CFG))
    monkeypatch.setattr(temb, "negative_uniforms", JaxUniforms(42))
    out = {}
    got = temb.train_sgns(ts, 30, SGNSConfig(**CFG), pairs_out=out, device="cpu")
    np.testing.assert_allclose(got.w_in.numpy(), want.w_in, atol=1e-5)
    np.testing.assert_allclose(got.w_out.numpy(), want.w_out, atol=1e-5)
    assert out["steps"] % 8 == 0 and out["pairs_trained"] > 0 and out["losses"]


@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_train_sgns_learns_cluster_structure(objective, tmp_path):
    """``tests/test_embeddings.py``'s cluster checks on the port's own
    generator: within-cluster distances collapse below cross-cluster ones
    and the top neighbor is in the aid's own cluster."""
    _, ts = _cluster_stores()
    cfg = SGNSConfig(dim=8, window=4, negatives=5, epochs=15, batch_centers=8192,
                     subsample_t=0, objective=objective)
    model = temb.train_sgns(ts, 40, cfg, device="cpu")
    assert _cluster_ratio(model.embeddings, 10) < (0.6 if objective == "ns" else 0.7)
    model.save(tmp_path / "sgns.npz")
    loaded = jemb.SGNSModel.load(tmp_path / "sgns.npz")  # the JAX package reads it
    np.testing.assert_array_equal(loaded.w_in, model.w_in.numpy())
    table = model.neighbor_table(k=5, query_batch=64, block=128)
    assert np.mean(table[:, 0] // 10 == np.arange(40) // 10) > 0.9


@pytest.mark.parametrize("negatives, batch", [(5, 4096), (20, 2048)])
def test_train_sgns_device_learns_and_keeps_jax_pair_rate(negatives, batch):
    """Per-pair negatives (5) and the shared-negative default (20 >= 16:
    batch // 8 shared): the cluster structure, and the kept pairs against
    the JAX sampler's on the same store and step count, within 5 standard
    deviations of the difference of two binomial counts."""
    js, ts = _cluster_stores(seed=1)
    cfg = dict(dim=8, window=4, negatives=negatives, epochs=4, batch_centers=batch,
               subsample_t=0)
    out, jout = {}, {}
    model = temb.train_sgns_device(ts, 40, SGNSConfig(**cfg), steps_per_dispatch=8,
                                   pairs_out=out, device="cpu")
    assert out["shared_negatives"] == (batch // 8 if negatives >= 16 else 0)
    assert np.isfinite(model.w_in.numpy()).all()
    assert _cluster_ratio(model.embeddings, 10) < 0.6
    jemb.train_sgns_device(js, 40, JSGNSConfig(**dict(cfg, epochs=1)), steps_per_dispatch=8,
                           pairs_out=jout)
    draws = jout["epoch_log"][0]["steps_run"] * batch
    assert [e["steps_run"] for e in out["epoch_log"]] == [draws // batch] * 4
    p = jout["pairs_trained"] / draws
    got = out["epoch_log"][0]["pairs"]
    assert abs(got - jout["pairs_trained"]) <= 5 * np.sqrt(2 * draws * p * (1 - p))


# ------------------------------------------------------ loader, checkpoint ----
@pytest.mark.parametrize("drop", [False, True])
def test_loader_matches_jax_batches(drop):
    B, G = 8, 4
    for n in (1, 7, 8, 31, 32, 33, 63, 64, 65, 96, 100):
        a, b = np.arange(n), np.arange(n) * 10
        order = np.random.default_rng(n).permutation(n)
        jl = JLoader((a, b), G * B, order=order, drop_remainder=drop)
        want = [tuple(np.asarray(x) for x in batch) for batch in jl]
        tl = BatchLoader((a, b), G * B, order=order, drop_remainder=drop, device="cpu")
        assert len(tl) == len(want) == (max(n // (G * B), 1) if drop else -(-n // (G * B)))
        got = list(tl)
        for (tx, ty), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(tx.numpy(), wx)
            np.testing.assert_array_equal(ty.numpy(), wy)


@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_checkpoint_resume_is_bit_equal(objective, tmp_path):
    """An interrupted run resumed from its checkpoint equals the
    uninterrupted one: the same host draws (replayed), the same generator
    state, the same lr schedule."""
    _, ts = _random_stores()
    cfg = SGNSConfig(**dict(CFG, epochs=4, objective=objective))
    full = temb.train_sgns(ts, 30, cfg, device="cpu")
    temb.train_sgns(ts, 30, cfg, checkpoint_dir=tmp_path / "ck", stop_after_epochs=2,
                    device="cpu")
    assert CheckpointManager(tmp_path / "ck").all_steps() == [1, 2]
    resumed = temb.train_sgns(ts, 30, cfg, checkpoint_dir=tmp_path / "ck", device="cpu")
    np.testing.assert_array_equal(resumed.w_in.numpy(), full.w_in.numpy())
    np.testing.assert_array_equal(resumed.w_out.numpy(), full.w_out.numpy())
    assert CheckpointManager(tmp_path / "ck").all_steps() == [3, 4]  # max_to_keep 2


def test_checkpoint_manager_round_trip(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=3)
    assert mgr.latest_step() is None and mgr.restore() is None
    g = torch.Generator()
    g.manual_seed(3)
    for step in range(1, 6):
        mgr.save(step, {"x": torch.full((2, 2), float(step)), "generator": g.get_state()})
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert float(mgr.restore()["x"][0, 0]) == 5.0 and float(mgr.restore(3)["x"][1, 1]) == 3.0
    g2 = torch.Generator()
    g2.set_state(mgr.restore()["generator"])
    assert torch.equal(torch.rand(4, generator=g2), torch.rand(4, generator=g))
    mgr.close()


# ---------------------------------------------------- session embeddings ----
@pytest.mark.parametrize("weighting", ["recency", "mean"])
def test_session_embeddings_match_jax(weighting):
    rng = np.random.default_rng(8)
    sess = np.repeat(np.arange(120), rng.integers(1, 30, 120))
    js, ts = _stores(sess, rng.integers(0, 60, len(sess)))
    items = rng.normal(size=(60, 16)).astype(np.float32)
    want = jemb.session_embeddings(js, items, weighting)
    got = temb.session_embeddings(ts, torch.from_numpy(items), weighting, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    with pytest.raises(ValueError):
        temb.session_embeddings(ts, items, "idf", device="cpu")


def test_session_embedding_model_lists_equal_jax():
    """``tests/test_embeddings.py``'s corpus: two aid vocabularies in
    orthogonal subspaces; the similar-session lists equal JAX's and stay
    within the query's half."""
    rng = np.random.default_rng(0)
    S, L = 200, 8
    half = (np.arange(S) % 2).repeat(L)
    aid = np.where(half == 0, rng.integers(0, 20, S * L), rng.integers(20, 40, S * L))
    js, ts = _stores(np.repeat(np.arange(S), L), aid)
    items = np.zeros((40, 8), np.float32)
    items[:20, :4] = rng.normal(size=(20, 4))
    items[20:, 4:] = rng.normal(size=(20, 4))
    want = jemb.SessionEmbeddingModel.fit(js, items).similar_session_predictions(
        js.select_sessions(np.arange(20)), n_similar=3, k=10, query_batch=32)
    model = temb.SessionEmbeddingModel.fit(ts, items, device="cpu")
    got = model.similar_session_predictions(ts.select_sessions(np.arange(20)), n_similar=3,
                                            k=10, query_batch=32)
    for t in ("clicks", "carts", "orders"):
        np.testing.assert_array_equal(got[t], want[t])
    live = got["clicks"] >= 0
    own = np.arange(20)[:, None] % 2 == 0
    assert live.any() and np.mean((got["clicks"] < 20) == own, where=live) > 0.9
