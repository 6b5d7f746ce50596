"""The port's sequence recommenders (``otto_tpu_torch/models/sequence.py``,
``otto_tpu_torch/ops/moe.py``) against ``otto_tpu``'s, on the CPU, on
inputs made from a seed with numpy, at small widths (dim 16, hidden 32,
2 layers, 2 heads, 4 experts).

Tolerances:

- ``_training_examples``: bit-equal, clipping included;
- ``init_params``: the same tree (names, order, shapes), zeros and ones
  equal; each drawn leaf's standard deviation within 5 / sqrt(size)
  relative of the reference's draw (five standard errors);
- ``encode``, from JAX's parameters carried across: in float64 (both
  packages on float64 parameters) within 1e-12, which shows the same
  function; in float32 within rtol 1e-5 and atol 1e-6 * max(1, max |x|).
  The transformer's session vectors are O(3) (a layer-normed state through
  ``out_proj``) and each package's float32 lies ~1e-6 from the float64
  value (two layers of rounding), so the absolute floor scales with them;
- ``moe_apply`` with a capacity that drops tokens, duplicate tokens (tied
  gate scores) included: the same tokens kept, values within 1e-5;
- both losses and their gradients against ``jax.value_and_grad`` at the
  same parameters and batch: the loss within 1e-5 relative, each leaf's
  gradient within 1e-5 of its largest magnitude;
- ``full_sort_topk``: from the same session vectors, the lists equal JAX's
  ``topk_scan``; end to end, equal but where the k-th and (k+1)-th exact
  scores lie within 1e-5 relative (counted); at 600,000 aids the
  ``FusedRetriever`` route's recall against the exact scan >= 0.99;
- ``sequence_serving_predictions``: the three routes equal JAX's (the
  recency route up to swaps of aids whose float64 weights lie within 1e-5
  relative);
- npz files load in both directions, the lists equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otto_tpu.config import SequenceModelConfig as JConfig
from otto_tpu.data.events import EventStore as JStore
from otto_tpu.models import sequence as jseq
from otto_tpu.ops import moe as jmoe
from otto_tpu.ops.retrieval import topk_scan as j_topk_scan
from otto_tpu_torch import EVENT_TYPES
from otto_tpu_torch.config import SequenceModelConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.models import sequence as tseq
from otto_tpu_torch.ops import moe as tmoe
from otto_tpu_torch.ops.retrieval import topk_scan

torch.set_num_threads(1)

N, D, H, L = 150, 16, 32, 8
VARIANTS = [("gru", 0), ("narm", 0), ("stamp", 0), ("caser", 0), ("transformer", 0),
            ("transformer", 4)]
IDS = ["gru", "narm", "stamp", "caser", "transformer", "moe"]


def _configs(arch, moe, n_aids=N, max_len=L):
    kw = dict(n_aids=n_aids, dim=D, hidden=H, max_len=max_len, architecture=arch,
              n_layers=2, n_heads=2, moe_experts=moe)
    return JConfig(**kw), SequenceModelConfig(**kw)


def _jax_params(cfg, seed=1):
    return jseq.init_params(jax.random.PRNGKey(seed), cfg.n_aids, cfg.dim, cfg.hidden,
                            architecture=cfg.architecture, max_len=cfg.max_len,
                            n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                            moe_experts=cfg.moe_experts)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0, B=40, n_aids=N, max_len=L):
    """Right-padded sessions: row 0 has one event, row 1 none (all PAD)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, B)
    lens[0], lens[1] = 1, 0
    mask = np.arange(max_len)[None] < lens[:, None]
    seq = np.where(mask, rng.integers(0, n_aids, (B, max_len)), n_aids).astype(np.int32)
    return seq, mask


def _stores(sessions):
    """The same sessions as both packages' stores: ``sessions`` is a list of
    (aids, types)."""
    sess, aid, typ = [], [], []
    for i, (aids, types) in enumerate(sessions):
        sess += [i] * len(aids)
        aid += list(aids)
        typ += list(types)
    arrays = (np.array(sess), np.array(aid), np.arange(len(aid)), np.array(typ, np.int8))
    return JStore.from_flat(*arrays), EventStore.from_flat(*arrays)


def _random_sessions(seed, n_sessions, n_aids, max_events=30):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sessions):
        n = int(rng.integers(1, max_events + 1))
        out.append((rng.integers(0, n_aids, n).tolist(), rng.integers(0, 3, n).tolist()))
    return out


@pytest.mark.parametrize("max_len", [3, 20])
def test_training_examples_equal_to_jax(max_len):
    js, ts = _stores(_random_sessions(0, 60, N))
    for a, b in zip(tseq._training_examples(ts, max_len, N),
                    jseq._training_examples(js, max_len, N)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch, moe", VARIANTS, ids=IDS)
def test_init_params_match_jax_tree_and_scales(arch, moe):
    jcfg, tcfg = _configs(arch, moe, n_aids=2000)
    want = jax.tree_util.tree_flatten_with_path(_numpy(_jax_params(jcfg)))[0]
    got = tseq._config_params(tcfg, torch.Generator().manual_seed(1))
    leaves = tseq.tree_leaves(got)
    assert len(leaves) == len(want)
    for t, (path, j) in zip(leaves, want):
        assert tuple(t.shape) == j.shape, path
        assert t.dtype == torch.float32
        if j.std() == 0:  # zeros and ones
            np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))
        else:
            # two sample deviations of n draws differ by ~1/sqrt(n) relative
            assert t.numpy().std() == pytest.approx(float(j.std()), rel=5 / np.sqrt(j.size)), path


@pytest.mark.parametrize("arch, moe", VARIANTS, ids=IDS)
def test_encode_equal_to_jax(arch, moe):
    jcfg, tcfg = _configs(arch, moe)
    jp = _jax_params(jcfg)
    seq, mask = _batch()
    tp = tseq.sequence_params_from_numpy(_numpy(jp), tcfg, device="cpu")
    want = np.asarray(jax.jit(jseq.encode)(jp, jnp.asarray(seq), jnp.asarray(mask)))
    got = tseq.encode(tp, torch.from_numpy(seq), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == (len(seq), D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(want).max()))
    # the same function: float64 parameters through both
    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jp)
        want64 = np.asarray(jax.jit(jseq.encode)(jp64, jnp.asarray(seq), jnp.asarray(mask)))
    tp64 = tseq._tree_map(lambda t: t.to(torch.float64), tp)
    got64 = tseq.encode(tp64, torch.from_numpy(seq), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got64, want64, rtol=0, atol=1e-12)


def test_moe_apply_equal_to_jax_drops_included():
    rng = np.random.default_rng(3)
    T, n_experts = 96, 4
    p = _numpy(jmoe.init_moe(jax.random.PRNGKey(2), D, 4 * D, n_experts))
    p["b1"] = (rng.normal(size=p["b1"].shape) * 0.1).astype(np.float32)
    p["b2"] = (rng.normal(size=p["b2"].shape) * 0.1).astype(np.float32)
    x = rng.normal(size=(T, D)).astype(np.float32)
    mask = rng.random(T) < 0.9
    # 21 copies of one strongly gated token: tied gate scores, more than an
    # expert's capacity; the lower token indices win the slots
    x[7] = 8 * p["wg"][:, 0] / np.linalg.norm(p["wg"][:, 0])  # expert 0's, gate ~0.98
    x[40:60] = x[7]
    mask[7] = mask[40:60] = True
    cap = 12  # 96 tokens over 4 experts: most experts drop some
    want = np.asarray(jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                                     capacity=cap, model_axis=None,
                                     token_mask=jnp.asarray(mask)))
    tp = {k: torch.tensor(v) for k, v in p.items()}
    got = tmoe.moe_apply(tp, torch.from_numpy(x), capacity=cap,
                         token_mask=torch.from_numpy(mask)).numpy()
    # a dropped or masked token gets b2 alone
    kept_want = np.abs(want - p["b2"]).max(axis=1) > 0
    kept_got = np.abs(got - p["b2"]).max(axis=1) > 0
    np.testing.assert_array_equal(kept_got, kept_want)
    assert 0 < kept_want.sum() < mask.sum()  # some tokens were dropped
    # the ties went to the lower indices: 7 and 40-50 fill expert 0's 12 slots
    np.testing.assert_array_equal(np.flatnonzero(kept_want[40:60]), np.arange(11))
    assert kept_want[7]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="mesh"):  # expert parallelism needs the mesh
        tmoe.moe_apply(tp, torch.from_numpy(x), capacity=cap, model_axis="model")


def _jax_loss(name, bpr_reg=1.0):
    """The reference's loss_fn (train_sequence_model's step), standalone."""

    def loss_fn(p, seq, mask, tgt, negs):
        h = jseq.encode(p, seq, mask)
        pos_logit = jnp.sum(h * p["item_emb"][tgt], axis=1)
        neg_logit = jnp.einsum("bd,bnd->bn", h, p["item_emb"][negs])
        if name == "bpr_max":
            s = jax.nn.softmax(neg_logit, axis=1)
            p_win = jnp.sum(s * jax.nn.sigmoid(pos_logit[:, None] - neg_logit), axis=1)
            reg = jnp.sum(s * neg_logit ** 2, axis=1)
            return jnp.mean(-jnp.log(p_win + 1e-10) + bpr_reg * reg)
        logits = jnp.concatenate([pos_logit[:, None], neg_logit], axis=1)
        return -jnp.mean(jax.nn.log_softmax(logits, axis=1)[:, 0])

    return loss_fn


@pytest.mark.parametrize("loss, arch, moe", [("sampled_softmax", "gru", 0),
                                             ("bpr_max", "gru", 0),
                                             ("sampled_softmax", "transformer", 4)],
                         ids=["sampled_softmax", "bpr_max", "moe_sampled_softmax"])
def test_losses_and_gradients_equal_to_jax(loss, arch, moe):
    jcfg, tcfg = _configs(arch, moe)
    jp = _jax_params(jcfg, seed=4)
    seq, mask = _batch(seed=5, B=64)
    mask[1] = True  # every training example has a prefix
    seq[1] = 3
    rng = np.random.default_rng(6)
    tgt = rng.integers(0, N, 64).astype(np.int32)
    negs = rng.integers(0, N, (64, 24)).astype(np.int32)
    jv, jg = jax.jit(jax.value_and_grad(_jax_loss(loss, 0.5)))(
        jp, *(jnp.asarray(a) for a in (seq, mask, tgt, negs)))
    tp = tseq._tree_map(lambda t: t.requires_grad_(True),
                        tseq.sequence_params_from_numpy(_numpy(jp), tcfg, device="cpu"))
    tv = tseq.sequence_loss(tp, *(torch.from_numpy(a) for a in (seq, mask, tgt, negs)),
                            loss=loss, bpr_reg=0.5)
    tv.backward()
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-5)
    for t, j in zip(tseq.tree_leaves(tp), jax.tree_util.tree_leaves(jg)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0, atol=1e-5 * np.abs(j).max())


def _trained_params(arch, moe, n_aids=N):
    """JAX's initial parameters with the item table moved off its init
    scale, so session vectors score a spread of items."""
    jcfg, tcfg = _configs(arch, moe, n_aids=n_aids)
    p = _numpy(_jax_params(jcfg, seed=7))
    p["item_emb"] = (np.random.default_rng(8).normal(size=p["item_emb"].shape)
                     ).astype(np.float32)
    return jcfg, tcfg, p


def test_full_sort_topk_equal_to_jax():
    jcfg, tcfg, p = _trained_params("gru", 0)
    js, ts = _stores(_random_sessions(9, 300, N))
    jm = jseq.SequenceModel(jax.tree_util.tree_map(jnp.asarray, p), jcfg)
    tm = tseq.SequenceModel(tseq.sequence_params_from_numpy(p, tcfg, device="cpu"), tcfg)
    # from the same session vectors, the exact scans agree
    vecs = jm.encode_sessions(js)
    _, want = j_topk_scan(jnp.asarray(vecs), jnp.asarray(p["item_emb"][:N]), k=20,
                          block=16384, metric="dot")
    _, got = topk_scan(torch.from_numpy(vecs), torch.from_numpy(p["item_emb"][:N]), k=20,
                       block=16384, metric="dot")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # end to end: equal but at near-ties of the exact scores
    want, got = jm.full_sort_topk(js, k=20), tm.full_sort_topk(ts, k=20)
    assert got.dtype == np.int32 and got.shape == (300, 20)
    assert (got < N).all() and (got >= 0).all()  # the PAD row never comes back
    exact = vecs.astype(np.float64) @ p["item_emb"][:N].T.astype(np.float64)
    rows = np.flatnonzero((got != want).any(axis=1))
    for r in rows:
        s = np.sort(exact[r])[::-1]
        gap = np.abs(s[:20] - s[1:21]) <= 1e-5 * np.abs(s[:21]).max()
        assert gap.any(), r
    assert len(rows) <= 3, rows


def test_full_sort_topk_fused_route_recall():
    """Over 65,536 aids the lists come from the compensated FusedRetriever
    (its twins on the CPU); held to the exact scan.  The route misses an
    item that shares its 128-item window with a better one (~19 * 128 / N
    of a top-20) or that is the 7th best of its 16,384-item chunk, so a
    catalog of a few chunks loses several percent (0.93 at 70,000 aids):
    600,000 aids (37 chunks) put the expected recall near 0.996."""
    n_aids = 600_000
    cfg = SequenceModelConfig(n_aids=n_aids, dim=D, hidden=H, max_len=L)
    params = tseq._config_params(cfg, torch.Generator().manual_seed(2))
    params["item_emb"] = torch.randn(n_aids + 1, D, generator=torch.Generator().manual_seed(3))
    model = tseq.SequenceModel(params, cfg)
    _, store = _stores(_random_sessions(10, 96, n_aids))
    got = model.full_sort_topk(store, k=20)
    exact = model.session_vectors(store) @ params["item_emb"][:n_aids].T  # CPU float32
    want = torch.topk(exact, 20, dim=1).indices.numpy()
    recall = np.mean([len(set(a) & set(b)) / 20 for a, b in zip(got, want)])
    assert recall >= 0.99, recall


def _recency_weights(aids, types):
    """float64 aid-weight scores of a session (aid_weight.py:40-46,
    coefficients 1, 6, 3)."""
    n = len(aids)
    w = np.logspace(0.1, 1, n, base=2) - 1 if n > 1 else np.array([2 ** 0.1 - 1])
    c = np.array([1.0, 6.0, 3.0])[types] * w
    out = {}
    for a, v in zip(aids, c):
        out[a] = out.get(a, 0.0) + v
    return out


@pytest.mark.parametrize("with_ft", [True, False], ids=["ft_neighbors", "no_ft"])
def test_serving_routes_equal_to_jax(with_ft):
    jcfg, tcfg, p = _trained_params("gru", 0, n_aids=50)
    sessions = [(list(range(22)), [0] * 22),  # recency route
                ([5, 6], [0, 0]),  # model route
                ([7, 30], [0, 0])]  # fallback route (30 not trained)
    rng = np.random.default_rng(12)
    for _ in range(40):  # long sessions: recency route, with repeats and all types
        n = int(rng.integers(25, 300))
        sessions.append((rng.integers(0, 50, n).tolist(), rng.integers(0, 3, n).tolist()))
    sessions += _random_sessions(13, 40, 50, max_events=12)
    js, ts = _stores(sessions)
    trained = np.ones(50, bool)
    trained[[30, 31, 32]] = False
    ft = np.tile(np.arange(10, 15, dtype=np.int32), (50, 1)) if with_ft else None
    jm = jseq.SequenceModel(jax.tree_util.tree_map(jnp.asarray, p), jcfg)
    tm = tseq.SequenceModel(tseq.sequence_params_from_numpy(p, tcfg, device="cpu"), tcfg)
    want = jseq.sequence_serving_predictions(js, jm, trained, ft, k=5)
    got = tseq.sequence_serving_predictions(ts, tm, trained, ft, k=5)
    assert set(got) == set(EVENT_TYPES)
    g, w = got["clicks"], want["clicks"]
    assert g[2].tolist() == ([10, 11, 12, 13, 14] if with_ft else [-1] * 5)
    assert (g[1] >= 0).all()
    counts = np.array([len(set(a)) for a, _ in sessions])
    model_rows = counts < 20
    np.testing.assert_array_equal(g[model_rows], w[model_rows])
    for r in np.flatnonzero((g != w).any(axis=1)):
        c = _recency_weights(*sessions[r])
        for a, b in zip(g[r][g[r] != w[r]], w[r][g[r] != w[r]]):
            assert abs(c[int(a)] - c[int(b)]) <= 1e-5 * max(c[int(a)], c[int(b)]), (r, a, b)
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(got[t], g)


@pytest.mark.parametrize("arch, moe", [("caser", 0), ("transformer", 4)], ids=["caser", "moe"])
def test_npz_loads_in_both_packages(tmp_path, arch, moe):
    jcfg, tcfg, p = _trained_params(arch, moe)
    js, ts = _stores(_random_sessions(14, 50, N))
    jm = jseq.SequenceModel(jax.tree_util.tree_map(jnp.asarray, p), jcfg)
    jm.save(tmp_path / "j.npz")
    tm = tseq.SequenceModel.load(tmp_path / "j.npz", tcfg, device="cpu")
    for a, b in zip(tseq.tree_leaves(tseq.sequence_params_to_numpy(tm.params)),
                    jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(a, b)
    tm.save(tmp_path / "t.npz")
    back = jseq.SequenceModel.load(tmp_path / "t.npz", jcfg)
    lists = tm.full_sort_topk(ts, k=10)
    np.testing.assert_array_equal(lists, back.full_sort_topk(js, k=10))
    np.testing.assert_array_equal(
        lists, tseq.SequenceModel.load(tmp_path / "t.npz", tcfg, device="cpu").full_sort_topk(
            ts, k=10))
    with pytest.raises(ValueError, match="do not match"):
        tseq.SequenceModel.load(tmp_path / "t.npz", tcfg.replace(max_len=L + 1), device="cpu")
