"""The port's covisitation build against ``otto_tpu``.

Same seeded numpy inputs through both packages, on the CPU.

Tolerances:
- pair stream: keys and all seven weight columns bit-equal (the same float32
  operations in the same order);
- per-row reduce: keys, live flags and the six integer-weighted kinds
  bit-equal; ``time_weighted`` totals within 1e-6 relative (its fractional
  weights are summed in another order);
- tables: the six integer-weighted kinds bit-equal, ids and weights;
  ``time_weighted`` weights within 1e-5 relative, and its ids equal wherever
  the neighbouring weights of the row differ by more than 1e-5 relative
  (near-ties may swap).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from otto_tpu.config import CovisitConfig as JCovisitConfig
from otto_tpu.data.synthetic import synthetic_events_v2 as j_synth_v2
from otto_tpu.models import covisitation as jcov
from otto_tpu.ops import covisit as jops
from otto_tpu_torch.config import COVISIT_KINDS, CovisitConfig
from otto_tpu_torch.data.splits import split_by_time
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.models import covisitation as tcov
from otto_tpu_torch.ops import covisit as tops

torch.set_num_threads(1)

N_AIDS = 3000
DAY = 24 * 60 * 60
BENCH = Path(__file__).resolve().parent.parent / "artifacts" / "bench_e2e"


def _chunk(seed, S=16, T=12, n_aids=40):
    rng = np.random.default_rng(seed)
    aids = rng.integers(0, n_aids, (S, T)).astype(np.int32)
    types = rng.integers(0, 3, (S, T)).astype(np.int8)
    rel_ts = np.sort(rng.integers(0, 20 * DAY, (S, T)), axis=1).astype(np.int32)
    lens = rng.integers(0, T + 1, S)
    mask = np.arange(T)[None, :] < lens[:, None]
    return aids, types, rel_ts, mask


def test_pair_stream_reduce_and_compaction_match_jax():
    import jax.numpy as jnp

    n_aids = 40
    aids, types, rel_ts, mask = _chunk(0, n_aids=n_aids)
    S, T = aids.shape
    span, mult = 20 * DAY - 7, np.array([1.0, 6.0, 3.0], np.float32)
    jx, jy, jw = map(np.asarray, jops.pair_stream(
        jnp.asarray(aids), jnp.asarray(types), jnp.asarray(rel_ts), jnp.asarray(mask), n_aids,
        jnp.float32(span), jnp.asarray(mult), jnp.int32(DAY), jnp.int32(14 * DAY)))
    tk, tw = tops.pair_stream(torch.from_numpy(aids), torch.from_numpy(types),
                              torch.from_numpy(rel_ts), torch.from_numpy(mask), n_aids,
                              float(span), torch.from_numpy(mult), DAY, 14 * DAY)
    np.testing.assert_array_equal(tk.numpy(), jx.astype(np.int64) * n_aids + jy)
    np.testing.assert_array_equal(tw.numpy(), jw)
    assert (jw > 0).any(axis=1).sum() > 100  # the chunk has live pairs

    sx, sy, st, sl = map(np.asarray, jops.sort_reduce_rows(
        jx.reshape(S, T * T), jy.reshape(S, T * T), jw.reshape(S, T * T, -1)))
    rk, rt, rl = (x.numpy() for x in tops.sort_reduce_rows(
        tk.reshape(S, T * T), tw.reshape(S, T * T, -1)))
    np.testing.assert_array_equal(rl, sl)
    np.testing.assert_array_equal(rk[rl], sx[sl].astype(np.int64) * n_aids + sy[sl])
    np.testing.assert_array_equal(rt[rl][:, 1:], st[sl][:, 1:])
    np.testing.assert_allclose(rt[rl][:, 0], st[sl][:, 0], rtol=1e-6)

    cap = int(sl.sum()) + 5
    cx, cy, ct, cn = map(np.asarray, jops.compact_live(sx, sy, st, sl, cap))
    kk, kt, kn = tops.compact_live(torch.from_numpy(rk), torch.from_numpy(rt),
                                   torch.from_numpy(rl), cap)
    n = int(cn)
    assert int(kn) == n and kk.shape == (cap,) and kt.shape == (cap, 7)
    np.testing.assert_array_equal(kk.numpy()[:n], cx[:n].astype(np.int64) * n_aids + cy[:n])
    np.testing.assert_array_equal(kt.numpy()[:n, 1:], ct[:n, 1:])
    assert (kt.numpy()[n:] == 0).all() and (kk.numpy()[n:] == tops.KEY_FILL).all()


def assert_tables_match(t_mats, j_mats, kinds=COVISIT_KINDS):
    """Six integer-weighted kinds bit-equal; time_weighted modulo near-ties."""
    for kind in kinds:
        ta, tw = t_mats.tables[kind]
        ja, jw = j_mats.tables[kind]
        assert ta.dtype == np.int32 and tw.dtype == np.float32 and ta.shape == ja.shape
        if kind != "time_weighted":
            np.testing.assert_array_equal(ta, ja, err_msg=kind)
            np.testing.assert_array_equal(tw, jw, err_msg=kind)
            continue
        np.testing.assert_allclose(tw, jw, rtol=1e-5)
        near = np.zeros(jw.shape, bool)
        close = np.abs(np.diff(jw, axis=1)) <= 1e-5 * np.abs(jw[:, 1:])
        near[:, 1:] |= close
        near[:, :-1] |= close
        differ = ta != ja
        assert not (differ & ~near).any(), np.argwhere(differ & ~near)[:5]


@pytest.fixture(scope="module")
def built():
    cfg = CovisitConfig()
    store_t = synthetic_events_v2(n_sessions=2000, n_aids=N_AIDS, seed=11)
    store_j = j_synth_v2(n_sessions=2000, n_aids=N_AIDS, seed=11)
    np.testing.assert_array_equal(store_t.aid, store_j.aid)
    assert store_t.lengths.max() > cfg.session_tail  # every length bucket is used
    stats = {}
    t_mats = tcov.build_covisitation(store_t, N_AIDS, cfg, chunk_sessions=512,
                                     stats_out=stats, device="cpu")
    j_mats = jcov.build_covisitation(store_j, N_AIDS, JCovisitConfig(), chunk_sessions=512)
    return store_t, t_mats, j_mats, stats


def test_build_covisitation_matches_jax(built):
    store_t, t_mats, j_mats, stats = built
    assert set(t_mats.tables) == set(COVISIT_KINDS) and t_mats.n_aids == N_AIDS
    assert (t_mats.tables["time_weighted"][0] >= 0).sum() > 10_000
    assert_tables_match(t_mats, j_mats)
    assert set(stats) == {"dispatch_s", "drain_s", "compaction_log"}


def test_bounded_budget_build_matches_jax():
    """A budget small enough to compact and prune several times: the port's
    accumulator prunes as the reference's does (the same chunks reach it in
    the same order)."""
    store_t = synthetic_events_v2(n_sessions=400, n_aids=300, seed=12)
    store_j = j_synth_v2(n_sessions=400, n_aids=300, seed=12)
    kw = dict(chunk_sessions=64, budget_rows=3000, per_aid_cap=6)
    stats = {}
    t_mats = tcov.build_covisitation(store_t, 300, CovisitConfig(), stats_out=stats,
                                     device="cpu", **kw)
    j_mats = jcov.build_covisitation(store_j, 300, JCovisitConfig(), **kw)
    assert sum(c["pruned"] for c in stats["compaction_log"]) > 0
    assert_tables_match(t_mats, j_mats)


def test_matrices_load_jax_files_and_back(built, tmp_path):
    _, t_mats, j_mats, _ = built
    j_mats.save(tmp_path / "jax")
    loaded = tcov.CovisitationMatrices.load(tmp_path / "jax")
    assert loaded.n_aids == N_AIDS
    for kind in COVISIT_KINDS:
        for a, b in zip(loaded.tables[kind], j_mats.tables[kind]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(loaded.neighbors("cart_order", 15),
                                  j_mats.neighbors("cart_order", 15))
    t_mats.save(tmp_path / "torch")
    back = jcov.CovisitationMatrices.load(tmp_path / "torch")
    for kind in COVISIT_KINDS:
        for a, b in zip(back.tables[kind], t_mats.tables[kind]):
            np.testing.assert_array_equal(a, b)


def test_build_edge_cases():
    empty = synthetic_events_v2(n_sessions=10, n_aids=50, seed=1).select_sessions(
        np.zeros(0, np.int64))
    mats = tcov.build_covisitation(empty, 50, device="cpu")
    assert all((a == -1).all() and a.shape == (50, 50) for a, _ in mats.tables.values())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tcov.build_covisitation(empty, 50, mesh=object(), device="cpu")


@pytest.mark.slow
def test_bench_rebuild_matches_committed_tables():
    """The bench's build (``artifacts/bench_e2e/bench_fit.json``: 200,000
    sessions over 20,000 aids, ``split_by_time`` 0.5, seed 0; 100,000 train
    sessions) on the CPU against the committed tables that ``otto_tpu``
    wrote, under the tolerances of :func:`assert_tables_match`."""
    fit = json.loads((BENCH / "bench_fit.json").read_text())
    store = synthetic_events_v2(n_sessions=fit["sessions"], n_aids=fit["aids"], seed=fit["seed"])
    split = split_by_time(store, val_fraction=fit["val_fraction"], seed=fit["seed"])
    mats = tcov.build_covisitation(split.train, fit["aids"], device="cpu")
    assert_tables_match(mats, tcov.CovisitationMatrices.load(BENCH / "covisitation"))
