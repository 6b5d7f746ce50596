"""The port's sharded serving (``mesh=`` on ``regular_candidates``,
``covisit_heuristic_predictions`` and ``build_covisitation``) against its
single-device calls and against ``otto_tpu``'s sharded outputs, on the CPU.

The fixture is ``tests/test_sharded_serving.py``'s: 1,500 sessions over
700 aids, the covisitation tables built by ``otto_tpu``, a seeded 45-wide
kNN table, a 4 x 2 (data x model) mesh; the build runs on 8 ``data`` ranks
with ``tests/test_covisit_build.py``'s data.  One launch of 8 ``gloo``
ranks (subprocesses of this file, a free port, a 120 s limit, no JAX in
any rank) serves both meshes.

Tolerances:
- against the port's single-device calls: candidates, scores, labels and
  heuristic lists bit-equal (the same functions on the same rows; only the
  neighbor gather is collective); the sharded build's ids equal and weights
  within 1e-5 relative (each rank's live rows merge as a chunk of their
  own, so float sums run in another order);
- against ``otto_tpu``'s sharded outputs: candidates bit-equal, scores
  within 1e-5 relative, heuristic lists bit-equal on the covisitation
  route; on the device recency route the float32 per-aid sums run in
  another order, so two aids whose float64 scores lie within 1e-5 relative
  may swap (at most 2 rows; ``tests/test_torch_heuristic.py``);
- the host routes over the mesh: bit-equal to the single-device host routes.
"""

from __future__ import annotations

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
N_AIDS = 700
STORE_KW = dict(n_sessions=1500, n_aids=N_AIDS, mean_length=14.0, n_clusters=25, seed=17)
BUILD_KW = dict(n_sessions=400, n_aids=300, mean_length=10, seed=31)
CHUNK = 256
TYPES = ("clicks", "carts", "orders")


def _port_split():
    from otto_tpu_torch.data.splits import split_by_time
    from otto_tpu_torch.data.synthetic import synthetic_events_v2

    return split_by_time(synthetic_events_v2(**STORE_KW), val_fraction=0.3, seed=2)


def _build_store():
    from otto_tpu_torch.data.synthetic import synthetic_events

    return synthetic_events(**BUILD_KW)


def _build_config():
    from otto_tpu_torch.config import CovisitConfig

    return CovisitConfig(top_k_wide=10, session_tail=20)


def _mats(d: Path):
    from otto_tpu_torch.models.covisitation import CovisitationMatrices

    return CovisitationMatrices.load(d / "mats")


def _calls(split, mats, stats_top, ft45, mesh, device):
    """Every sharded-serving call of the slice, with ``mesh`` (or None)."""
    from otto_tpu_torch.models.candidates import regular_candidates
    from otto_tpu_torch.models.covisitation import covisit_heuristic_predictions

    out = {}
    cs = regular_candidates(split.val_input, mats, ft_neighbors=ft45[:, :20],
                            labels=split.val_labels, wide_k=20, chunk_sessions=CHUNK, mesh=mesh,
                            device=device)
    for t in TYPES:
        out[f"cand_{t}"], out[f"score_{t}"] = cs.candidates[t], cs.scores[t]
        out[f"label_{t}"] = cs.labels[t]
    for tag, kw in (("ft", dict(ft_neighbors=ft45)), ("noft", {}),
                    ("host", dict(ft_neighbors=ft45, recency_host_f64=True, covisit_host=True))):
        preds = covisit_heuristic_predictions(split.val_input, mats, stats_top,
                                              chunk_sessions=CHUNK, mesh=mesh, device=device,
                                              **kw)
        for t in TYPES:
            out[f"heur_{tag}_{t}"] = preds[t]
    return out


def _build(mesh, device):
    from otto_tpu_torch.models.covisitation import build_covisitation

    mats = build_covisitation(_build_store(), 300, _build_config(), chunk_sessions=128,
                              mesh=mesh, device=device)
    return {f"build_{k}_{i}": v for k, (a, w) in mats.tables.items()
            for i, v in (("ids", a), ("w", w))}


# ---------------------------------------------------------------------------
# the ranks (this file run as a script; it imports neither jax nor otto_tpu)
# ---------------------------------------------------------------------------


def _worker(d: Path) -> None:
    import torch
    import torch.distributed as dist

    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.parallel import init_distributed, make_mesh

    torch.set_num_threads(1)
    assert init_distributed("gloo", timeout_s=100)
    m42 = make_mesh(MeshConfig(data_parallel=4, model_parallel=2), device_type="cpu")
    m81 = make_mesh(MeshConfig(data_parallel=8, model_parallel=1), device_type="cpu")
    inp = dict(np.load(d / "in.npz"))
    stats_top = {t: inp[f"stats_{t}"] for t in TYPES}
    out = _calls(_port_split(), _mats(d), stats_top, inp["ft45"], m42, None)
    out.update(_build(m81, "cpu"))
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "otto_tpu"))
    assert not bad, bad
    np.savez(d / f"rank{dist.get_rank()}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(Path(sys.argv[1]))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import torch

    from otto_tpu.config import MeshConfig
    from otto_tpu.data.splits import split_by_time
    from otto_tpu.data.synthetic import synthetic_events_v2
    from otto_tpu.models.covisitation import build_covisitation
    from otto_tpu.models.frequency import FrequencyStatistics
    from otto_tpu.parallel.mesh import make_mesh
    from otto_tpu_torch.parallel.mesh import launch_local

    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("serving")
    jsplit = split_by_time(synthetic_events_v2(**STORE_KW), val_fraction=0.3, seed=2)
    jmats = build_covisitation(jsplit.train, N_AIDS, chunk_sessions=256)
    jmats.save(d / "mats")
    stats = FrequencyStatistics.compute(jsplit.train, n_aids=N_AIDS)
    rng = np.random.default_rng(9)
    ft45 = np.argsort(rng.random((N_AIDS, N_AIDS)), axis=1)[:, 1:46].astype(np.int32)
    stats_top = {t: np.asarray(stats.top_by_type[t]) for t in TYPES}
    np.savez(d / "in.npz", ft45=ft45, **{f"stats_{t}": v for t, v in stats_top.items()})
    env = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    launch_local([sys.executable, __file__, str(d)], 8, timeout_s=120, env=env)
    outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(8)]
    split = _port_split()
    np.testing.assert_array_equal(split.val_input.aid, jsplit.val_input.aid)
    single = {**_calls(split, _mats(d), stats_top, ft45, None, "cpu"), **_build(None, "cpu")}
    return dict(outs=outs, single=single, jsplit=jsplit, jmats=jmats, stats_top=stats_top,
                ft45=ft45, split=split,
                jmesh=make_mesh(MeshConfig(data_parallel=4, model_parallel=2)))


def test_every_rank_returns_the_same(setup):
    outs = setup["outs"]
    for o in outs[1:]:
        assert o.keys() == outs[0].keys()
        for k, v in o.items():
            np.testing.assert_array_equal(v, outs[0][k], err_msg=k)


def test_sharded_candidates_bit_equal_to_single_device(setup):
    got, single = setup["outs"][0], setup["single"]
    for t in TYPES:
        for k in ("cand", "label"):
            np.testing.assert_array_equal(got[f"{k}_{t}"], single[f"{k}_{t}"])
        np.testing.assert_array_equal(got[f"score_{t}"].view(np.int32),
                                      single[f"score_{t}"].view(np.int32))


@pytest.mark.parametrize("tag", ["ft", "noft", "host"])
def test_sharded_heuristic_bit_equal_to_single_device(setup, tag):
    got, single = setup["outs"][0], setup["single"]
    for t in TYPES:
        np.testing.assert_array_equal(got[f"heur_{tag}_{t}"], single[f"heur_{tag}_{t}"],
                                      err_msg=t)


def test_sharded_candidates_equal_to_jax_sharded(setup):
    from otto_tpu.models.candidates import regular_candidates

    js = setup["jsplit"]
    want = regular_candidates(js.val_input, setup["jmats"], ft_neighbors=setup["ft45"][:, :20],
                              wide_k=20, chunk_sessions=CHUNK, mesh=setup["jmesh"])
    got = setup["outs"][0]
    for t in TYPES:
        np.testing.assert_array_equal(got[f"cand_{t}"], want.candidates[t])
        np.testing.assert_allclose(got[f"score_{t}"], want.scores[t], rtol=1e-5)


def _recency_scores(aids, types, tables, similar, etype):
    """float64 Counter of one recency-route session (the oracle's sums)."""
    from otto_tpu.eval import oracle as orc

    lo = 0.1 if etype == "clicks" else 0.5
    w = np.logspace(lo, 1, len(aids), base=2, endpoint=True) - 1
    c = Counter()
    for a, t, x in zip(aids, types, w):
        c[a] += x * orc.EVENT_TYPE_COEFFICIENT[t]
    for a in similar:
        c[a] += 0.15 if etype == "orders" else 0.05
    keep, kind = {"clicks": ((0,), "time_weighted"), "carts": ((0, 1), "cart_weighted"),
                  "orders": ((1, 2), "cart_order")}[etype]
    for q in sorted({a for a, t in zip(aids, types) if t in keep}):
        for a in tables[kind].get(q, []):
            c[a] += 0.15 if etype == "orders" else 0.05
    return c


@pytest.mark.parametrize("tag", ["ft", "noft"])
def test_sharded_heuristic_against_jax_sharded(setup, tag):
    from otto_tpu.eval import oracle as orc
    from otto_tpu.models.covisitation import covisit_heuristic_predictions
    from otto_tpu_torch.models.covisitation import session_unique_counts

    js = setup["jsplit"]
    ft = setup["ft45"] if tag == "ft" else None
    want = covisit_heuristic_predictions(js.val_input, setup["jmats"], setup["stats_top"],
                                         ft_neighbors=ft, chunk_sessions=CHUNK,
                                         mesh=setup["jmesh"])
    got = setup["outs"][0]
    target = setup["split"].val_input
    rec = session_unique_counts(target) >= 20
    assert rec.sum() >= 5 and (~rec).sum() >= 100  # both routes run
    aid_lists, type_lists = orc.store_to_lists(target)
    tables = {k: orc.table_to_dict(setup["jmats"].tables[k][0], 15)
              for k in setup["jmats"].tables}
    for t in TYPES:
        g, w = got[f"heur_{tag}_{t}"], want[t]
        np.testing.assert_array_equal(g[~rec], w[~rec])
        bad = np.flatnonzero((g != w).any(axis=1))
        assert len(bad) <= 2, bad
        for r in bad:
            similar = [] if ft is None else [int(a) for a in ft[aid_lists[r][-1]]]
            c = _recency_scores(aid_lists[r], type_lists[r], tables, similar, t)
            for a, b in zip(g[r][g[r] != w[r]], w[r][g[r] != w[r]]):
                assert abs(c[int(a)] - c[int(b)]) <= 1e-5 * max(c[int(a)], c[int(b)])


def test_sharded_build_equal_to_single_device(setup):
    from otto_tpu_torch.config import COVISIT_KINDS

    got, single = setup["outs"][0], setup["single"]
    for kind in COVISIT_KINDS:
        np.testing.assert_array_equal(got[f"build_{kind}_ids"], single[f"build_{kind}_ids"])
        np.testing.assert_allclose(got[f"build_{kind}_w"], single[f"build_{kind}_w"],
                                   rtol=1e-5)
        assert (got[f"build_{kind}_ids"] >= 0).any()


def test_sharded_build_equal_to_jax(setup):
    from otto_tpu.config import CovisitConfig, COVISIT_KINDS
    from otto_tpu.data.synthetic import synthetic_events
    from otto_tpu.models.covisitation import build_covisitation

    want = build_covisitation(synthetic_events(**BUILD_KW), n_aids=300,
                              config=CovisitConfig(top_k_wide=10, session_tail=20),
                              chunk_sessions=128)
    got = setup["outs"][0]
    for kind in COVISIT_KINDS:
        np.testing.assert_array_equal(got[f"build_{kind}_ids"], want.tables[kind][0])
        np.testing.assert_allclose(got[f"build_{kind}_w"], want.tables[kind][1], rtol=1e-5)
