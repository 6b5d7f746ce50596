"""Sharded serving and the row-sharded tables on the card: a world-1 NCCL
mesh in this process, against the single-device calls on the card.

Marked ``cuda``: without a card these tests skip.  The module imports no
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py

Tolerances: ``sharded_topk`` ids equal to ``FusedRetriever.topk`` (the same
kernels on the same table), K1 and K2 launched; candidates, scores and
heuristic lists bit-equal; the build's ids equal and weights within 1e-5
relative; the lookup bit-equal; the steps within 1e-4 * (|x| + 0.01) of
the CPU (float atomics on the card).
"""

import numpy as np
import pytest
import torch

from otto_tpu_torch import EVENT_TYPES
from otto_tpu_torch.config import MeshConfig

RTOL, FLOOR = 1e-4, 1e-2


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os

    import torch.distributed as dist

    from otto_tpu_torch.parallel import init_distributed, make_mesh
    from otto_tpu_torch.parallel.mesh import free_port

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assert init_distributed("nccl", timeout_s=120)
        yield make_mesh(MeshConfig(), device_type="cuda")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _split():
    from otto_tpu_torch.data.splits import split_by_time
    from otto_tpu_torch.data.synthetic import synthetic_events_v2

    return split_by_time(synthetic_events_v2(n_sessions=3000, n_aids=5000, mean_length=14.0,
                                             n_clusters=50, seed=17), val_fraction=0.3, seed=2)


@pytest.mark.cuda
def test_sharded_topk_launches_k1_k2_and_equals_fused_retriever(mesh):
    from otto_tpu_torch.ops import fused_retrieval, row_topk
    from otto_tpu_torch.ops.fused_retrieval import FusedRetriever
    from otto_tpu_torch.parallel import shard_rows, sharded_topk

    rng = np.random.default_rng(0)
    items = rng.standard_normal((200_000, 32), dtype=np.float32)
    q = torch.as_tensor(items[rng.choice(200_000, 512, replace=False)], device="cuda")
    for metric in ("dot", "euclidean"):
        fused_retrieval.fused_stage1.launches = row_topk.peel_rows.launches = 0
        s, i = sharded_topk(mesh, q, shard_rows(mesh, items), 21, metric=metric)
        assert fused_retrieval.fused_stage1.launches == 1 and row_topk.peel_rows.launches == 1
        ws, wi = FusedRetriever(items, metric=metric, precision="compensated",
                                device="cuda").topk(q, 21, exact_scores=True)
        assert torch.equal(i.cpu(), wi.cpu())
        assert torch.equal(s.cpu(), ws.cpu())


@pytest.mark.cuda
def test_sharded_lookup_and_steps_on_the_card(mesh):
    from otto_tpu_torch.models.matrix_factorization import sparse_step
    from otto_tpu_torch.parallel import make_sharded_mf_step, shard_rows, sharded_lookup

    rng = np.random.default_rng(1)
    table = rng.standard_normal((5000, 16), dtype=np.float32)
    idx = rng.integers(0, 5000, 300)
    got = sharded_lookup(mesh, shard_rows(mesh, table), torch.as_tensor(idx, device="cuda"))
    np.testing.assert_array_equal(got.cpu().numpy(), table[idx])

    ses = (rng.standard_normal((4000, 16)) * 0.1).astype(np.float32)
    aid = (rng.standard_normal((3000, 16)) * 0.1).astype(np.float32)
    si, ai = rng.integers(0, 4000, 4096), rng.integers(0, 3000, 4096)
    y = rng.standard_normal(4096).astype(np.float32)
    tabs = [shard_rows(mesh, ses), shard_rows(mesh, aid)]
    tabs += [torch.zeros_like(t) for t in tabs]
    *card, loss = make_sharded_mf_step(mesh, "mse")(*tabs, si, ai, y, 0.05)
    t = {"s": torch.from_numpy(ses.copy()), "a": torch.from_numpy(aid.copy())}
    a = {k: torch.zeros_like(v) for k, v in t.items()}
    want = sparse_step(t, a, (("s", 0), ("a", 1)), "mse", 0.05, torch.from_numpy(si),
                       torch.from_numpy(ai), torch.from_numpy(y))
    for c, w in zip(card, (t["s"], t["a"], a["s"], a["a"])):
        c, w = c.cpu().double(), w.double()
        assert float(((c - w).abs() / (w.abs() + FLOOR)).max()) <= RTOL
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.cuda
def test_sharded_serving_equals_single_device_on_the_card(mesh):
    from otto_tpu_torch.models.candidates import regular_candidates
    from otto_tpu_torch.models.covisitation import (
        build_covisitation,
        covisit_heuristic_predictions,
    )
    from otto_tpu_torch.models.frequency import FrequencyStatistics

    sp = _split()
    one = build_covisitation(sp.train, 5000, device="cuda")
    sharded = build_covisitation(sp.train, 5000, mesh=mesh, device="cuda")
    for kind, (ids, w) in one.tables.items():
        np.testing.assert_array_equal(sharded.tables[kind][0], ids)
        np.testing.assert_allclose(sharded.tables[kind][1], w, rtol=1e-5)
    ft = np.random.default_rng(3).integers(0, 5000, (5000, 20)).astype(np.int32)
    kw = dict(ft_neighbors=ft, chunk_sessions=512)
    a = regular_candidates(sp.val_input, one, device="cuda", **kw)
    b = regular_candidates(sp.val_input, one, mesh=mesh, device="cuda", **kw)
    stats = FrequencyStatistics.compute(sp.train, n_aids=5000, device="cuda")
    top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
    h1 = covisit_heuristic_predictions(sp.val_input, one, top, device="cuda", **kw)
    h2 = covisit_heuristic_predictions(sp.val_input, one, top, mesh=mesh, device=None, **kw)
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(a.candidates[t], b.candidates[t])
        np.testing.assert_array_equal(a.scores[t], b.scores[t])
        np.testing.assert_array_equal(h1[t], h2[t])
    with pytest.raises(ValueError, match="not this rank's device"):
        regular_candidates(sp.val_input, one, mesh=mesh, device="cpu")
