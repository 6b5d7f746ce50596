"""Run the sharded tables, sharded serving, and data-, model- and
expert-parallel training once, at tiny shapes, over every rank of a process
group: the port of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``: the sharded SGNS and MF steps, the distributed
top-k and lookup, the sharded candidate chunk and heuristic routes, the
data-parallel ranker, GBDT growth, sequence and ZeRO-1 steps, the tensor,
sequence-, pipeline- and expert-parallel transformer steps, the 3-D step
when the world size is a multiple of 4, and the expert-parallel
recommender).

    torchrun --nproc-per-node N -m otto_tpu_torch.parallel.dryrun \
        [--backend gloo] [--device cpu]

or ``python -m otto_tpu_torch.parallel.dryrun`` with the rank's environment
set (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``).  The mesh is ``(N/2) x 2`` for an even N > 1, else
``N x 1``.  NCCL is the default backend and needs a card a rank; ranks that
share a card, or CPU ranks, pass ``--backend gloo``.  The mesh is on the
cards unless ``--device cpu`` asks for CPU ranks (gloo only).  Each rank
prints one line ``dryrun rank R/N ok`` and exits 0, or raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def run(mesh, seed: int = 0) -> dict:
    """Every sharded function of this slice once on ``mesh``; returns their
    shapes and losses (the same on every rank)."""
    from otto_tpu_torch.parallel.mesh import axis_size, mesh_device, shard_rows
    from otto_tpu_torch.parallel.serving import (
        make_sharded_heuristic_routes,
        make_sharded_regular_chunk,
        pad_table_rows,
    )
    from otto_tpu_torch.parallel.sharded_embedding import (
        make_sharded_mf_step,
        make_sharded_sgns_step,
        sharded_lookup,
        sharded_topk,
    )

    dp, mp = axis_size(mesh, "data"), axis_size(mesh, "model")
    n = dp * mp
    dev = mesh_device(mesh)
    rng = np.random.default_rng(seed)
    out = {}

    # row-sharded SGNS step
    N, D = 16 * n, 8
    w_in = shard_rows(mesh, rng.uniform(-0.1, 0.1, (N, D)).astype(np.float32))
    w_out, acc_in, acc_out = (shard_rows(mesh, np.zeros((N, D), np.float32)) for _ in range(3))
    B = 4 * dp
    c = rng.integers(0, N, B)
    x = rng.integers(0, N, B)
    negs = rng.integers(0, N, (B, 4))
    *_, loss = make_sharded_sgns_step(mesh, n_negatives=4)(w_in, w_out, acc_in, acc_out, c, x,
                                                            negs, 0.05)
    out["sgns_loss"] = float(loss)

    # row-sharded matrix factorization
    Ns, Na = 12 * n, 8 * n
    ses = shard_rows(mesh, rng.uniform(-0.05, 0.05, (Ns, D)).astype(np.float32))
    aid = shard_rows(mesh, rng.uniform(-0.05, 0.05, (Na, D)).astype(np.float32))
    acc_s = shard_rows(mesh, np.zeros((Ns, D), np.float32))
    acc_a = shard_rows(mesh, np.zeros((Na, D), np.float32))
    *_, mf_loss = make_sharded_mf_step(mesh, loss="mse")(
        ses, aid, acc_s, acc_a, rng.integers(0, Ns, B), rng.integers(0, Na, B),
        rng.normal(size=B).astype(np.float32), 0.05)
    out["mf_loss"] = float(mf_loss)

    # distributed top-k and lookup
    q = rng.normal(size=(8, D)).astype(np.float32)
    s, i = sharded_topk(mesh, q, w_in, k=5, metric="euclidean")
    out["topk_shape"] = tuple(i.shape)
    out["lookup_shape"] = tuple(sharded_lookup(mesh, w_in, torch.arange(8, device=dev)).shape)

    # sharded serving: the candidate chunk and the heuristic routes
    n_aids, wide_k, L = 64, 4, 8
    S = 2 * dp
    tables = [shard_rows(mesh, pad_table_rows(
        rng.integers(-1, n_aids, (n_aids, wide_k)).astype(np.int32), mp)) for _ in range(5)]
    ft = shard_rows(mesh, pad_table_rows(rng.integers(0, n_aids, (n_aids, 4)).astype(np.int32),
                                         mp))
    aids = torch.as_tensor(rng.integers(0, n_aids, (S, L)).astype(np.int32), device=dev)
    types = torch.as_tensor(rng.integers(0, 3, (S, L)).astype(np.int8), device=dev)
    lens = torch.as_tensor(rng.integers(1, L + 1, S).astype(np.int32), device=dev)
    cand = make_sharded_regular_chunk(mesh, uniq_cap=8, wide_k=wide_k, k_covisit=16,
                                      with_ft=True, vote_cap=8)(aids, types, lens, *tables, ft)
    out["candidates_shape"] = tuple(cand["clicks"][0].shape)
    cov_fn, rec_fn = make_sharded_heuristic_routes(mesh, uniq_cap=8, narrow_k=wide_k, k=8,
                                                   with_ft=True)
    stats = torch.arange(8, dtype=torch.int32, device=dev)
    heur = cov_fn(aids, types, lens, *tables, ft, stats, stats, stats)
    rec = rec_fn(aids, types, lens, tables[0], tables[2], tables[4], ft)
    out["heuristic_shape"] = tuple(heur["orders"].shape)
    out["recency_shape"] = tuple(rec["clicks"].shape)

    out.update(_data_parallel(mesh, rng))
    out.update(_model_parallel(mesh, rng))
    losses = ("sgns_loss", "mf_loss", "ranker_loss", "sequence_loss", "zero_loss", "tp_loss",
              "tp_sp_loss", "pp_loss", "tp_moe_loss", "ep_loss") + (
                  ("d3_loss",) if "d3_loss" in out else ())
    if not all(np.isfinite(out[k]) for k in losses):
        raise RuntimeError(f"dryrun: a loss is not finite: {out}")
    want = {"topk_shape": (8, 5), "lookup_shape": (8, D), "candidates_shape": (S, 24),
            "heuristic_shape": (S, 8), "recency_shape": (S, 8), "gbdt_leaf_shape": (8,)}
    for key, shape in want.items():
        if out[key] != shape:
            raise RuntimeError(f"dryrun: {key} {out[key]}, expected {shape}")
    return out


def _data_parallel(mesh, rng) -> dict:
    """The data-parallel steps of ``dryrun_multichip`` (:113-155, :196-205)
    at its shapes: the tower step (lambdarank, AdamW), a depth-3 GBDT tree,
    a transformer sequence step and its ZeRO-1 twin (Adam)."""
    from functools import partial

    from otto_tpu_torch.config import RankerConfig, SequenceModelConfig
    from otto_tpu_torch.models.ranker import Tower, init_tower, make_optimizer
    from otto_tpu_torch.models.sequence import _tree_map, init_params
    from otto_tpu_torch.models.sequence import make_optimizer as seq_optimizer
    from otto_tpu_torch.parallel.data_parallel import (
        make_dp_gbdt_grow,
        make_dp_ranker_step,
        make_dp_sequence_step,
        make_zero_sequence_step,
        zero_init,
    )
    from otto_tpu_torch.parallel.mesh import axis_size, mesh_device

    dp, dev = axis_size(mesh, "data"), mesh_device(mesh)
    n = dp * axis_size(mesh, "model")
    out = {}
    B, C, F = 2 * dp, 16, 12
    tower = Tower(init_tower(F, (32, 16), torch.Generator().manual_seed(1))).to(dev)
    opt = make_optimizer(tower, RankerConfig(learning_rate=1e-3))
    step = make_dp_ranker_step(mesh, opt, loss_name="lambdarank")
    out["ranker_loss"] = float(step(tower, rng.normal(size=(B, C, F)).astype(np.float32),
                                    (rng.random((B, C)) < 0.2).astype(np.int8),
                                    np.ones((B, C), bool), seed=2))

    Ng, Fg, n_bins = 16 * n, 6, 16
    scalars = (0.01, 0.0, 1.0, 0.0, 0.1)
    ones = np.ones(Ng, np.float32)
    _, _, leaf, _, ids = make_dp_gbdt_grow(mesh, depth=3, n_bins=n_bins)(
        rng.integers(0, n_bins, (Ng, Fg)).astype(np.uint8), rng.normal(size=Ng).astype(np.float32),
        rng.uniform(0.1, 1.0, Ng).astype(np.float32), ones, ones, np.ones(Fg, bool), *scalars)
    out["gbdt_leaf_shape"] = tuple(leaf.shape)
    if not bool(torch.isfinite(leaf).all()) or ids.shape[0] != Ng:
        raise RuntimeError(f"dryrun: the dp tree's leaves {leaf} or leaf ids {ids.shape}")

    cfg = SequenceModelConfig(architecture="transformer", dim=16, hidden=8, max_len=6,
                              n_layers=1, n_heads=2, learning_rate=1e-3)
    Bq = 2 * dp
    batch = (rng.integers(0, 64, (Bq, 6)).astype(np.int32), np.ones((Bq, 6), bool),
             rng.integers(0, 64, Bq).astype(np.int32),
             rng.integers(0, 64, (Bq, 4)).astype(np.int32))

    def params(seed):
        p = init_params(torch.Generator().manual_seed(seed), 64, 16, 8,
                        architecture="transformer", max_len=6, n_layers=1, n_heads=2)
        return _tree_map(lambda t: t.to(dev).requires_grad_(), p)

    sp = params(3)
    out["sequence_loss"] = float(make_dp_sequence_step(mesh, seq_optimizer(sp, cfg))(sp, *batch))
    zp = params(8)
    state = zero_init(mesh, partial(torch.optim.Adam, lr=1e-3), zp)
    out["zero_loss"] = float(make_zero_sequence_step(mesh)(zp, state, *batch))
    return out


def _model_parallel(mesh, rng) -> dict:
    """The model- and expert-parallel steps of ``dryrun_multichip``
    (:158-193, :206-233) at its shapes, with Adam(1e-3): tensor-parallel with
    and without sequence parallelism, the GPipe step (2 microbatches), a
    tensor-parallel transformer with expert-parallel MoE FFNs, the 3-D step
    on a (world/4) x 2 x 2 mesh of the same ranks when the world size is a
    multiple of 4, and the expert-parallel recommender."""
    import torch.distributed as dist

    from otto_tpu_torch.models.sequence import init_params, tree_leaves
    from otto_tpu_torch.parallel.expert_parallel import (
        init_moe_recommender,
        make_ep_moe_step,
        moe_recommender_specs,
    )
    from otto_tpu_torch.parallel.mesh import axis_size, make_mesh3d
    from otto_tpu_torch.parallel.model_parallel import (
        make_pp_sequence_step,
        make_pp_tp_sequence_step,
        make_tp_sequence_step,
        pp_param_specs,
        pp_tp_param_specs,
        shard_params,
        stack_pipeline_params,
        tp_param_specs,
    )

    dp, mp = axis_size(mesh, "data"), axis_size(mesh, "model")
    Bq, Lm = 2 * dp, (2 * mp if mp > 1 else 4)  # the length divides by mp (sequence parallel)
    tgt = rng.integers(0, 64, Bq).astype(np.int32)
    negs = rng.integers(0, 64, (Bq, 4)).astype(np.int32)
    batch = (rng.integers(0, 64, (Bq, Lm)).astype(np.int32), np.ones((Bq, Lm), bool), tgt, negs)

    def seq_init(seed, dim, **kw):
        return init_params(torch.Generator().manual_seed(seed), 64, dim, dim,
                           architecture="transformer", **kw)

    def run_step(on, params, specs, make, data=batch):
        blocks = shard_params(on, params, specs)
        return float(make(torch.optim.Adam(tree_leaves(blocks), lr=1e-3))(blocks, *data))

    out = {}
    tp = seq_init(4, 2 * mp, max_len=Lm, n_layers=mp, n_heads=mp)
    for key, use_sp in (("tp_loss", False), ("tp_sp_loss", True)):
        out[key] = run_step(mesh, tp, tp_param_specs(mesh, tp),
                            lambda o: make_tp_sequence_step(mesh, o, sequence_parallel=use_sp))
    stacked = stack_pipeline_params(tp, mp)
    out["pp_loss"] = run_step(mesh, stacked, pp_param_specs(mesh, stacked),
                              lambda o: make_pp_sequence_step(mesh, o, n_micro=2))
    moe = seq_init(6, 2 * mp, max_len=Lm, n_layers=1, n_heads=mp, moe_experts=2 * mp)
    out["tp_moe_loss"] = run_step(mesh, moe, tp_param_specs(mesh, moe),
                                  lambda o: make_tp_sequence_step(mesh, o))
    world = dist.get_world_size()
    if world % 4 == 0:
        mesh3 = make_mesh3d(world // 4, 2, 2, device_type=mesh.device_type)
        stacked3 = stack_pipeline_params(seq_init(7, 4, max_len=4, n_layers=2, n_heads=2), 2)
        B3 = 2 * (world // 4)
        b3 = (rng.integers(0, 64, (B3, 4)).astype(np.int32), np.ones((B3, 4), bool),
              rng.integers(0, 64, B3).astype(np.int32),
              rng.integers(0, 64, (B3, 4)).astype(np.int32))
        out["d3_loss"] = run_step(mesh3, stacked3, pp_tp_param_specs(mesh3, stacked3),
                                  lambda o: make_pp_tp_sequence_step(mesh3, o, n_micro=2,
                                                                     sequence_parallel=True), b3)
    rec = init_moe_recommender(torch.Generator().manual_seed(5), 64, 8, 16, 2 * mp)
    pooled = (rng.integers(0, 64, (Bq, 4)).astype(np.int32), np.ones((Bq, 4), np.float32), tgt,
              negs)
    out["ep_loss"] = run_step(mesh, rec, moe_recommender_specs(mesh),
                              lambda o: make_ep_moe_step(mesh, o, capacity=Bq), pooled)
    return out


def main(argv=None) -> int:
    import torch.distributed as dist

    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.parallel.mesh import init_distributed, make_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the mesh's devices: the cards (default; raises without one), or "
                         "the CPU, taken only when asked for")
    args = ap.parse_args(argv)
    if not init_distributed(args.backend):
        print("dryrun: RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT are not set; run it "
              "under torchrun", file=sys.stderr)
        return 2
    try:
        world = dist.get_world_size()
        mp = 2 if world % 2 == 0 and world > 1 else 1
        mesh = make_mesh(MeshConfig(data_parallel=world // mp, model_parallel=mp),
                         device_type=args.device)
        out = run(mesh)
        print(f"dryrun rank {dist.get_rank()}/{world} ok {out}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
