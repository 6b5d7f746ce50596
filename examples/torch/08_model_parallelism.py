"""Model-parallelism walkthrough on the PyTorch port (the counterpart of
``examples/08_model_parallelism.py``): train the session transformer under
every sharding strategy the port supports and confirm they optimize the
same objective.

Strategies (one ``--dp`` x ``--mp`` mesh, one process a rank):

- dp     — data parallel (parameters replicated, gradients averaged)
- tp     — Megatron tensor parallel (heads and FFN hidden sharded)
- tp+sp  — tensor + sequence parallel (sequence-sharded LN/residual
           regions, all-gather / reduce-scatter pairs)
- pp     — GPipe pipeline (layer stages, microbatches)
- zero-1 — data parallel with the Adam state sharded over every rank
- 3d     — data x pipeline x tensor (``--mesh3d``) in one step
- ep     — expert-parallel MoE recommender (one expert group per shard)

The ranks are started by ``launch_local``: gloo on the CPU; on a card NCCL
when the mesh is one rank, else gloo ranks sharing the card (NCCL refuses
two ranks on one device).

Run: python examples/torch/08_model_parallelism.py [--dp 2 --mp 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import numpy as np
import torch

from otto_tpu_torch.config import MeshConfig
from otto_tpu_torch.data.synthetic import synthetic_events
from otto_tpu_torch.models.sequence import _training_examples, _tree_map, init_params, tree_leaves
from otto_tpu_torch.parallel.data_parallel import (
    make_dp_sequence_step,
    make_zero_sequence_step,
    zero_init,
)
from otto_tpu_torch.parallel.expert_parallel import (
    init_moe_recommender,
    make_ep_moe_step,
    moe_recommender_specs,
)
from otto_tpu_torch.parallel.mesh import (
    init_distributed,
    launch_local,
    make_mesh,
    make_mesh3d,
    mesh_device,
)
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
from otto_tpu_torch.utils.runtime import device_line, resolve_device

RESULT = "08_model_parallelism result: "
SAME_OBJECTIVE = ("dp", "tp", "tp+sp", "pp", "zero", "3d")
SPREAD = 0.05  # the final losses of SAME_OBJECTIVE lie within this of each other
DIM, MAX_LEN, NEGATIVES = 32, 16, 8  # the transformer's width, window and negatives
LAYERS, HEADS, EXPERTS = 4, 8, 8


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--mp", type=int, default=4)
    ap.add_argument("--mesh3d", default="2,2,2", help="data,pipe,model of the 3-D step")
    ap.add_argument("--aids", type=int, default=2_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--sessions", type=int, default=4_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank-backend", choices=("gloo", "nccl"), default=None,
                    help=argparse.SUPPRESS)  # set by the launcher: this process is a rank
    return ap.parse_args(argv)


def rank_results(args, device_type: str) -> dict:
    """Every strategy's first and last loss, in a process group of at least
    dp x mp ranks (and the 3-D mesh's) that this rank has joined; every rank
    calls this."""
    V, D, L, B, NEG = args.aids, DIM, MAX_LEN, args.batch, NEGATIVES
    store = synthetic_events(n_sessions=args.sessions, n_aids=V, mean_length=8.0, seed=0)
    seqs, masks, tgts = _training_examples(store, L, V)
    mesh = make_mesh(MeshConfig(data_parallel=args.dp, model_parallel=args.mp),
                     device_type=device_type, ranks=args.dp * args.mp)
    d3, p3, t3 = (int(x) for x in args.mesh3d.split(","))
    mesh3 = make_mesh3d(d3, p3, t3, device_type=device_type)
    dev = mesh_device(mesh)
    params0 = init_params(torch.Generator().manual_seed(0), V, D, D, architecture="transformer",
                          max_len=L, n_layers=LAYERS, n_heads=HEADS)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(args.steps):
        sel = rng.integers(0, len(tgts), B)
        batches.append([torch.as_tensor(a, device=dev) for a in (
            seqs[sel], masks[sel], tgts[sel], rng.integers(0, V, (B, NEG)).astype(np.int32))])

    def adam(leaves):
        return torch.optim.Adam(leaves, lr=3e-3)  # optax.adam(3e-3)

    def fresh(tree):
        return _tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(True), tree)

    def train(name, make_step, p, steps_batches=batches):
        step = make_step(adam(tree_leaves(p)))
        losses = [float(step(p, *batch)) for batch in steps_batches]
        print(f"{name:8s} loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
        return {"first": losses[0], "last": losses[-1]}

    res = {"mesh": [args.dp, args.mp], "mesh3d": [d3, p3, t3]}
    res["dp"] = train("dp", lambda o: make_dp_sequence_step(mesh, o), fresh(params0))
    res["tp"] = train("tp", lambda o: make_tp_sequence_step(mesh, o),
                      shard_params(mesh, params0, tp_param_specs(mesh, params0)))
    res["tp+sp"] = train("tp+sp",
                         lambda o: make_tp_sequence_step(mesh, o, sequence_parallel=True),
                         shard_params(mesh, params0, tp_param_specs(mesh, params0)))
    stacked = stack_pipeline_params(params0, args.mp)
    res["pp"] = train("pp", lambda o: make_pp_sequence_step(mesh, o, n_micro=4),
                      shard_params(mesh, stacked, pp_param_specs(mesh, stacked)))

    # ZeRO-1: the dp step's math with the Adam state sharded over every rank
    zmesh = make_mesh(MeshConfig(data_parallel=args.dp * args.mp), device_type=device_type,
                      ranks=args.dp * args.mp)
    p = fresh(params0)
    state = zero_init(zmesh, functools.partial(torch.optim.Adam, lr=3e-3), p)
    zstep = make_zero_sequence_step(zmesh)
    losses = [float(zstep(p, state, *batch)) for batch in batches]
    print(f"{'zero-1':8s} loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    res["zero"] = {"first": losses[0], "last": losses[-1]}

    stacked3 = stack_pipeline_params(params0, p3)
    res["3d"] = train("3d", lambda o: make_pp_tp_sequence_step(
        mesh3, o, n_micro=4, sequence_parallel=t3 > 1),
        shard_params(mesh3, stacked3, pp_tp_param_specs(mesh3, stacked3)))

    moe0 = init_moe_recommender(torch.Generator().manual_seed(1), V, D, 4 * D, EXPERTS)
    ep_batches = [[s, m.float(), t, n] for s, m, t, n in batches]
    res["ep"] = train("ep(moe)", lambda o: make_ep_moe_step(mesh, o, capacity=B),
                      shard_params(mesh, moe0, moe_recommender_specs(mesh)), ep_batches)

    # dp/tp/tp+sp/pp/zero/3d run the same model and land in the same band
    vals = [res[k]["last"] for k in SAME_OBJECTIVE]
    res["spread"] = max(vals) - min(vals)
    print(f"\ndp/tp/sp/pp/zero/3d final-loss spread: {res['spread']:.4f} "
          "(same objective, same init)", flush=True)
    return res


def _rank_main(args) -> dict:
    if args.device == "cpu":
        torch.set_num_threads(1)
    own = not torch.distributed.is_initialized()  # else the caller's group, left to it
    if not init_distributed(args.rank_backend, timeout_s=300):
        raise RuntimeError("--rank-backend given but no torchrun environment")
    res = rank_results(args, "cpu" if args.device == "cpu" else "cuda")
    if torch.distributed.get_rank() == 0:
        print(RESULT + json.dumps(res), flush=True)
    if own:
        torch.distributed.destroy_process_group()
    return res


def check(res: dict) -> None:
    if not res["spread"] < SPREAD:
        raise RuntimeError(f"parallel strategies diverged on identical training: final-loss "
                           f"spread {res['spread']:.4f}")
    print("OK: every parallelism strategy optimizes the same objective")


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    if args.rank_backend:
        return _rank_main(args)
    dev = resolve_device(args.device)
    world = max(args.dp * args.mp, int(np.prod([int(x) for x in args.mesh3d.split(",")])))
    backend = "nccl" if dev.type == "cuda" and world == 1 else "gloo"
    outs = launch_local([sys.executable, str(Path(__file__).resolve()), *argv,
                         "--rank-backend", backend], world, timeout_s=900,
                        env={"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    print(outs[0], end="")
    res = json.loads(next(x for x in outs[0].splitlines()
                          if x.startswith(RESULT))[len(RESULT):])
    check(res)
    return {"device": device_line(dev), "backend": backend, "world": world, **res}


if __name__ == "__main__":
    main()
