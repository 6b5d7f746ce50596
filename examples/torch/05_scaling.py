"""Weak-scaling study over a process mesh on the PyTorch port (the
counterpart of ``examples/05_scaling.py``).

Measures the per-step time of the two multi-device training paths as the
mesh grows with the workload (weak scaling: problem size per device fixed):

- the data-parallel ranker step (tower replicated, batch split over
  ``data``, gradients averaged by an all-reduce);
- the row-sharded SGNS step (tables sharded over ``model``, rows gathered
  from their owners).

One process a rank, started by ``launch_local``: on the CPU one launch of
``--world`` gloo ranks serves every mesh size (a mesh takes the first n
ranks); on a card, mesh size 1 runs as one NCCL rank and the larger ones as
gloo ranks sharing the card, so their times show that the collectives run,
not how a pod of cards scales.

Run: python examples/torch/05_scaling.py [--world 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import numpy as np
import torch

from otto_tpu_torch.config import MeshConfig
from otto_tpu_torch.models.ranker import Tower, init_tower
from otto_tpu_torch.parallel.data_parallel import make_dp_ranker_step
from otto_tpu_torch.parallel.mesh import (
    in_mesh,
    init_distributed,
    launch_local,
    make_mesh,
    mesh_device,
    shard_rows,
)
from otto_tpu_torch.parallel.sharded_embedding import make_sharded_sgns_step
from otto_tpu_torch.utils.runtime import device_line, resolve_device

RESULT = "05_scaling result: "
CANDIDATES, FEATURES = 64, 52  # the ranker's candidates a session and features
DIM, NEGATIVES = 32, 8  # the SGNS table's width and negatives a pair


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=8, help="the largest mesh (a power of two)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--per-dev-batch", type=int, default=64, help="ranker sessions a device")
    ap.add_argument("--rows-per-dev", type=int, default=65_536, help="SGNS table rows a device")
    ap.add_argument("--pairs-per-dev", type=int, default=2_048)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank-backend", choices=("gloo", "nccl"), default=None,
                    help=argparse.SUPPRESS)  # set by the launcher: this process is a rank
    ap.add_argument("--sizes", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_step(step, iters: int, dev) -> float:
    """Seconds a step: one warm step, then ``iters`` timed."""
    step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step()
    float(loss)
    _sync(dev)
    return (time.perf_counter() - t0) / iters


def dp_ranker_row(args, mesh, n_dev: int) -> tuple[float, float]:
    dev = mesh_device(mesh)
    rng = np.random.default_rng(0)
    B, C, F = args.per_dev_batch * n_dev, CANDIDATES, FEATURES
    tower = Tower(init_tower(F, (256, 256, 128), torch.Generator().manual_seed(0))).to(dev)
    # optax.adamw(1e-3): weight decay 1e-4
    opt = torch.optim.AdamW(tower.parameters(), lr=1e-3, eps=1e-8, weight_decay=1e-4)
    step = make_dp_ranker_step(mesh, opt)
    x = torch.as_tensor(rng.normal(size=(B, C, F)).astype(np.float32), device=dev)
    y = torch.as_tensor((rng.random((B, C)) < 0.2).astype(np.int8), device=dev)
    m = torch.ones((B, C), dtype=torch.bool, device=dev)
    dt = time_step(lambda: step(tower, x, y, m, seed=1), args.iters, dev)
    return B * C / dt, dt


def sgns_row(args, mesh, n_dev: int) -> tuple[float, float]:
    dev = mesh_device(mesh)
    rng = np.random.default_rng(0)
    N, B, D = args.rows_per_dev * n_dev, args.pairs_per_dev * n_dev, DIM
    w_in = shard_rows(mesh, rng.uniform(-0.1, 0.1, (N, D)).astype(np.float32))
    w_out, acc_in, acc_out = (shard_rows(mesh, np.zeros((N, D), np.float32)) for _ in range(3))
    step = make_sharded_sgns_step(mesh, n_negatives=NEGATIVES)
    c = rng.integers(0, N, B).astype(np.int64)
    x = rng.integers(0, N, B).astype(np.int64)
    negs = rng.integers(0, N, (B, NEGATIVES)).astype(np.int64)
    dt = time_step(lambda: step(w_in, w_out, acc_in, acc_out, c, x, negs, 0.05)[-1],
                   args.iters, dev)
    return B / dt, dt


def rank_rows(args, sizes, device_type: str) -> dict:
    """Both studies over meshes of the first n ranks, n in ``sizes``, in a
    process group this rank has joined (every rank calls this).  Returns
    ``{"ranker": {n: (candidates/s, s a step)}, "sgns": {n: (pairs/s, s)}}``
    as this rank measured it (rank 0's is the table's)."""
    out = {"ranker": {}, "sgns": {}}
    for study, row, cfg in (("ranker", dp_ranker_row, lambda n: MeshConfig(data_parallel=n)),
                            ("sgns", sgns_row,
                             lambda n: MeshConfig(data_parallel=1, model_parallel=n))):
        for n in sizes:
            mesh = make_mesh(cfg(n), device_type=device_type, ranks=n)
            if in_mesh(mesh):
                out[study][n] = row(args, mesh, n)
            torch.distributed.barrier()
    return out


def _rank_main(args) -> dict:
    if args.device == "cpu":
        torch.set_num_threads(1)
    own = not torch.distributed.is_initialized()  # else the caller's group, left to it
    if not init_distributed(args.rank_backend, timeout_s=300):
        raise RuntimeError("--rank-backend given but no torchrun environment")
    sizes = [int(s) for s in args.sizes.split(",")]
    out = rank_rows(args, sizes, "cpu" if args.device == "cpu" else "cuda")
    if torch.distributed.get_rank() == 0:
        print(RESULT + json.dumps(out), flush=True)
    if own:
        torch.distributed.destroy_process_group()
    return out


def _launch(argv, world: int, backend: str, sizes) -> dict:
    env = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    outs = launch_local([sys.executable, str(Path(__file__).resolve()), *argv,
                         "--rank-backend", backend, "--sizes", ",".join(map(str, sizes))],
                        world, timeout_s=900, env=env)
    line = next(x for x in outs[0].splitlines() if x.startswith(RESULT))
    return json.loads(line[len(RESULT):])


def table(rows: dict, card: str, shared_card: bool = False) -> dict:
    """Print both studies as the reference's tables and return them with
    each size's efficiency (rate over n times the one-device rate).  With
    ``shared_card`` the sizes above 1 are gloo ranks sharing one card: their
    times show gloo's host staging, not scaling, so they get no efficiency."""
    out = {}
    for study, unit, title in (
            ("ranker", "candidates/s", "data-parallel ranker (fixed sessions x candidates/device)"),
            ("sgns", "pairs/s", "row-sharded SGNS (fixed rows + pairs/device)")):
        print(f"\nweak scaling — {title} ({card})")
        if shared_card:
            print("  1 = one NCCL rank on the card; more = gloo ranks sharing that one card "
                  "(host staging, not scaling: no efficiency)")
        print(f"{'devices':>8} {'step ms':>10} {unit:>15} {'efficiency':>11}")
        base, out[study] = None, {}
        for n in sorted(rows[study], key=int):
            rate, dt = rows[study][n]
            base = base or rate / int(n)
            eff = None if shared_card and int(n) > 1 else rate / (base * int(n))
            label = f"{int(n)} gloo" if shared_card and int(n) > 1 else str(int(n))
            shown = "—" if eff is None else f"{eff:.1%}"
            print(f"{label:>8} {dt * 1e3:>10.2f} {rate:>15,.0f} {shown:>11}")
            out[study][int(n)] = {"step_ms": dt * 1e3, "rate": rate, "efficiency": eff}
    return out


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    if args.rank_backend:
        return _rank_main(args)
    dev = resolve_device(args.device)
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= args.world]
    if dev.type == "cpu":
        rows = _launch(argv, args.world, "gloo", sizes)
    else:  # one NCCL rank; gloo ranks sharing the card (NCCL refuses two on one device)
        rows = _launch(argv, 1, "nccl", [1])
        if args.world > 1:
            more = _launch(argv, args.world, "gloo", sizes[1:])
            for study in rows:
                rows[study].update(more[study])
    card = device_line(dev)
    return {"device": card, **table(rows, card, shared_card=dev.type == "cuda")}


if __name__ == "__main__":
    main()
