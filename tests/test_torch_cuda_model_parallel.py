"""Model and expert parallelism on the card: each step at mesh (1, 1) in a
world-1 NCCL group in this process against the single-device step on the
card, at the dryrun's shapes (``otto_tpu_torch/parallel/dryrun.py``); and the
autograd collectives forward and backward on CUDA tensors over two
``gloo`` ranks sharing the card, against the same calls on CPU tensors.

Marked ``cuda``: without a card these tests skip.  The module imports no
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_model_parallel.py

Tolerances: the tensor-parallel, tensor+MoE and expert-parallel steps at
(1, 1) bit-equal to the single-device step (no collective runs at axis
size 1 and the products are the same); the pipelined steps (2
microbatches: the mean of two halves' losses) within 1e-5 relative in the
loss and 1e-4 * (|x| + 0.01) in the parameters; the collectives exact
(sums of small integers).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from otto_tpu_torch.config import MeshConfig

REPO = Path(__file__).resolve().parents[1]
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


def _seq_init(seed, dim, **kw):
    from otto_tpu_torch.models.sequence import init_params

    return init_params(torch.Generator().manual_seed(seed), 64, dim, dim,
                       architecture="transformer", **kw)


def _batch(seed, B=4, L=4, float_mask=False):
    rng = np.random.default_rng(seed)
    mask = np.arange(L)[None, :] < rng.integers(1, L + 1, B)[:, None]
    return [torch.as_tensor(a, device="cuda") for a in (
        rng.integers(0, 64, (B, L)).astype(np.int32),
        mask.astype(np.float32) if float_mask else mask,
        rng.integers(0, 64, B).astype(np.int32), rng.integers(0, 64, (B, 4)).astype(np.int32))]


def _single(params, batch, loss_fn=None):
    """One Adam(1e-3) step on one device: the updated tree and the loss."""
    from otto_tpu_torch.models import sequence as sq
    from otto_tpu_torch.utils.runtime import full_f32_matmul

    p = sq._tree_map(lambda t: t.to("cuda", copy=True).requires_grad_(True), params)
    opt = torch.optim.Adam(sq.tree_leaves(p), lr=1e-3)
    if loss_fn is None:
        loss = sq.train_step(p, opt, *batch)
    else:
        opt.zero_grad(set_to_none=True)
        with full_f32_matmul():
            loss = loss_fn(p, *batch)
            loss.backward()
        opt.step()
    return p, float(loss)


def _parallel(mesh, params, specs, make, batch):
    from otto_tpu_torch.models.sequence import tree_leaves
    from otto_tpu_torch.parallel.model_parallel import gather_params, shard_params

    blocks = shard_params(mesh, params, specs)
    loss = make(torch.optim.Adam(tree_leaves(blocks), lr=1e-3))(blocks, *batch)
    whole = gather_params(mesh, blocks, specs)
    if "stage_layers" in whole:
        from otto_tpu_torch.parallel.model_parallel import unstack_pipeline_params

        whole = unstack_pipeline_params(whole)
    return whole, float(loss)


def _same(a, b, exact: bool):
    from otto_tpu_torch.models.sequence import tree_leaves

    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.detach(), y.detach()
        if exact:
            assert torch.equal(x, y)
        else:
            assert bool(((x - y).abs() <= RTOL * (y.abs() + FLOOR)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["tp", "tp_sp", "tp_moe", "pp", "d3"])
def test_steps_at_one_rank_against_the_single_device_step(mesh, family):
    from otto_tpu_torch.parallel import model_parallel as mpm
    from otto_tpu_torch.parallel.mesh import make_mesh3d

    batch = _batch(1)
    if family == "tp_moe":
        params = _seq_init(6, 2, max_len=4, n_layers=1, n_heads=1, moe_experts=2)
    else:
        params = _seq_init(4, 4, max_len=4, n_layers=2, n_heads=2)
    want, want_loss = _single(params, batch)
    if family in ("tp", "tp_sp", "tp_moe"):
        got, loss = _parallel(mesh, params, mpm.tp_param_specs(mesh, params),
                              lambda o: mpm.make_tp_sequence_step(
                                  mesh, o, sequence_parallel=family == "tp_sp"), batch)
        assert loss == want_loss
        _same(got, want, exact=True)
        return
    if family == "pp":
        on, stacked = mesh, mpm.stack_pipeline_params(params, 1)
        specs = mpm.pp_param_specs(on, stacked)
        make = lambda o: mpm.make_pp_sequence_step(on, o, n_micro=2)  # noqa: E731
    else:
        on = make_mesh3d(1, 1, 1, device_type="cuda")
        stacked = mpm.stack_pipeline_params(params, 1)
        specs = mpm.pp_tp_param_specs(on, stacked)
        make = lambda o: mpm.make_pp_tp_sequence_step(on, o, n_micro=2)  # noqa: E731
    got, loss = _parallel(on, stacked, specs, make, batch)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    _same(got, want, exact=False)


@pytest.mark.cuda
def test_ep_recommender_at_one_rank_bit_equal(mesh):
    from otto_tpu_torch.parallel import expert_parallel as ep

    params = ep.init_moe_recommender(torch.Generator().manual_seed(5), 64, 8, 16, 2)
    batch = _batch(2, float_mask=True)
    want, want_loss = _single(params, batch,
                              lambda p, *b: ep.moe_recommender_loss(p, *b, capacity=4))
    got, loss = _parallel(mesh, params, ep.moe_recommender_specs(mesh),
                          lambda o: ep.make_ep_moe_step(mesh, o, capacity=4), batch)
    assert loss == want_loss
    _same(got, want, exact=True)


def _collectives_rank() -> None:
    """A rank of the collectives test: each collective forward and backward
    over mesh (1, 2) on CUDA tensors and on CPU tensors, compared."""
    import torch.distributed as dist

    from otto_tpu_torch.parallel import collectives as coll
    from otto_tpu_torch.parallel import init_distributed, make_mesh
    from otto_tpu_torch.parallel.mesh import axis_index

    assert init_distributed("gloo", timeout_s=100)
    results = {}
    for kind in ("cuda", "cpu"):
        mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=2), device_type=kind)
        m = axis_index(mesh, "model")
        for name, fn, shape in (
                ("psum", lambda x: coll.psum(mesh, x, "model"), (2, 6, 3)),
                ("gather", lambda x: coll.all_gather(mesh, x, "model", 1), (2, 6, 3)),
                ("scatter", lambda x: coll.psum_scatter(mesh, x, "model", 1), (2, 6, 3)),
                ("ppermute", lambda x: coll.ppermute(mesh, x, "model"), (2, 6, 3))):
            x = (torch.arange(36, dtype=torch.float32, device=kind).reshape(shape)
                 + 1000 * m).requires_grad_(True)
            y = fn(x)
            w = torch.arange(y.numel(), dtype=torch.float32, device=kind).reshape(y.shape) + 7 * m
            (y * w).sum().backward()
            results[(kind, name)] = (y.detach().cpu(), x.grad.cpu())
    for name in ("psum", "gather", "scatter", "ppermute"):
        for a, b in zip(results[("cuda", name)], results[("cpu", name)]):
            assert torch.equal(a, b), name
    print(f"collectives rank {dist.get_rank()} ok", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _collectives_rank()


@pytest.mark.cuda
def test_collectives_on_cuda_tensors_equal_cpu_over_two_gloo_ranks(mesh):
    from otto_tpu_torch.parallel.mesh import launch_local

    outs = launch_local([sys.executable, __file__], 2, timeout_s=120,
                        env={"PYTHONPATH": str(REPO)}, cwd=REPO)
    assert [o.strip().splitlines()[-1] for o in outs] == ["collectives rank 0 ok",
                                                           "collectives rank 1 ok"]
