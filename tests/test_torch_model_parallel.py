"""The port's tensor-, sequence-, pipeline- and expert-parallel training
(``otto_tpu_torch/parallel/{collectives,model_parallel,expert_parallel}.py``)
and its sharded checkpoint, against the JAX package, on the CPU.

The port runs one process a rank: one module-scoped launch starts 8 ranks
as subprocesses of this file (``gloo``, CPU meshes, no JAX in any rank);
meshes of fewer ranks take the first ranks (``make_mesh(ranks=)``), as the
JAX suite takes ``jax.devices()[:n]``.  Every mesh shape of
``tests/test_model_parallel.py`` runs on its seeded numpy inputs with the
JAX package's ``init_params`` weights carried across; the JAX side runs in
this process on its 8 virtual CPU devices (``tests/conftest.py``), once a
module.

Tolerances:
- against the single-device oracle (JAX's ``encode`` + sampled softmax and
  one SGD(0.1) step): the JAX suite's own bar
  (``tests/test_model_parallel.py:70-71``), the loss within 1e-5 and every
  leaf within 1e-5;
- against JAX's own mesh step, one shape a family: the dp sequence step's
  bar of ``tests/test_torch_data_parallel.py``, the loss within 1e-4 and
  the parameters within 2e-4;
- the expert-parallel recommender across meshes (1, 1), (2, 4), (1, 8),
  and the pipelined MoE against a one-stage pipeline of the same
  microbatch size: the JAX suite's 1e-6 and 1e-5;
- the sharded checkpoint: the restored blocks bit-equal, the next step
  within 1e-6;
- the collectives: exact (sums of small integers).
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
V, D, L, B, NEG = 64, 16, 16, 8, 5  # tests/test_model_parallel.py:27
EP_E, EP_H, EP_L = 8, 32, 12  # :105
LR = 0.1
TP_CASES = [(2, 4, False), (2, 4, True), (4, 2, False), (8, 1, False), (1, 8, True)]
PP_CASES = [(2, 4, 2), (1, 4, 4), (2, 2, 2)]
EP_MESHES = [(1, 1), (2, 4), (1, 8)]
MOE_CASES = [(2, 4, False), (2, 4, True), (2, 2, False)]
D3_CASES = [(2, 2, 2, False, 2), (1, 2, 4, True, 2), (1, 4, 2, False, 4)]
JAX_CASES = ["tp_2x4_sp", "pp_2x4_n2", "ep_2x4", "moe_2x4", "d3_2x2x2"]
# the trees carried across: (tag, init_params kwargs)
TREES = {"base": dict(seed=0, n_layers=4, n_heads=8, moe_experts=0),
         "moe": dict(seed=1, n_layers=2, n_heads=8, moe_experts=8),
         "ppmoe": dict(seed=1, n_layers=4, n_heads=4, moe_experts=4)}


# ---------------------------------------------------------------------------
# inputs (seeded numpy, shared by both packages)
# ---------------------------------------------------------------------------


def _batch(seed: int, length: int = L, float_mask: bool = False):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, V, (B, length)).astype(np.int32)
    lens = rng.integers(1 if float_mask else 2, length + 1, B)
    mask = np.arange(length)[None, :] < lens[:, None]
    if float_mask:
        mask = mask.astype(np.float32)
    tgt = rng.integers(0, V, B).astype(np.int32)
    negs = rng.integers(0, V, (B, NEG)).astype(np.int32)
    return seq, mask, tgt, negs


def _inputs() -> dict:
    out = {}
    for tag, seed, kw in (("base", 0, {}), ("moe", 2, {}), ("ppmoe", 3, {}),
                          ("ep", 1, dict(length=EP_L, float_mask=True))):
        for k, v in zip(("seq", "mask", "tgt", "negs"), _batch(seed, **kw)):
            out[f"{tag}_{k}"] = v
    out["cap_x"] = np.random.default_rng(3).normal(size=(16, D)).astype(np.float32)
    return out


def _tree(inp: dict, tag: str):
    """The JAX package's parameter tree ``tag`` as a numpy tree."""
    import torch

    from otto_tpu_torch.models.sequence import _tree_unflatten, init_params

    kw = TREES[tag]
    template = init_params(torch.Generator().manual_seed(0), V, D, D, architecture="transformer",
                           max_len=L, n_layers=kw["n_layers"], n_heads=kw["n_heads"],
                           moe_experts=kw["moe_experts"])
    n = sum(1 for k in inp if k.startswith(f"j{tag}_"))
    return _tree_unflatten(template, [inp[f"j{tag}_{i}"] for i in range(n)])


def _ep_tree(inp: dict) -> dict:
    return {"item_emb": inp["jep_item_emb"],
            "moe": {k: inp[f"jep_moe_{k}"] for k in ("wg", "w1", "b1", "w2", "b2")}}


def _batch_of(inp: dict, tag: str):
    return tuple(inp[f"{tag}_{k}"] for k in ("seq", "mask", "tgt", "negs"))


# ---------------------------------------------------------------------------
# the ranks (this file run as a script; it imports neither jax nor otto_tpu)
# ---------------------------------------------------------------------------


def _leaves_out(key: str, whole, loss) -> dict:
    from otto_tpu_torch.models.sequence import tree_leaves

    out = {f"{key}_loss": np.float32(loss)}
    for i, t in enumerate(tree_leaves(whole)):
        out[f"{key}_{i}"] = t.cpu().numpy()
    return out


def _train(mesh, params, specs, step_fn, batch) -> tuple:
    """One SGD(0.1) step of the rank's blocks; the whole updated tree."""
    import torch

    from otto_tpu_torch.models.sequence import tree_leaves
    from otto_tpu_torch.parallel.model_parallel import gather_params, shard_params

    blocks = shard_params(mesh, params, specs)
    loss = step_fn(torch.optim.SGD(tree_leaves(blocks), lr=LR))(blocks, *batch)
    return gather_params(mesh, blocks, specs), float(loss)


def _mesh(dp: int, mp: int):
    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), device_type="cpu",
                     ranks=dp * mp)


def _rank_tp(inp) -> dict:
    from otto_tpu_torch.parallel.mesh import in_mesh
    from otto_tpu_torch.parallel.model_parallel import make_tp_sequence_step, tp_param_specs

    out = {}
    cases = [("tp", "base", dp, mp, sp, False) for dp, mp, sp in TP_CASES]
    cases += [("tp", "base", 2, 4, False, True)]
    cases += [("moe", "moe", dp, mp, sp, False) for dp, mp, sp in MOE_CASES]
    for fam, tag, dp, mp, sp, remat in cases:
        mesh = _mesh(dp, mp)
        if not in_mesh(mesh):
            continue
        params = _tree(inp, tag)
        whole, loss = _train(
            mesh, params, tp_param_specs(mesh, params),
            lambda opt: make_tp_sequence_step(mesh, opt, sequence_parallel=sp, remat=remat),
            _batch_of(inp, tag))
        key = f"{fam}_{dp}x{mp}" + ("_sp" if sp else "") + ("_remat" if remat else "")
        out.update(_leaves_out(key, whole, loss))
    return out


def _rank_pp(inp) -> dict:
    from otto_tpu_torch.parallel.mesh import in_mesh, make_mesh3d
    from otto_tpu_torch.parallel.model_parallel import (
        make_pp_sequence_step,
        make_pp_tp_sequence_step,
        pp_param_specs,
        pp_tp_param_specs,
        stack_pipeline_params,
    )

    out = {}
    cases = [("pp", "base", dp, mp, n, False) for dp, mp, n in PP_CASES]
    cases += [("pp", "base", 2, 4, 2, True), ("ppmoe", "ppmoe", 2, 4, 2, False),
              ("ppmoe", "ppmoe", 1, 1, 4, False)]
    for fam, tag, dp, mp, n_micro, remat in cases:
        mesh = _mesh(dp, mp)
        if not in_mesh(mesh):
            continue
        stacked = stack_pipeline_params(_tree(inp, tag), mp)
        whole, loss = _train(
            mesh, stacked, pp_param_specs(mesh, stacked),
            lambda opt: make_pp_sequence_step(mesh, opt, n_micro=n_micro, remat=remat),
            _batch_of(inp, tag))
        key = f"{fam}_{dp}x{mp}_n{n_micro}" + ("_remat" if remat else "")
        out.update(_leaves_out(key, whole, loss))
    for dp, pp, tp, sp, n_micro, remat in [(*c, False) for c in D3_CASES] + \
            [(2, 2, 2, False, 2, True)]:
        mesh = make_mesh3d(dp, pp, tp, device_type="cpu")
        stacked = stack_pipeline_params(_tree(inp, "base"), pp)
        whole, loss = _train(
            mesh, stacked, pp_tp_param_specs(mesh, stacked),
            lambda opt: make_pp_tp_sequence_step(mesh, opt, n_micro=n_micro,
                                                 sequence_parallel=sp, remat=remat),
            _batch_of(inp, "base"))
        key = f"d3_{dp}x{pp}x{tp}" + ("_sp" if sp else "") + ("_remat" if remat else "")
        out.update(_leaves_out(key, whole, loss))
    return out


def _rank_ep(inp) -> dict:
    import torch

    from otto_tpu_torch.ops.moe import moe_apply, moe_param_specs
    from otto_tpu_torch.parallel.expert_parallel import (
        make_ep_moe_step,
        moe_recommender_from_numpy,
        moe_recommender_specs,
    )
    from otto_tpu_torch.parallel.mesh import in_mesh
    from otto_tpu_torch.parallel.model_parallel import shard_params

    out = {}
    for dp, mp in EP_MESHES:
        mesh = _mesh(dp, mp)
        if not in_mesh(mesh):
            continue
        params = moe_recommender_from_numpy(_ep_tree(inp), device="cpu")
        whole, loss = _train(mesh, params, moe_recommender_specs(mesh),
                             lambda opt: make_ep_moe_step(mesh, opt, capacity=B),
                             _batch_of(inp, "ep"))
        out.update(_leaves_out(f"ep_{dp}x{mp}", whole, loss))
    mesh = _mesh(1, 4)
    if in_mesh(mesh):
        p = shard_params(mesh, {k: inp[f"jcap_{k}"] for k in ("wg", "w1", "b1", "w2", "b2")},
                         moe_param_specs(mesh))
        x = torch.from_numpy(inp["cap_x"])
        with torch.no_grad():
            for cap in (16, 1):
                out[f"cap_1x4_{cap}"] = moe_apply(p, x, capacity=cap, model_axis="model",
                                              mesh=mesh).numpy()
    return out


def _rank_checkpoint(inp, d: Path) -> dict:
    """tp-sharded blocks saved whole and restored onto a (2, 4) layout
    template, then one more step from each."""
    import torch

    from otto_tpu_torch.models.sequence import _tree_map, tree_leaves
    from otto_tpu_torch.parallel.model_parallel import (
        make_tp_sequence_step,
        shard_params,
        tp_param_specs,
        with_layout,
    )
    from otto_tpu_torch.utils.checkpoint import CheckpointManager

    mesh = _mesh(2, 4)
    params = _tree(inp, "base")
    specs = tp_param_specs(mesh, params)
    batch = _batch_of(inp, "base")

    def step(p):
        return float(make_tp_sequence_step(mesh, torch.optim.SGD(tree_leaves(p), lr=LR))(
            p, *batch))

    p1 = shard_params(mesh, params, specs)
    step(p1)
    mgr = CheckpointManager(d / "ckpt")
    mgr.save(1, {"params": with_layout(mesh, p1, specs)})
    zeros = shard_params(mesh, _tree_map(np.zeros_like, params), specs)
    restored = mgr.restore(1, template={"params": with_layout(mesh, zeros, specs)})["params"]
    mgr.close()
    out = {"ckpt_bit_equal": np.asarray(all(
        torch.equal(a.detach(), b) for a, b in zip(tree_leaves(p1), tree_leaves(restored)))),
        "ckpt_shapes_equal": np.asarray([tuple(a.shape) == tuple(b.shape) for a, b in
                                         zip(tree_leaves(p1), tree_leaves(restored))])}
    again = _tree_map(lambda t: t.detach().clone().requires_grad_(True), p1)
    restored = _tree_map(lambda t: t.requires_grad_(True), restored)
    la, lb = step(again), step(restored)
    out["ckpt_loss_diff"] = np.float32(abs(la - lb))
    out["ckpt_leaf_diff"] = np.float32(max(float((a - b).abs().max()) for a, b in
                                           zip(tree_leaves(again), tree_leaves(restored))))
    return out


def _rank_collectives() -> dict:
    """Each collective forward and backward on the (2, 4) mesh's ``model``
    axis, on tensors of small integers that name the rank."""
    import torch

    from otto_tpu_torch.parallel import collectives as coll
    from otto_tpu_torch.parallel.mesh import axis_index

    mesh = _mesh(2, 4)
    m = axis_index(mesh, "model")
    out = {}
    for name, fn, shape in (
            ("psum", lambda x: coll.psum(mesh, x, "model"), (2, 8, 3)),
            ("gather", lambda x: coll.all_gather(mesh, x, "model", 1), (2, 8, 3)),
            ("scatter", lambda x: coll.psum_scatter(mesh, x, "model", 1), (2, 32, 3)),
            ("ppermute", lambda x: coll.ppermute(mesh, x, "model"), (2, 8, 3))):
        x = (torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
             + 1000 * m).requires_grad_(True)
        y = fn(x)
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) + 100 * m
        (y * w).sum().backward()
        out[f"coll_{name}_y"] = y.detach().numpy()
        out[f"coll_{name}_grad"] = x.grad.numpy()
    return out


def _worker(d: Path) -> None:
    import torch
    import torch.distributed as dist

    from otto_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    assert init_distributed("gloo", timeout_s=100)
    inp = dict(np.load(d / "in.npz"))
    out = {}
    out.update(_rank_collectives())
    out.update(_rank_tp(inp))
    out.update(_rank_pp(inp))
    out.update(_rank_ep(inp))
    out.update(_rank_checkpoint(inp, d))
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "otto_tpu"))
    assert not bad, bad
    np.savez(d / f"rank{dist.get_rank()}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(Path(sys.argv[1]))


# ---------------------------------------------------------------------------
# the JAX side (this process)
# ---------------------------------------------------------------------------


def _jax_trees():
    import jax

    from otto_tpu.models.sequence import init_params
    from otto_tpu.ops.moe import init_moe
    from otto_tpu.parallel.expert_parallel import init_moe_recommender

    trees = {tag: init_params(jax.random.PRNGKey(kw["seed"]), V, D, D, architecture="transformer",
                              max_len=L, n_layers=kw["n_layers"], n_heads=kw["n_heads"],
                              moe_experts=kw["moe_experts"])
             for tag, kw in TREES.items()}
    trees["ep"] = init_moe_recommender(jax.random.PRNGKey(0), V, D, EP_H, EP_E)
    trees["cap"] = init_moe(jax.random.PRNGKey(2), D, 32, 4)
    return trees


def _oracle(params, batch):
    """The single-device step: JAX's encode + sampled softmax, SGD(0.1)
    (the gradient jitted: one program instead of an op at a time)."""
    import jax
    import jax.numpy as jnp
    import optax

    from otto_tpu.models.sequence import encode
    from otto_tpu.parallel.model_parallel import _sampled_softmax

    seq, mask, tgt, negs = (jnp.asarray(a) for a in batch)
    opt = optax.sgd(LR)

    def loss_fn(p):
        return _sampled_softmax(encode(p, seq, mask), p["item_emb"], tgt, negs)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    new = optax.apply_updates(params, opt.update(grads, opt.init(params), params)[0])
    return float(loss), new


def _jax_mesh_steps(trees, inp) -> dict:
    """JAX's own mesh step, one shape a family."""
    import jax
    import jax.numpy as jnp
    import optax

    from otto_tpu.config import MeshConfig
    from otto_tpu.parallel.expert_parallel import make_ep_moe_step, moe_recommender_specs
    from otto_tpu.parallel.mesh import make_mesh, make_mesh3d
    from otto_tpu.parallel.model_parallel import (
        make_pp_sequence_step,
        make_pp_tp_sequence_step,
        make_tp_sequence_step,
        pp_param_specs,
        pp_tp_param_specs,
        shard_params,
        stack_pipeline_params,
        tp_param_specs,
    )

    opt = optax.sgd(LR)
    mesh24 = make_mesh(MeshConfig(data_parallel=2, model_parallel=4))

    def copy(t):
        return jax.tree.map(lambda a: jnp.array(a, copy=True), t)

    def run(step, p, tag):
        p2, _, loss = step(p, opt.init(p), *(jnp.asarray(a) for a in _batch_of(inp, tag)))
        return float(loss), p2

    out = {}
    base = trees["base"]
    out["tp_2x4_sp"] = run(make_tp_sequence_step(mesh24, opt, sequence_parallel=True),
                           shard_params(mesh24, copy(base), tp_param_specs(base)), "base")
    st = stack_pipeline_params(base, 4)
    out["pp_2x4_n2"] = run(make_pp_sequence_step(mesh24, opt, n_micro=2),
                           shard_params(mesh24, copy(st), pp_param_specs(st)), "base")
    out["ep_2x4"] = run(make_ep_moe_step(mesh24, opt, capacity=B),
                        shard_params(mesh24, copy(trees["ep"]), moe_recommender_specs()), "ep")
    out["moe_2x4"] = run(make_tp_sequence_step(mesh24, opt),
                         shard_params(mesh24, copy(trees["moe"]), tp_param_specs(trees["moe"])),
                         "moe")
    mesh3 = make_mesh3d(2, 2, 2)
    st = stack_pipeline_params(base, 2)
    out["d3_2x2x2"] = run(make_pp_tp_sequence_step(mesh3, opt, n_micro=2),
                          shard_params(mesh3, copy(st), pp_tp_param_specs(st)), "base")
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax

    from otto_tpu.parallel.model_parallel import stack_pipeline_params
    from otto_tpu_torch.parallel.mesh import launch_local

    d = tmp_path_factory.mktemp("mp")
    inp = _inputs()
    trees = _jax_trees()
    for tag in ("base", "moe", "ppmoe"):
        for i, leaf in enumerate(jax.tree_util.tree_leaves(trees[tag])):
            inp[f"j{tag}_{i}"] = np.asarray(leaf)
    inp["jep_item_emb"] = np.asarray(trees["ep"]["item_emb"])
    for k, v in trees["ep"]["moe"].items():
        inp[f"jep_moe_{k}"] = np.asarray(v)
    for k, v in trees["cap"].items():
        inp[f"jcap_{k}"] = np.asarray(v)
    np.savez(d / "in.npz", **inp)
    env = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    # the ranks run while this process computes the JAX side
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch_local, [sys.executable, __file__, str(d)], 8,
                            timeout_s=150, env=env)
        oracles = {tag: _oracle(trees[tag], _batch_of(inp, tag)) for tag in ("base", "moe")}
        jax_mesh = _jax_mesh_steps(trees, inp)
        ranks.result()
    outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(8)]
    return dict(inp=inp, trees=trees, outs=outs, out=outs[0], oracles=oracles,
                stack=stack_pipeline_params, jax_mesh=jax_mesh)


def _got(out: dict, key: str):
    n = sum(1 for k in out if k.startswith(f"{key}_") and k[len(key) + 1:].isdigit())
    return float(out[f"{key}_loss"]), [out[f"{key}_{i}"] for i in range(n)]


def _assert_close(got, loss: float, tree, tol_loss: float, tol: float, key: str) -> None:
    import jax

    got_loss, leaves = got
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    assert len(leaves) == len(want), key
    assert abs(got_loss - loss) < tol_loss, (key, got_loss, loss)
    for i, (a, b) in enumerate(zip(leaves, want)):
        assert a.shape == b.shape, (key, i)
        assert np.abs(a - b).max() < tol, (key, i, float(np.abs(a - b).max()))


@pytest.mark.parametrize("dp,mp,sp", TP_CASES)
def test_tp_matches_single_device(run, dp, mp, sp):
    loss, new = run["oracles"]["base"]
    key = f"tp_{dp}x{mp}" + ("_sp" if sp else "")
    _assert_close(_got(run["out"], key), loss, new, 1e-5, 1e-5, key)


@pytest.mark.parametrize("dp,mp,n_micro", PP_CASES)
def test_pp_matches_single_device(run, dp, mp, n_micro):
    loss, new = run["oracles"]["base"]
    key = f"pp_{dp}x{mp}_n{n_micro}"
    _assert_close(_got(run["out"], key), loss, run["stack"](new, mp), 1e-5, 1e-5, key)


def test_stack_pipeline_params_roundtrip(run):
    import torch

    from otto_tpu.parallel.model_parallel import stack_pipeline_params as jstack
    from otto_tpu_torch.models.sequence import _tree_map, tree_leaves
    from otto_tpu_torch.parallel.model_parallel import (
        stack_pipeline_params,
        unstack_pipeline_params,
    )

    params = _tree(run["inp"], "base")
    stacked = stack_pipeline_params(params, 2)
    lw = stacked["stage_layers"]["ffn_w1"]
    assert lw.shape == (2, 2, D, 4 * D)
    np.testing.assert_array_equal(lw[1, 0], params["layers"][2]["ffn_w1"])
    want = jstack(run["trees"]["base"], 2)["stage_layers"]
    for k in ("wq", "wo", "ffn_w2"):
        np.testing.assert_array_equal(stacked["stage_layers"][k], np.asarray(want[k]))
    np.testing.assert_array_equal(stacked["stage_layers"]["ln1"]["scale"],
                                  np.asarray(want["ln1"]["scale"]))
    tensors = stack_pipeline_params(_tree_map(torch.tensor, params), 2)
    assert torch.equal(tensors["stage_layers"]["ffn_w1"], torch.from_numpy(lw))
    back = unstack_pipeline_params(tensors)
    assert len(back["layers"]) == 4
    for a, b in zip(tree_leaves(back), tree_leaves(_tree_map(torch.tensor, params))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        stack_pipeline_params(params, 3)


def test_ep_moe_mesh_invariance(run):
    out = run["out"]
    ref_loss, ref = _got(out, "ep_1x1")
    assert np.isfinite(ref_loss)
    for dp, mp in EP_MESHES:
        loss, leaves = _got(out, f"ep_{dp}x{mp}")
        assert abs(loss - ref_loss) < 1e-6, (dp, mp)
        assert max(float(np.abs(a - b).max()) for a, b in zip(leaves, ref)) < 1e-6, (dp, mp)


def test_sharded_checkpoint_roundtrip(run):
    for o in run["outs"]:  # each rank's blocks
        assert bool(o["ckpt_bit_equal"]) and o["ckpt_shapes_equal"].all()
        assert o["ckpt_loss_diff"] < 1e-6 and o["ckpt_leaf_diff"] < 1e-6


def test_ep_moe_capacity_drops_tokens(run):
    import torch

    from otto_tpu_torch.ops.moe import moe_apply

    out = run["out"]
    full, capped = out["cap_1x4_16"], out["cap_1x4_1"]
    assert np.isfinite(full).all() and np.isfinite(capped).all()
    assert np.abs(full - capped).max() > 1e-6
    p = {k: torch.tensor(run["inp"][f"jcap_{k}"]) for k in ("wg", "w1", "b1", "w2", "b2")}
    x = torch.tensor(run["inp"]["cap_x"])
    for cap in (16, 1):  # the experts split over 4 ranks: the single-device FFN
        np.testing.assert_allclose(out[f"cap_1x4_{cap}"], moe_apply(p, x, capacity=cap).numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("dp,mp,sp", MOE_CASES)
def test_tp_moe_transformer_matches_single_device(run, dp, mp, sp):
    loss, new = run["oracles"]["moe"]
    key = f"moe_{dp}x{mp}" + ("_sp" if sp else "")
    _assert_close(_got(run["out"], key), loss, new, 1e-5, 1e-5, key)


def test_pp_moe_transformer_matches_matched_groups(run):
    """Routing and capacity are a microbatch's: a (2, 4) pipeline with 2
    microbatches a data block against one stage with 4 of the same size."""
    loss_pp, leaves_pp = _got(run["out"], "ppmoe_2x4_n2")
    loss_1, leaves_1 = _got(run["out"], "ppmoe_1x1_n4")
    assert abs(loss_pp - loss_1) < 1e-5
    for a, b in zip(leaves_pp, leaves_1):  # stage layouts [4, 1, ...] and [1, 4, ...]
        np.testing.assert_allclose(a.reshape(b.shape), b, rtol=0, atol=1e-5)


def test_tp_remat_matches_single_device(run):
    loss, new = run["oracles"]["base"]
    _assert_close(_got(run["out"], "tp_2x4_remat"), loss, new, 1e-5, 1e-5, "tp remat")


@pytest.mark.parametrize("dp,pp,tp,sp,n_micro", D3_CASES)
def test_3d_matches_single_device(run, dp, pp, tp, sp, n_micro):
    loss, new = run["oracles"]["base"]
    key = f"d3_{dp}x{pp}x{tp}" + ("_sp" if sp else "")
    _assert_close(_got(run["out"], key), loss, run["stack"](new, pp), 1e-5, 1e-5, key)


def test_3d_remat_matches_single_device(run):
    loss, new = run["oracles"]["base"]
    _assert_close(_got(run["out"], "d3_2x2x2_remat"), loss, run["stack"](new, 2), 1e-5, 1e-5,
                  "3d remat")


def test_pp_remat_matches_single_device(run):
    loss, new = run["oracles"]["base"]
    _assert_close(_got(run["out"], "pp_2x4_n2_remat"), loss, run["stack"](new, 4), 1e-5, 1e-5,
                  "pp remat")


@pytest.mark.parametrize("key", JAX_CASES)
def test_matches_jax_mesh_step(run, key):
    loss, new = run["jax_mesh"][key]
    _assert_close(_got(run["out"], key), loss, new, 1e-4, 2e-4, key)


def test_every_rank_of_a_mesh_returns_the_same(run):
    outs = run["outs"]
    for key, v in outs[0].items():
        if key.startswith(("ckpt_", "coll_")):
            continue
        n = int(np.prod([int(x) for x in key.split("_")[1].split("x")]))
        for o in outs[1:n]:
            np.testing.assert_array_equal(o[key], v, err_msg=key)


def test_collectives_forward_and_backward(run):
    """On the (2, 4) mesh's ``model`` axis: rank m's input x_m is the
    arange of its shape plus 1000 m, the backward's weight w_m the arange of
    the output's shape plus 100 m."""
    outs = run["outs"]

    def ar(shape):
        return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)

    for r in range(4):  # the first data row of the mesh: model index r
        o = outs[r]
        xs = [ar((2, 8, 3)) + 1000 * m for m in range(4)]
        np.testing.assert_array_equal(o["coll_psum_y"], sum(xs))
        np.testing.assert_array_equal(o["coll_psum_grad"],
                                      sum(ar((2, 8, 3)) + 100 * m for m in range(4)))
        np.testing.assert_array_equal(o["coll_gather_y"], np.concatenate(xs, axis=1))
        ws = [ar((2, 32, 3)) + 100 * m for m in range(4)]
        np.testing.assert_array_equal(o["coll_gather_grad"], sum(ws)[:, 8 * r:8 * (r + 1)])
        ys = [ar((2, 32, 3)) + 1000 * m for m in range(4)]
        np.testing.assert_array_equal(o["coll_scatter_y"], sum(ys)[:, 8 * r:8 * (r + 1)])
        np.testing.assert_array_equal(o["coll_scatter_grad"],
                                      np.concatenate([ar((2, 8, 3)) + 100 * m
                                                      for m in range(4)], axis=1))
        np.testing.assert_array_equal(o["coll_ppermute_y"], xs[(r - 1) % 4])
        np.testing.assert_array_equal(o["coll_ppermute_grad"],
                                      ar((2, 8, 3)) + 100 * ((r + 1) % 4))


def test_moe_apply_model_axis_needs_a_mesh():
    import torch

    from otto_tpu_torch.ops.moe import init_moe, moe_apply

    p = init_moe(torch.Generator().manual_seed(0), 4, 8, 2)
    with pytest.raises(ValueError, match="mesh"):
        moe_apply(p, torch.zeros((3, 4)), capacity=2, model_axis="model")
