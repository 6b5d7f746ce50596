"""The port's mesh helpers and row-sharded embedding functions
(``otto_tpu_torch.parallel``) against ``otto_tpu.parallel``, on the CPU.

The port runs one process a rank: each launch below starts the ranks as
subprocesses of this file (``gloo``, a free port, a 120 s limit, no JAX in
any rank) and reads back what each rank returns; the JAX package runs the
same seeded numpy inputs on its 8 virtual CPU devices (``tests/conftest.py``),
with the inputs of ``tests/test_parallel.py``.  One launch of 8 ranks serves
the 2 x 4 and 4 x 2 meshes, one of 4 ranks the 1 x 4 mesh.

Tolerances:
- ``sharded_lookup``, ``shard_rows``: bit-equal (one shard contributes a
  row, the others exact zeros);
- ``sharded_topk`` on the dense route: ids equal, scores within 1e-5
  relative (float32 products in another order); on the fused route (K1 and
  K2's twins, on shards past the threshold): recall
  against the exact scan at least the JAX test's 0.9, scores equal to an
  exact rescoring within 1e-5;
- ``make_sharded_mf_step``: within 1e-6 of the JAX step and of the port's
  ``sparse_step`` (the same float32 arithmetic);
- ``make_sharded_sgns_step``: the loss within 1e-6 relative and the tables
  within 1e-5 of the JAX step, the accumulators within 1e-5 relative of a
  single-device dense adagrad; the JAX step's accumulators are dp^2 times
  the port's (it sums the gradient over ``data`` twice, ROADMAP §3);
- ``RankerModel.predict(mesh=)``: equal to the port's single-device
  ``predict``, and within the tower's limits of the JAX package's (bf16
  products, tests/test_torch_ranker.py).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SGNS_MESHES = ((1, 4), (2, 4), (4, 2))
SGNS_N, SGNS_D, SGNS_B, SGNS_NEG, SGNS_LR = 128, 8, 16, 4, 0.1
MF_LR = 0.07
# shard rows past HYBRID_MIN_SHARD_ROWS and FusedRetriever's dense guard (4
# chunks of 16,384): sharded_topk takes the fused route (K1 and K2's twins)
FUSED_SHARD = (1 << 16) + 4096


# ---------------------------------------------------------------------------
# inputs (seeded numpy, shared by both packages)
# ---------------------------------------------------------------------------


def _sgns_batch(seed: int, distinct: bool):
    rng = np.random.default_rng(seed)
    N, B, K = SGNS_N, SGNS_B, SGNS_NEG
    w_in = rng.uniform(-0.1, 0.1, (N, SGNS_D)).astype(np.float32)
    w_out = rng.uniform(-0.1, 0.1, (N, SGNS_D)).astype(np.float32)
    if distinct:  # centers distinct; contexts and negatives distinct together
        c = rng.permutation(N)[:B]
        rest = rng.permutation(N)[:B * (K + 1)]
        x, negs = rest[:B], rest[B:].reshape(B, K)
    else:
        c = rng.integers(0, 8, B)  # duplicates: a dense update sums them first
        x = rng.integers(0, N, B)
        negs = rng.integers(0, N, (B, K))
    return dict(w_in=w_in, w_out=w_out, c=c.astype(np.int32), x=x.astype(np.int32),
                negs=negs.astype(np.int32))


def _inputs() -> dict:
    out = {}
    rng = np.random.default_rng(0)  # tests/test_parallel.py:30-36
    out["lookup_table"] = rng.normal(size=(103, 16)).astype(np.float32)
    out["lookup_idx"] = rng.integers(0, 103, size=64).astype(np.int32)
    rng = np.random.default_rng(1)  # :39-43
    out["topk_items"] = rng.normal(size=(200, 16)).astype(np.float32)
    out["topk_q"] = rng.normal(size=(8, 16)).astype(np.float32)
    rng = np.random.default_rng(4)  # :245-256's inputs, at four shards of FUSED_SHARD rows
    out["fused_items"] = rng.normal(size=(FUSED_SHARD * 4, 16)).astype(np.float32)
    out["fused_q"] = rng.normal(size=(8, 16)).astype(np.float32)
    rng = np.random.default_rng(4)  # :273-283
    Ns, Na, D, B = 10, 9, 4, 16
    out["mf_ses"] = (rng.normal(size=(Ns, D)) * 0.1).astype(np.float32)
    out["mf_aid"] = (rng.normal(size=(Na, D)) * 0.1).astype(np.float32)
    out["mf_si"] = rng.integers(0, Ns, B).astype(np.int32)
    out["mf_ai"] = rng.integers(0, Na, B).astype(np.int32)
    out["mf_y"] = rng.normal(size=B).astype(np.float32)
    out["mf_y01"] = (out["mf_y"] > 0).astype(np.float32)
    for name, distinct in (("dup", False), ("distinct", True)):
        for k, v in _sgns_batch(7 if distinct else 2, distinct).items():
            out[f"sgns_{name}_{k}"] = v
    rng = np.random.default_rng(0)  # :221-241
    S, C, F = 37, 16, 12
    out["rank_feats"] = rng.normal(size=(S, C, F)).astype(np.float32)
    out["rank_mask"] = rng.random((S, C)) < 0.9
    return out


# ---------------------------------------------------------------------------
# the ranks (this file run as a script; it imports neither jax nor otto_tpu)
# ---------------------------------------------------------------------------


def _whole(mesh, block):
    """A row-sharded table reassembled from its blocks over ``model``."""
    import torch

    from otto_tpu_torch.parallel.mesh import all_gather

    return torch.cat(all_gather(mesh, block.contiguous(), "model")).numpy()


def _sgns_run(mesh, inp, name):
    from otto_tpu_torch.parallel import make_sharded_sgns_step, shard_rows

    w_in = shard_rows(mesh, inp[f"sgns_{name}_w_in"])
    w_out = shard_rows(mesh, inp[f"sgns_{name}_w_out"])
    acc_in, acc_out = (shard_rows(mesh, np.zeros((SGNS_N, SGNS_D), np.float32))
                       for _ in range(2))
    step = make_sharded_sgns_step(mesh, n_negatives=SGNS_NEG)
    *tables, loss = step(w_in, w_out, acc_in, acc_out, inp[f"sgns_{name}_c"],
                         inp[f"sgns_{name}_x"], inp[f"sgns_{name}_negs"], SGNS_LR)
    res = {f"{k}": _whole(mesh, t) for k, t in zip(("w_in", "w_out", "acc_in", "acc_out"),
                                                     tables)}
    res["loss"] = np.float32(loss)
    return res


def _task_mesh8(d: Path) -> dict:
    import torch

    from otto_tpu_torch.config import MeshConfig, RankerConfig
    from otto_tpu_torch.models.gbdt import load_ranker_model
    from otto_tpu_torch.models.ranker import RankerModel
    from otto_tpu_torch.parallel import (
        ShardedRetriever,
        make_mesh,
        make_mesh3d,
        make_sharded_mf_step,
        shard_rows,
        sharded_lookup,
        sharded_topk,
    )
    from otto_tpu_torch.parallel.mesh import rank_device

    inp = dict(np.load(d / "in.npz"))
    m24 = make_mesh(MeshConfig(data_parallel=2, model_parallel=4), device_type="cpu")
    m42 = make_mesh(MeshConfig(data_parallel=4, model_parallel=2), device_type="cpu")
    out = {"shape24": np.asarray(m24.mesh.shape), "shape42": np.asarray(m42.mesh.shape),
           "inferred": np.asarray(make_mesh(MeshConfig(model_parallel=4),
                                            device_type="cpu").mesh.shape)}
    try:
        make_mesh(MeshConfig(data_parallel=3, model_parallel=2), device_type="cpu")
    except ValueError as e:
        out["mismatch"] = np.asarray(str(e))
    try:
        rank_device(m24, "meta")
    except ValueError as e:
        out["wrong_device"] = np.asarray(str(e))
    m3 = make_mesh3d(2, 2, 2, device_type="cpu")
    out["shape3d"] = np.asarray(m3.mesh.shape)
    out["names3d"] = np.asarray(m3.mesh_dim_names)
    try:
        make_mesh3d(2, 2, 4, device_type="cpu")
    except ValueError as e:
        out["mismatch3d"] = np.asarray(str(e))

    block = shard_rows(m24, inp["lookup_table"])
    out["block"] = block.numpy()
    out["lookup"] = sharded_lookup(m24, block, inp["lookup_idx"]).numpy()
    items = shard_rows(m24, inp["topk_items"])
    for metric in ("dot", "euclidean"):
        s, i = sharded_topk(m24, inp["topk_q"], items, 7, metric=metric)
        out[f"topk_{metric}_s"], out[f"topk_{metric}_i"] = s.numpy(), i.numpy()
    fused = ShardedRetriever(m24, shard_rows(m24, inp["fused_items"]))
    out["fused_route"] = np.asarray(fused.fused is not None)
    s, i = fused.topk(inp["fused_q"], 5)
    out["fused_s"], out["fused_i"] = s.numpy(), i.numpy()

    for loss, y in (("mse", inp["mf_y"]), ("bce", inp["mf_y01"])):
        tabs = [shard_rows(m24, inp[k]) for k in ("mf_ses", "mf_aid")]
        tabs += [torch.zeros_like(t) for t in tabs]
        *res, value = make_sharded_mf_step(m24, loss=loss)(*tabs, inp["mf_si"], inp["mf_ai"],
                                                           y, MF_LR)
        for k, t in zip(("ses", "aid", "acc_s", "acc_a"), res):
            out[f"mf_{loss}_{k}"] = _whole(m24, t)
        out[f"mf_{loss}_loss"] = np.float32(value)

    for mesh, tag in ((m24, "2x4"), (m42, "4x2")):
        for k, v in _sgns_run(mesh, inp, "dup").items():
            out[f"sgns_{tag}_{k}"] = v
    for k, v in _sgns_run(m24, inp, "distinct").items():
        out[f"sgns_distinct_{k}"] = v

    model = RankerModel.load(d / "ranker.npz", RankerConfig(hidden_dims=(32, 16)))
    out["rank_mesh"] = model.predict(inp["rank_feats"], inp["rank_mask"], mesh=m42,
                                     device=None)
    gbdt = load_ranker_model(REPO / "artifacts" / "bench_e2e" / "ranker_clicks.npz")
    x = np.random.default_rng(3).normal(size=(5, 7, gbdt.edges.shape[0])).astype(np.float32)
    mask = np.ones((5, 7), bool)
    out["gbdt_mesh"] = gbdt.predict(x, mask, mesh=m24, device="cpu")
    out["gbdt_plain"] = gbdt.predict(x, mask, device="cpu")
    return out


def _task_mesh4(d: Path) -> dict:
    import torch
    import torch.distributed as dist

    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.ops.moe import init_moe, moe_apply, moe_param_specs
    from otto_tpu_torch.parallel import make_mesh
    from otto_tpu_torch.parallel.mesh import in_mesh
    from otto_tpu_torch.parallel.model_parallel import shard_params

    inp = dict(np.load(d / "in.npz"))
    mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=4), device_type="cpu")
    out = {f"sgns_1x4_{k}": v for k, v in _sgns_run(mesh, inp, "dup").items()}
    # expert parallelism on the first two ranks, mesh (1, 2); its own file
    m12 = make_mesh(MeshConfig(data_parallel=1, model_parallel=2), device_type="cpu", ranks=2)
    if in_mesh(m12):
        p = init_moe(torch.Generator().manual_seed(5), 16, 32, 4)
        x = torch.from_numpy(np.random.default_rng(6).normal(size=(12, 16)).astype(np.float32))
        with torch.no_grad():
            got = moe_apply(shard_params(m12, p, moe_param_specs(m12)), x, capacity=5,
                            model_axis="model", mesh=m12)
        np.savez(d / f"moe12_rank{dist.get_rank()}.npz", got=got.numpy(),
                 want=moe_apply(p, x, capacity=5).numpy())
    return out


def _worker(task: str, d: Path) -> None:
    import torch
    import torch.distributed as dist

    from otto_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    assert init_distributed("gloo", timeout_s=100)
    rank = dist.get_rank()
    out = {"mesh8": _task_mesh8, "mesh4": _task_mesh4}[task](d)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "otto_tpu"))
    assert not bad, bad
    np.savez(d / f"{task}_rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(sys.argv[1], Path(sys.argv[2]))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _launch(task: str, world: int, d: Path) -> list[dict]:
    from otto_tpu_torch.parallel.mesh import launch_local

    env = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    launch_local([sys.executable, __file__, task, str(d)], world, timeout_s=120, env=env)
    return [dict(np.load(d / f"{task}_rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax

    from otto_tpu.config import RankerConfig as JRankerConfig
    from otto_tpu.models.ranker import FeatureNormalizer, RankerModel, init_tower

    d = tmp_path_factory.mktemp("mesh")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    feats, mask = inp["rank_feats"], inp["rank_mask"]
    params = [init_tower(jax.random.PRNGKey(i), feats.shape[2], (32, 16)) for i in range(3)]
    jm = RankerModel(params, FeatureNormalizer.fit(feats, mask), JRankerConfig())
    jm.save(d / "ranker.npz")
    outs = _launch("mesh8", 8, d)
    outs4 = _launch("mesh4", 4, d)
    return dict(inp=inp, jm=jm, d=d, outs=outs, outs4=outs4, out={**outs[0], **outs4[0]},
                moe12=[dict(np.load(d / f"moe12_rank{r}.npz")) for r in range(2)])


@pytest.fixture(scope="module")
def jax_meshes():
    import jax

    from otto_tpu.config import MeshConfig
    from otto_tpu.parallel.mesh import make_mesh

    return {(dp, mp): make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp),
                                devices=jax.devices()[:dp * mp])
            for dp, mp in ((1, 4), (2, 4), (4, 2))}


def test_mesh_and_pipeline_configs_round_trip():
    from otto_tpu.config import MeshConfig as JMesh, PipelineConfig as JPipe
    from otto_tpu_torch.config import MeshConfig, PipelineConfig

    mc = MeshConfig(data_parallel=2, model_parallel=4, model_axis="m")
    assert MeshConfig.from_dict(mc.to_dict()) == mc
    assert mc.to_dict() == JMesh(data_parallel=2, model_parallel=4, model_axis="m").to_dict()
    pc = PipelineConfig(mesh=mc)
    assert PipelineConfig.from_dict(pc.to_dict()) == pc
    assert PipelineConfig.from_dict({}) == PipelineConfig()
    assert pc.to_dict() == JPipe.from_dict(pc.to_dict()).to_dict()


@pytest.mark.parametrize("n", [0, 1, 7, 103, 1000])
def test_host_shard_sessions_equal_to_jax(n):
    from otto_tpu.parallel.mesh import host_shard_sessions as jh
    from otto_tpu_torch.parallel import host_shard_sessions

    for count in (1, 2, 3, 4, 8):
        for index in range(count):
            np.testing.assert_array_equal(host_shard_sessions(n, index, count),
                                          jh(n, index, count))
    assert len(host_shard_sessions(n)) == n  # one process without a group: everything


def test_init_distributed_without_env_or_card(monkeypatch):
    from otto_tpu_torch.parallel import init_distributed

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="nccl"):
        init_distributed()  # no card here: NCCL is refused, gloo not taken silently


def test_make_mesh_shapes_and_errors(ranks):
    out = ranks["out"]
    assert out["shape24"].tolist() == [2, 4] and out["shape42"].tolist() == [4, 2]
    assert out["inferred"].tolist() == [2, 4]
    assert str(out["mismatch"]) == "mesh 3x2 does not match 8 devices"
    assert "not this rank's device" in str(out["wrong_device"])
    assert out["shape3d"].tolist() == [2, 2, 2]
    assert out["names3d"].tolist() == ["data", "pipe", "model"]
    assert str(out["mismatch3d"]) == "mesh 2x2x4 needs 16 devices, have 8"


def test_every_rank_returns_the_same(ranks):
    for outs in (ranks["outs"], ranks["outs4"]):
        for o in outs[1:]:
            for k, v in o.items():
                if k != "block":
                    np.testing.assert_array_equal(v, outs[0][k], err_msg=k)


def test_shard_rows_pads_zero_rows(ranks):
    table = ranks["inp"]["lookup_table"]
    padded = np.concatenate([table, np.zeros((1, 16), np.float32)])  # 103 -> 104 rows
    for r, o in enumerate(ranks["outs"]):
        m = r % 4  # rank r of the 2 x 4 mesh holds model block r % 4
        np.testing.assert_array_equal(o["block"], padded[26 * m:26 * (m + 1)])


def test_sharded_lookup_bit_equal_to_jax(ranks, jax_meshes):
    import jax.numpy as jnp

    from otto_tpu.parallel.mesh import shard_rows
    from otto_tpu.parallel.sharded_embedding import sharded_lookup

    inp, mesh = ranks["inp"], jax_meshes[(2, 4)]
    want = np.asarray(sharded_lookup(mesh, shard_rows(mesh, inp["lookup_table"]),
                                     jnp.asarray(inp["lookup_idx"])))
    np.testing.assert_array_equal(ranks["out"]["lookup"], want)
    np.testing.assert_array_equal(want, inp["lookup_table"][inp["lookup_idx"]])


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_sharded_topk_dense_route_equal_to_jax(ranks, jax_meshes, metric):
    import jax.numpy as jnp

    from otto_tpu.parallel.mesh import shard_rows
    from otto_tpu.parallel.sharded_embedding import sharded_topk

    inp, mesh = ranks["inp"], jax_meshes[(2, 4)]
    s, i = sharded_topk(mesh, jnp.asarray(inp["topk_q"]), shard_rows(mesh, inp["topk_items"]),
                        k=7, metric=metric)
    out = ranks["out"]
    np.testing.assert_array_equal(out[f"topk_{metric}_i"], np.asarray(i))
    np.testing.assert_allclose(out[f"topk_{metric}_s"], np.asarray(s), rtol=1e-5)


def test_sharded_topk_fused_route(ranks):
    """K1 + K2 (their CPU twins) on each 69,632-row shard, then the merge."""
    inp, out = ranks["inp"], ranks["out"]
    assert bool(out["fused_route"])
    q, items = inp["fused_q"], inp["fused_items"]
    exact = np.argsort(-(q @ items.T), axis=1, kind="stable")[:, :5]
    i = out["fused_i"]
    hits = sum(len(set(map(int, a)) & set(map(int, e))) for a, e in zip(i, exact))
    assert hits / i.size >= 0.9
    rescored = np.einsum("bd,bkd->bk", q.astype(np.float64), items[i].astype(np.float64))
    np.testing.assert_allclose(out["fused_s"], rescored, rtol=1e-5, atol=1e-5)
    assert (np.diff(out["fused_s"], axis=1) <= 0).all()


@pytest.mark.parametrize("loss", ["mse", "bce"])
def test_sharded_mf_step_equal_to_jax_and_sparse_step(ranks, jax_meshes, loss):
    import jax.numpy as jnp
    import torch

    from otto_tpu.parallel.mesh import shard_rows
    from otto_tpu.parallel.sharded_embedding import make_sharded_mf_step
    from otto_tpu_torch.models.matrix_factorization import sparse_step

    inp, out, mesh = ranks["inp"], ranks["out"], jax_meshes[(2, 4)]
    ses, aid = inp["mf_ses"], inp["mf_aid"]
    y = inp["mf_y"] if loss == "mse" else inp["mf_y01"]
    jout = make_sharded_mf_step(mesh, loss=loss)(
        shard_rows(mesh, ses), shard_rows(mesh, aid), shard_rows(mesh, np.zeros_like(ses)),
        shard_rows(mesh, np.zeros_like(aid)), jnp.asarray(inp["mf_si"]),
        jnp.asarray(inp["mf_ai"]), jnp.asarray(y), jnp.float32(MF_LR))
    tables = {"s": torch.from_numpy(ses.copy()), "a": torch.from_numpy(aid.copy())}
    accs = {k: torch.zeros_like(v) for k, v in tables.items()}
    value = sparse_step(tables, accs, (("s", 0), ("a", 1)), loss, MF_LR,
                        torch.from_numpy(inp["mf_si"]).long(),
                        torch.from_numpy(inp["mf_ai"]).long(), torch.from_numpy(y))
    single = {"ses": tables["s"], "aid": tables["a"], "acc_s": accs["s"], "acc_a": accs["a"]}
    for j, (k, n) in enumerate((("ses", 10), ("aid", 9), ("acc_s", 10), ("acc_a", 9))):
        got = out[f"mf_{loss}_{k}"][:n]
        np.testing.assert_allclose(got, np.asarray(jout[j])[:n], rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got, single[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
        assert not (out[f"mf_{loss}_{k}"][n:]).any()  # pad rows stay zero
    got_loss = float(out[f"mf_{loss}_loss"])
    assert abs(got_loss - float(jout[4])) <= 1e-6 * abs(float(jout[4]))
    assert abs(got_loss - float(value)) <= 1e-6 * abs(float(value))


def _dense_adagrad(b: dict):
    """Single-device SGNS step, dense adagrad, float64: each row's gradient
    summed over the batch, then acc = g^2 and w -= lr g / sqrt(acc + 1e-10)."""
    w_in, w_out = b["w_in"].astype(np.float64), b["w_out"].astype(np.float64)
    c, x, negs = b["c"], b["x"], b["negs"]
    cr, pr, nr = w_in[c], w_out[x], w_out[negs]
    pos = (cr * pr).sum(1)
    neg = np.einsum("bd,bnd->bn", cr, nr)
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))  # noqa: E731
    loss = np.log1p(np.exp(-pos)).sum() + np.log1p(np.exp(neg)).sum()
    gp, gn = sig(pos) - 1.0, sig(neg)
    g_in, g_out = np.zeros_like(w_in), np.zeros_like(w_out)
    np.add.at(g_in, c, gp[:, None] * pr + np.einsum("bn,bnd->bd", gn, nr))
    np.add.at(g_out, x, gp[:, None] * cr)
    np.add.at(g_out, negs.reshape(-1), (gn[:, :, None] * cr[:, None, :]).reshape(-1, SGNS_D))
    out = {"loss": loss}
    for k, w, g in (("in", w_in, g_in), ("out", w_out, g_out)):
        out[f"g_{k}"] = g
        out[f"acc_{k}"] = g * g
        out[f"w_{k}"] = w - SGNS_LR * g / np.sqrt(g * g + 1e-10)
    return out


def _acc_close(got, want, err_msg):
    """Accumulators within 1e-5 relative; an entry whose gradient sum
    nearly cancels is held to 1e-6 of the largest entry instead (float32
    sums in another order)."""
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                               err_msg=err_msg)


def _batch(inp, name):
    return {k: inp[f"sgns_{name}_{k}"] for k in ("w_in", "w_out", "c", "x", "negs")}


@pytest.mark.parametrize("shape", SGNS_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_sgns_step_against_jax(ranks, jax_meshes, shape):
    """Losses and tables agree with the JAX step and with a single-device
    dense adagrad; the accumulators equal the dense adagrad's, and the JAX
    step's are dp^2 times them.  The JAX step's gradient is dp times the
    true one, so its update ``lr dp g / sqrt(dp^2 g^2 + 1e-10)`` leaves
    ``lr g / sqrt(g^2 + 1e-10)`` where |g| is near 1e-5: there its tables
    are held to that model of its fault, elsewhere (|g| >= 1e-3, where the
    two updates differ by less than 5e-6) to the port's."""
    import jax.numpy as jnp

    from otto_tpu.parallel.mesh import shard_rows
    from otto_tpu.parallel.sharded_embedding import make_sharded_sgns_step

    dp, mp = shape
    b = _batch(ranks["inp"], "dup")
    mesh = jax_meshes[shape]
    z = np.zeros_like(b["w_in"])
    jw_in, jw_out, jacc_in, jacc_out, jloss = make_sharded_sgns_step(mesh, SGNS_NEG)(
        shard_rows(mesh, b["w_in"]), shard_rows(mesh, b["w_out"]), shard_rows(mesh, z),
        shard_rows(mesh, z), jnp.asarray(b["c"]), jnp.asarray(b["x"]), jnp.asarray(b["negs"]),
        jnp.float32(SGNS_LR))
    got = {k[len(f"sgns_{dp}x{mp}_"):]: v for k, v in ranks["out"].items()
           if k.startswith(f"sgns_{dp}x{mp}_")}
    ref = _dense_adagrad(b)
    assert abs(float(got["loss"]) - float(jloss)) <= 1e-6 * abs(float(jloss))
    assert abs(float(got["loss"]) - ref["loss"]) <= 1e-6 * ref["loss"]
    for k, jv, w0 in (("in", jw_in, b["w_in"]), ("out", jw_out, b["w_out"])):
        g, jv = ref[f"g_{k}"], np.asarray(jv)[:SGNS_N]
        np.testing.assert_allclose(got[f"w_{k}"], ref[f"w_{k}"], rtol=0, atol=1e-5, err_msg=k)
        fault = w0 - SGNS_LR * dp * g / np.sqrt(dp * dp * g * g + 1e-10)
        np.testing.assert_allclose(jv, fault, rtol=0, atol=1e-5, err_msg=k)
        big = np.abs(g) >= 1e-3
        np.testing.assert_allclose(got[f"w_{k}"][big], jv[big], rtol=0, atol=1e-5, err_msg=k)
        if dp == 1:
            np.testing.assert_allclose(got[f"w_{k}"], jv, rtol=0, atol=1e-5, err_msg=k)
    for k, jv in (("acc_in", jacc_in), ("acc_out", jacc_out)):
        _acc_close(got[k], ref[k], k)
        # the reference fault: JAX sums each gradient over `data` twice
        _acc_close(got[k] * dp * dp, np.asarray(jv)[:SGNS_N], k)
    assert ref["acc_in"].any() and ref["acc_out"].any()


def test_sharded_sgns_step_equals_sgns_step_on_distinct_rows(ranks):
    """On a batch whose center rows, and whose context and negative rows,
    are distinct, the dense update equals ``sgns_step``'s sparse one; the
    loss is ``sgns_step``'s batch mean times B."""
    import torch

    from otto_tpu_torch.models.embeddings import sgns_step

    b = _batch(ranks["inp"], "distinct")
    t = {k: torch.from_numpy(b[k].copy()) for k in ("w_in", "w_out")}
    acc_in, acc_out = torch.zeros_like(t["w_in"]), torch.zeros_like(t["w_out"])
    loss = sgns_step(t["w_in"], t["w_out"], acc_in, acc_out, torch.from_numpy(b["c"]).long(),
                     torch.from_numpy(b["x"]).long(), torch.from_numpy(b["negs"]).long(),
                     SGNS_LR)
    got = {k[len("sgns_distinct_"):]: v for k, v in ranks["out"].items()
           if k.startswith("sgns_distinct_")}
    assert abs(float(got["loss"]) - float(loss) * SGNS_B) <= 1e-6 * float(got["loss"])
    for k, v in (("w_in", t["w_in"]), ("w_out", t["w_out"]), ("acc_in", acc_in),
                 ("acc_out", acc_out)):
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_ranker_predict_mesh_against_jax(ranks, jax_meshes):
    from otto_tpu_torch.config import RankerConfig
    from otto_tpu_torch.models.ranker import RankerModel

    inp, jm = ranks["inp"], ranks["jm"]
    feats, mask = inp["rank_feats"], inp["rank_mask"]
    got = ranks["out"]["rank_mesh"]
    single = RankerModel.load(ranks["d"] / "ranker.npz", RankerConfig(hidden_dims=(32, 16)))
    np.testing.assert_array_equal(got, single.predict(feats, mask, device="cpu"))
    for want in (jm.predict(feats, mask, batch=16),
                 jm.predict(feats, mask, batch=16, mesh=jax_meshes[(4, 2)])):
        assert np.array_equal(np.isinf(got), np.isinf(want))
        d = np.abs(got[mask] - want[mask])
        assert (d <= 1e-5 * (np.abs(want[mask]) + 1e-3)).mean() >= 0.99
        assert d.max() <= 4e-3 * np.abs(want[mask]).max()


def test_gbdt_predict_takes_mesh_and_ignores_it(ranks):
    np.testing.assert_array_equal(ranks["out"]["gbdt_mesh"], ranks["out"]["gbdt_plain"])
    assert np.isfinite(ranks["out"]["gbdt_plain"]).all()


def test_dryrun_module_on_two_gloo_ranks(tmp_path):
    from otto_tpu_torch.parallel.mesh import launch_local

    outs = launch_local([sys.executable, "-m", "otto_tpu_torch.parallel.dryrun", "--backend",
                         "gloo", "--device", "cpu"], 2, timeout_s=120,
                        env={"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}, cwd=REPO)
    assert [o.split(" ok ")[0] for o in outs] == ["dryrun rank 0/2", "dryrun rank 1/2"]
    assert outs[0].split(" ok ")[1] == outs[1].split(" ok ")[1]
    # mesh (1, 2): the model- and expert-parallel steps ran too (no 3-D at 2 ranks)
    for key in ("tp_loss", "tp_sp_loss", "pp_loss", "tp_moe_loss", "ep_loss"):
        assert f"'{key}'" in outs[0], key
    assert "'d3_loss'" not in outs[0]


def test_mesh_still_raises_in_later_slices(ranks):
    """Expert parallelism runs since M15c: ``moe_apply(model_axis=)`` over a
    (1, 2) mesh (each rank two of the four experts) equals the
    single-device ``moe_apply``; without a mesh it raises."""
    import torch

    from otto_tpu_torch.ops.moe import init_moe, moe_apply

    for r in ranks["moe12"]:
        np.testing.assert_allclose(r["got"], r["want"], rtol=0, atol=1e-6)
    assert np.abs(ranks["moe12"][0]["want"]).max() > 0
    p = init_moe(torch.Generator().manual_seed(5), 16, 32, 4)
    with pytest.raises(ValueError, match="mesh"):
        moe_apply(p, torch.zeros((2, 16)), capacity=1, model_axis="model")


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or
    otto_tpu (read from their import statements)."""
    import ast

    files = sorted((REPO / "otto_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert any(f.parent.name == "parallel" for f in files)
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "otto_tpu"), (f, name)
