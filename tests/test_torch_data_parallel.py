"""The port's data-parallel training (``otto_tpu_torch/parallel/
data_parallel.py``, ``fit_gbdt(mesh=)``, ``train_gbdt_ranker(mesh=)``,
``BatchLoader(mesh=)``) against ``otto_tpu`` and against the port's
single-process functions, on the CPU.

The port runs one process a rank: three module-scoped launches start 8, 4
and 2 ranks as subprocesses of this file (``gloo``, a free port, CPU
meshes ``(dp, 1)``, no JAX in any rank) and read back what each rank
returns; the JAX package runs the same seeded numpy inputs (those of
``tests/test_parallel.py``, ``tests/test_gbdt.py`` and
``tests/test_multihost.py``) on its 8 virtual CPU devices
(``tests/conftest.py``).

Tolerances:
- ``node_histograms`` over split rows (``scale_rows`` and ``reduce``):
  bit-equal to the whole on dyadic vals (the float64 twin), and the
  fixed-point arithmetic (``_fixed_point_histogram``, the kernel's) bit-equal
  on any vals;
- ``make_dp_gbdt_grow``: bit-equal to the port's ``_grow_tree``
  (features, thresholds, leaf ids, leaves) on dyadic grad/hess and on
  ``tests/test_gbdt.py:268-273``'s normal ones; against JAX's
  ``make_dp_gbdt_grow`` on dyadic grad/hess (where both packages' sums are
  exact, as in ``tests/test_torch_gbdt_train.py``: on the normal ones the
  reference's float32 one-hot matmul and the port's exact sums part at
  near-ties, e.g. gains 8.988815 and 8.988710 at one node of rng(0)'s
  tree) features, thresholds and leaf ids equal, leaves within 1e-4
  relative (``tests/test_gbdt.py:268-287``);
- ``fit_gbdt(mesh=)`` and ``train_gbdt_ranker(mesh=)``: equal to the
  single-process fits (trees, leaves, best iterations, importances, OOF
  scores); the 250-session fit's top-1 hit rate above JAX's 0.8;
- ``make_dp_ranker_step`` against JAX's (SGD and AdamW, BCE and LambdaRank,
  dropout 0): the loss within 1e-5 relative, the parameters within rtol 2e-4,
  atol 1e-6 (``tests/test_parallel.py:84-112``, which holds the JAX dp step
  to a single-device one: the mean of the shards' gradients, counted once),
  but under LambdaRank and AdamW the output bias, whose gradient is zero but
  for rounding (the pairwise loss ignores a shift of every score), within
  2 lr;
- ``make_dp_sequence_step`` against JAX's for GRU and the transformer:
  parameters within 2e-4, the loss within 1e-4;
- ZeRO-1 against the dp step over 3 AdamW steps: losses within 1e-5,
  parameters within 1e-5; each rank's optimizer state at most 1/dp of the dp
  step's plus one entry a state tensor;
- ``BatchLoader(mesh=)``: the ranks' blocks together equal the single
  loader's batches;
- two ranks feeding their host-local blocks (``host_shard_sessions``): the
  losses and the first leaf equal on both ranks, equal to the whole batch's
  run, and within the dp ranker step's limits of JAX's single process over a
  two-device mesh (``tests/test_multihost.py``).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
GROW = dict(N=512, F=6, n_bins=16, depth=4)
GROW_SCALARS = (0.01, 0.0, 1.0, 0.0, 0.5)  # reg_lambda, min_split_gain, min_data, min_child, lr
SMALL = dict(n_trees=30, early_stopping_rounds=1000, learning_rate=0.3, max_depth=3,
             n_bins=32, min_data_in_leaf=1, min_split_gain=0.0, min_child_weight=1e-6,
             subsample=1.0, colsample=1.0, n_folds=3, chunk_sessions=64)  # tests/test_gbdt.py
FIT_CASES = {  # the JAX test's fit, and one with bags, colsample and early stopping
    "plain": dict(n_trees=20),
    "bagged": dict(n_trees=30, subsample=0.8, colsample=0.8, eval_every=2,
                   early_stopping_rounds=4),
}
RANKER_CASES = [(opt, loss) for opt in ("sgd", "adamw") for loss in ("bce", "lambdarank")]
SEQ = dict(n_aids=40, dim=16, hidden=8, max_len=6, n_heads=2, B=16, NEG=4)
LOADER_ROWS, LOADER_BATCH = 37, 8


# ---------------------------------------------------------------------------
# inputs (seeded numpy, shared by both packages)
# ---------------------------------------------------------------------------


def _listwise_problem(rng, S=240, C=16, F=6, noise=0.05):
    """tests/test_gbdt.py's problem: relevance a noisy threshold on feature 0."""
    feats = rng.normal(size=(S, C, F)).astype(np.float32)
    rel = feats[..., 0] + noise * rng.normal(size=(S, C))
    labels = (rel > np.quantile(rel, 0.8, axis=1, keepdims=True)).astype(np.int8)
    mask = np.ones((S, C), bool)
    mask[:, -2:] = rng.random((S, 2)) < 0.7
    labels = labels & mask
    feats[~mask] = np.nan
    return feats, labels, mask


def _seq_batch(seed: int):
    r = np.random.default_rng(seed)
    B, L, n = SEQ["B"], SEQ["max_len"], SEQ["n_aids"]
    return (r.integers(0, n, (B, L)).astype(np.int32), np.ones((B, L), bool),
            r.integers(0, n, B).astype(np.int32), r.integers(0, n, (B, SEQ["NEG"])).astype(np.int32))


def _inputs() -> dict:
    """The numpy inputs; JAX's initial parameters are added by the fixture."""
    from otto_tpu_torch.models.gbdt import bin_features, fit_bin_edges

    out = {}
    rng = np.random.default_rng(0)  # tests/test_gbdt.py:268-273
    N, F, nb = GROW["N"], GROW["F"], GROW["n_bins"]
    out["grow_binned"] = rng.integers(0, nb, size=(N, F)).astype(np.uint8)
    out["grow_normal_g"] = rng.normal(size=N).astype(np.float32)
    out["grow_normal_h"] = rng.uniform(0.1, 1.0, size=N).astype(np.float32)
    out["grow_dyadic_g"] = (rng.integers(-64, 65, N) / 64).astype(np.float32)
    out["grow_dyadic_h"] = (rng.integers(1, 65, N) / 64).astype(np.float32)
    out["grow_weight"] = (rng.random(N) < 0.9).astype(np.float32)

    feats, labels, mask = _listwise_problem(np.random.default_rng(1), S=310)
    edges = fit_bin_edges(feats[mask], SMALL["n_bins"])
    out["fit_binned"] = bin_features(feats, edges)
    out["fit_labels"], out["fit_mask"] = labels, mask

    feats, labels, mask = _listwise_problem(np.random.default_rng(2), S=180, C=12)
    out["rk_feats"], out["rk_labels"], out["rk_mask"] = feats, labels, mask

    rng = np.random.default_rng(3)  # tests/test_parallel.py:86-90
    out["tower_x"] = rng.normal(size=(16, 8, 4)).astype(np.float32)
    out["tower_y"] = (rng.random((16, 8)) < 0.3).astype(np.int8)
    out["tower_m"] = np.ones((16, 8), bool)
    rng = np.random.default_rng(0)  # tests/test_multihost.py:51-55
    out["mh_x"] = rng.normal(size=(16, 8, 6)).astype(np.float32)
    out["mh_y"] = (rng.random((16, 8)) < 0.3).astype(np.int8)
    out["mh_m"] = np.ones((16, 8), bool)
    for i in range(4):  # batch 0: tests/test_parallel.py:143-148; 1-3: the ZeRO test's
        for k, v in zip(("seq", "mask", "tgt", "negs"), _seq_batch(i)):
            out[f"seq{i}_{k}"] = v
    out["loader_a"] = np.arange(LOADER_ROWS * 3, dtype=np.float32).reshape(LOADER_ROWS, 3)
    out["loader_b"] = np.arange(LOADER_ROWS, dtype=np.int64)
    out["loader_order"] = np.random.default_rng(4).permutation(LOADER_ROWS)
    return out


def _gbdt_config(**over):
    from otto_tpu_torch.config import GBDTConfig

    return GBDTConfig(**{**SMALL, **over})


def _fit_args(inp: dict, case: str):
    """The fit's sessions (250: not a multiple of 8, so dp 8 pads) and, for
    the bagged case, 60 held-out sessions for early stopping."""
    b, y, m = inp["fit_binned"], inp["fit_labels"], inp["fit_mask"]
    val = (b[250:], y[250:], m[250:]) if case == "bagged" else None
    return (b[:250], y[:250], m[:250], m[:250].astype(np.float32),
            _gbdt_config(**FIT_CASES[case])), val


def _ranker_data(inp: dict):
    from otto_tpu_torch.models.ranker import RankerData

    S, C, F = inp["rk_feats"].shape
    return RankerData(inp["rk_feats"], inp["rk_labels"], inp["rk_mask"], np.arange(S),
                      np.zeros((S, C), np.int32), [f"f{i}" for i in range(F)])


def _forest_arrays(forest, tag: str) -> dict:
    return {f"{tag}_{k}": np.asarray(getattr(forest, k)) for k in
            ("feat", "thr", "leaf", "base", "best_iteration", "gain_importance",
             "split_importance")}


def _tower_optimizer(tower, name: str):
    import torch

    if name == "sgd":
        return torch.optim.SGD(tower.parameters(), lr=0.1)
    return torch.optim.AdamW(tower.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)  # optax.adamw(1e-3)'s defaults


def _seq_params(inp: dict, arch: str, n_layers: int, device="cpu"):
    import torch

    from otto_tpu_torch.models.sequence import _tree_map, _tree_unflatten, init_params

    template = init_params(torch.Generator().manual_seed(0), SEQ["n_aids"], SEQ["dim"],
                           SEQ["hidden"], architecture=arch, max_len=SEQ["max_len"],
                           n_layers=n_layers, n_heads=SEQ["n_heads"])
    n = sum(1 for k in inp if k.startswith(f"jseq_{arch}{n_layers}_"))
    leaves = [torch.tensor(inp[f"jseq_{arch}{n_layers}_{i}"]) for i in range(n)]
    return _tree_map(lambda t: t.to(device).requires_grad_(True),
                     _tree_unflatten(template, leaves))


def _seq_batch_of(inp: dict, i: int):
    return tuple(inp[f"seq{i}_{k}"] for k in ("seq", "mask", "tgt", "negs"))


# ---------------------------------------------------------------------------
# the ranks (this file run as a script; it imports neither jax nor otto_tpu)
# ---------------------------------------------------------------------------


def _rank_grow(mesh, inp) -> dict:
    from otto_tpu_torch.parallel import make_dp_gbdt_grow

    grow = make_dp_gbdt_grow(mesh, depth=GROW["depth"], n_bins=GROW["n_bins"])
    out = {}
    for tag in ("normal", "dyadic"):
        w = np.ones(GROW["N"], np.float32) if tag == "normal" else inp["grow_weight"]
        res = grow(inp["grow_binned"], inp[f"grow_{tag}_g"], inp[f"grow_{tag}_h"], w,
                   np.ones(GROW["N"], np.float32), np.ones(GROW["F"], bool), *GROW_SCALARS)
        for k, v in zip(("feat", "thr", "leaf", "gain", "ids"), res):
            out[f"grow_{tag}_{k}"] = v.numpy()
    return out


def _rank_fits(mesh, inp) -> dict:
    from otto_tpu_torch.models.gbdt import fit_gbdt

    out = {}
    for case in FIT_CASES:
        args, val = _fit_args(inp, case)
        out.update(_forest_arrays(fit_gbdt(*args, val=val, mesh=mesh, device=None), case))
    return out


def _rank_ranker_steps(mesh, inp) -> dict:
    from otto_tpu_torch.models.ranker import tower_params_from_numpy
    from otto_tpu_torch.parallel import make_dp_ranker_step

    out = {}
    jp = {k[len("jtower_"):]: v for k, v in inp.items() if k.startswith("jtower_")}
    for opt_name, loss in RANKER_CASES:
        tower = tower_params_from_numpy(jp, device="cpu")
        step = make_dp_ranker_step(mesh, _tower_optimizer(tower, opt_name), loss_name=loss)
        value = step(tower, inp["tower_x"], inp["tower_y"], inp["tower_m"], seed=1)
        out[f"tower_{opt_name}_{loss}_loss"] = np.float32(value)
        for k, v in tower.named_parameters():
            out[f"tower_{opt_name}_{loss}_{k}"] = v.detach().numpy()
    try:  # a batch that does not split over the ranks
        step(tower, inp["tower_x"][:15], inp["tower_y"][:15], inp["tower_m"][:15])
    except ValueError as e:
        out["uneven"] = np.asarray(str(e))
    return out


def _rank_sequence(mesh, inp) -> dict:
    from otto_tpu_torch.config import SequenceModelConfig
    from otto_tpu_torch.models.sequence import make_optimizer, tree_leaves
    from otto_tpu_torch.parallel import make_dp_sequence_step

    out = {}
    for arch in ("gru", "transformer"):
        params = _seq_params(inp, arch, 1)
        opt = make_optimizer(params, SequenceModelConfig(learning_rate=1e-2))
        value = make_dp_sequence_step(mesh, opt)(params, *_seq_batch_of(inp, 0))
        out[f"seq_{arch}_loss"] = np.float32(value)
        for i, leaf in enumerate(tree_leaves(params)):
            out[f"seq_{arch}_{i}"] = leaf.detach().numpy()
    return out


def _rank_zero(mesh, inp) -> dict:
    from functools import partial

    import torch

    from otto_tpu_torch.models.sequence import tree_leaves
    from otto_tpu_torch.parallel import make_dp_sequence_step, make_zero_sequence_step, zero_init
    from otto_tpu_torch.parallel.data_parallel import optimizer_state_numel

    adamw = partial(torch.optim.AdamW, lr=1e-2, weight_decay=1e-4)  # optax.adamw(1e-2)
    pd, pz = _seq_params(inp, "transformer", 2), _seq_params(inp, "transformer", 2)
    opt = adamw(tree_leaves(pd))
    state = zero_init(mesh, adamw, pz)
    dstep, zstep = make_dp_sequence_step(mesh, opt), make_zero_sequence_step(mesh)
    out = {}
    for i in range(1, 4):
        b = _seq_batch_of(inp, i)
        out[f"zero_dp_loss{i}"] = np.float32(dstep(pd, *b))
        out[f"zero_loss{i}"] = np.float32(zstep(pz, state, *b))
    for i, (a, b) in enumerate(zip(tree_leaves(pd), tree_leaves(pz))):
        out[f"zero_dp_{i}"], out[f"zero_{i}"] = a.detach().numpy(), b.detach().numpy()
    out["zero_state_numel"] = np.int64(optimizer_state_numel(state.optimizer))
    out["zero_state_tensors"] = np.int64(sum(1 for st in state.optimizer.state.values()
                                             for v in st.values() if torch.is_tensor(v)))
    out["dp_state_numel"] = np.int64(optimizer_state_numel(opt))
    return out


def _rank_loader(mesh, inp) -> dict:
    from torch.distributed.tensor import DTensor

    from otto_tpu_torch.data.loader import BatchLoader

    loader = BatchLoader((inp["loader_a"], inp["loader_b"]), LOADER_BATCH,
                         order=inp["loader_order"], drop_remainder=False,
                         transform=lambda a, b: (a * 2, b + 1), mesh=mesh, device=None)
    out = {"loader_len": np.int64(len(loader))}
    for i, batch in enumerate(loader):
        assert all(isinstance(t, DTensor) and t.shape[0] == LOADER_BATCH for t in batch)
        out[f"loader_{i}_a"], out[f"loader_{i}_b"] = (t.to_local().numpy() for t in batch)
    try:
        BatchLoader((inp["loader_a"],), LOADER_BATCH + 1, mesh=mesh, device=None)
    except ValueError as e:
        out["loader_uneven"] = np.asarray(str(e))
    return out


def _rank_multihost(mesh, inp) -> dict:
    """tests/test_multihost.py's worker: each rank feeds its host-local
    slice of the global batch (as a DTensor sharded over ``data``)."""
    import torch
    from torch.distributed.tensor import DTensor

    from otto_tpu_torch.models.ranker import tower_params_from_numpy
    from otto_tpu_torch.parallel import host_shard_sessions, make_dp_ranker_step
    from otto_tpu_torch.parallel.mesh import batch_sharded

    rows = host_shard_sessions(16)
    jp = {k[len("jmh_"):]: v for k, v in inp.items() if k.startswith("jmh_")}
    out = {}
    for tag in ("local", "whole"):
        tower = tower_params_from_numpy(jp, device="cpu")
        step = make_dp_ranker_step(mesh, torch.optim.SGD(tower.parameters(), lr=0.1),
                                   loss_name="lambdarank")
        batch = [inp[f"mh_{k}"] for k in ("x", "y", "m")]
        if tag == "local":
            batch = [DTensor.from_local(torch.from_numpy(a[rows]), mesh, batch_sharded(mesh),
                                        run_check=False) for a in batch]
        out[f"mh_{tag}_loss"] = np.float32(step(tower, *batch))
        # JAX's first leaf: the parameters in sorted order, b0 first
        first = sorted(tower.named_parameters())[0][1]
        out[f"mh_{tag}_leaf0"] = np.float32(first.detach().reshape(-1)[0])
    return out


TASKS = {8: (_rank_grow, _rank_fits, _rank_ranker_steps, _rank_sequence, _rank_zero,
             _rank_loader),
         4: (_rank_grow, _rank_zero, _rank_loader),
         2: (_rank_fits, _rank_multihost)}


def _rank_gbdt_ranker(mesh, inp) -> dict:
    from otto_tpu_torch.models.gbdt import train_gbdt_ranker

    model, oof = train_gbdt_ranker(_ranker_data(inp), _gbdt_config(), mesh=mesh, device=None)
    out = {"rk_oof": oof, "rk_edges": model.edges}
    for i, f in enumerate(model.forests):
        out.update(_forest_arrays(f, f"rk_fold{i}"))
    return out


TASKS[4] += (_rank_gbdt_ranker,)


def _worker(world: int, d: Path) -> None:
    import torch
    import torch.distributed as dist

    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.parallel import init_distributed, make_mesh

    torch.set_num_threads(1)
    assert init_distributed("gloo", timeout_s=100)
    inp = dict(np.load(d / "in.npz"))
    mesh = make_mesh(MeshConfig(data_parallel=world, model_parallel=1), device_type="cpu")
    out = {}
    for task in TASKS[world]:
        out.update(task(mesh, inp))
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "otto_tpu"))
    assert not bad, bad
    np.savez(d / f"w{world}_rank{dist.get_rank()}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(int(sys.argv[1]), Path(sys.argv[2]))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _launch(world: int, d: Path) -> list[dict]:
    from otto_tpu_torch.parallel.mesh import launch_local

    env = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    launch_local([sys.executable, __file__, str(world), str(d)], world, timeout_s=150, env=env)
    return [dict(np.load(d / f"w{world}_rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax

    from otto_tpu.models.ranker import init_tower
    from otto_tpu.models.sequence import init_params

    d = tmp_path_factory.mktemp("dp")
    inp = _inputs()
    for k, v in init_tower(jax.random.PRNGKey(0), 4, (8,)).items():  # tests/test_parallel.py:94
        inp[f"jtower_{k}"] = np.asarray(v)
    for k, v in init_tower(jax.random.PRNGKey(1), 6, (16, 8)).items():  # test_multihost.py:64
        inp[f"jmh_{k}"] = np.asarray(v)
    for arch, n_layers in (("gru", 1), ("transformer", 1), ("transformer", 2)):
        p = init_params(jax.random.PRNGKey(0), SEQ["n_aids"], SEQ["dim"], SEQ["hidden"],
                        architecture=arch, max_len=SEQ["max_len"], n_layers=n_layers,
                        n_heads=SEQ["n_heads"])
        for i, leaf in enumerate(jax.tree_util.tree_leaves(p)):
            inp[f"jseq_{arch}{n_layers}_{i}"] = np.asarray(leaf)
    np.savez(d / "in.npz", **inp)
    inp = dict(np.load(d / "in.npz"))
    return dict(inp=inp, out={w: _launch(w, d) for w in (8, 4, 2)})


@pytest.fixture(scope="module")
def jax_mesh8():
    import jax

    from otto_tpu.config import MeshConfig
    from otto_tpu.parallel.mesh import make_mesh

    return make_mesh(MeshConfig(data_parallel=8, model_parallel=1), devices=jax.devices()[:8])


def _close(a, b) -> bool:
    """Equal bit for bit (dtype, shape and bytes)."""
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dyadic", [True, False])
def test_node_histograms_over_split_rows_equal_the_whole(dyadic):
    """Two halves of the rows, each summed with the whole's scale and its
    sums added to the other's before the rounding, give the whole's
    histogram: the twin (float64) on dyadic vals, the kernel's fixed-point
    arithmetic on any."""
    import torch

    from otto_tpu_torch.ops import hist

    rng = np.random.default_rng(7)
    N, F, nb, n_keys = 301, 37, 32, 3
    binned = torch.as_tensor(rng.integers(0, nb + 2, (N, F)).astype(np.uint8))
    key = torch.as_tensor(rng.integers(-1, n_keys, N).astype(np.int32))
    vals = rng.normal(size=(N, 3)) * np.asarray([1.0, 1e-3, 50.0])
    if dyadic:
        vals = np.round(vals * 64) / 64
    vals = torch.as_tensor(vals.astype(np.float32))
    vmax = vals.abs().amax(dim=0)
    halves = (slice(0, 140), slice(140, N))
    if dyadic:
        whole = hist.build_histogram(binned, key, vals, n_keys, nb)
        rows = hist.pad_rows(binned)
        parts = []
        for sl in halves:
            keys = key[sl]
            order = torch.argsort(keys.long(), stable=True)
            counts = torch.bincount(keys[keys >= 0].long(), minlength=n_keys)
            pre = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
            start = pre[:-1] + int((keys < 0).sum())
            parts.append((rows[sl], vals[sl], order.to(torch.int32), start, pre))
        sums = []

        def keep(acc):
            sums.append(acc.clone())

        def add(acc):
            acc += sums[0]

        a_rows, a_vals, a_order, a_start, a_pre = parts[0]
        b_rows, b_vals, b_order, b_start, b_pre = parts[1]
        hist.node_histograms(a_rows, F, a_vals, vmax, a_order, a_start, a_pre, nb,
                             scale_rows=N, reduce=keep)
        got = hist.node_histograms(b_rows, F, b_vals, vmax, b_order, b_start, b_pre, nb,
                                   scale_rows=N, reduce=add)
        assert torch.equal(got, whole)
    else:
        whole = hist._fixed_point_histogram(binned, key, vals, n_keys, nb)
        sums = []
        hist._fixed_point_histogram(binned[halves[0]], key[halves[0]], vals[halves[0]], n_keys,
                                    nb, scale_rows=N, vmax=vmax,
                                    reduce=lambda acc: sums.append(acc.clone()))
        got = hist._fixed_point_histogram(binned[halves[1]], key[halves[1]], vals[halves[1]],
                                          n_keys, nb, scale_rows=N, vmax=vmax,
                                          reduce=lambda acc: acc.add_(sums[0]))
        assert _close(got.numpy(), whole.numpy())
        # a half's own scale (its rows and its largest |val|) is another
        # quantisation: the sums must take the whole's
        alone = hist._fixed_point_histogram(binned[halves[1]], key[halves[1]],
                                            vals[halves[1]], n_keys, nb)
        assert not _close(alone.numpy(), got.numpy())


def test_node_histograms_checks_scale_rows():
    import torch

    from otto_tpu_torch.ops import hist

    rows = hist.pad_rows(torch.zeros((4, 3), dtype=torch.uint8))
    args = (rows, 3, torch.ones((4, 3)), torch.ones(3), torch.arange(4, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int64), torch.tensor([0, 4]), 8)
    with pytest.raises(ValueError, match="scale_rows"):
        hist.node_histograms(*args, scale_rows=3)
    assert float(hist.node_histograms(*args, scale_rows=10)[0, 0, 0, 2]) == 4.0


def _grow_weight(inp: dict, tag: str) -> np.ndarray:
    return inp["grow_weight"] if tag == "dyadic" else np.ones(GROW["N"], np.float32)


@pytest.mark.parametrize("world", [8, 4])
@pytest.mark.parametrize("tag", ["dyadic", "normal"])
def test_dp_grow_bit_equal_to_grow_tree(ranks, world, tag):
    import torch

    from otto_tpu_torch.models.gbdt import _grow_tree

    inp = ranks["inp"]
    want = _grow_tree(*(torch.as_tensor(inp[f"grow_{k}"]) for k in (
        "binned", f"{tag}_g", f"{tag}_h")), torch.as_tensor(_grow_weight(inp, tag)),
        torch.ones(GROW["N"]), torch.ones(GROW["F"], dtype=torch.bool), *GROW_SCALARS,
        depth=GROW["depth"], n_bins=GROW["n_bins"])
    assert int((want[1] < GROW["n_bins"]).sum()) >= 4  # the tree splits
    for o in ranks["out"][world]:
        for k, w in zip(("feat", "thr", "leaf", "gain", "ids"), want):
            assert _close(o[f"grow_{tag}_{k}"], w.numpy()), k


def test_dp_grow_equal_to_jax(ranks, jax_mesh8):
    import jax.numpy as jnp

    from otto_tpu.parallel import make_dp_gbdt_grow as jgrow

    inp = ranks["inp"]
    N, F = GROW["N"], GROW["F"]
    want = jgrow(jax_mesh8, depth=GROW["depth"], n_bins=GROW["n_bins"])(
        jnp.asarray(inp["grow_binned"]), jnp.asarray(inp["grow_dyadic_g"]),
        jnp.asarray(inp["grow_dyadic_h"]), jnp.asarray(inp["grow_weight"]),
        jnp.ones(N, jnp.float32), jnp.ones(F, bool), *(jnp.float32(s) for s in GROW_SCALARS))
    for o in ranks["out"][8]:
        np.testing.assert_array_equal(o["grow_dyadic_feat"], np.asarray(want[0]))
        np.testing.assert_array_equal(o["grow_dyadic_thr"], np.asarray(want[1]))
        np.testing.assert_allclose(o["grow_dyadic_leaf"], np.asarray(want[2]), rtol=1e-4)
        np.testing.assert_array_equal(o["grow_dyadic_ids"], np.asarray(want[4]))


@pytest.mark.parametrize("world", [8, 2])
@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_gbdt_mesh_equal_to_single_process(ranks, world, case):
    """``fit_gbdt(mesh=)`` (formerly held to raise): every rank's forest is
    the single-process fit's."""
    from otto_tpu_torch.models.gbdt import fit_gbdt

    args, val = _fit_args(ranks["inp"], case)
    want = _forest_arrays(fit_gbdt(*args, val=val, device="cpu"), case)
    if case == "bagged":
        assert 0 < int(want["bagged_best_iteration"]) < FIT_CASES[case]["n_trees"]
    for o in ranks["out"][world]:
        for k, v in want.items():
            assert _close(o[k], v), k


def test_fit_gbdt_mesh_learns_the_ranking(ranks):
    """tests/test_gbdt.py:290-305's bar, on the dp-8 forest."""
    import torch

    from otto_tpu_torch.ops import forest

    inp, o = ranks["inp"], ranks["out"][8][0]
    b, y, m = inp["fit_binned"][:250], inp["fit_labels"][:250], inp["fit_mask"][:250]
    pack = forest.pack_forests([(o["plain_feat"], o["plain_thr"], o["plain_leaf"],
                                 float(o["plain_base"]))], device="cpu")
    scores = forest.predict_forest(torch.as_tensor(b.reshape(-1, b.shape[-1])), pack)
    scores = np.where(m, scores.numpy().reshape(m.shape), -np.inf)
    top1 = np.take_along_axis(y, np.argmax(scores, axis=1)[:, None], axis=1)
    assert top1.mean() > 0.8


def test_train_gbdt_ranker_mesh_equal_to_single_process(ranks):
    """``train_gbdt_ranker(mesh=)`` (formerly held to raise) at dp 4."""
    from otto_tpu_torch.models.gbdt import train_gbdt_ranker

    model, oof = train_gbdt_ranker(_ranker_data(ranks["inp"]), _gbdt_config(), device="cpu")
    want = {"rk_oof": oof, "rk_edges": model.edges}
    for i, f in enumerate(model.forests):
        want.update(_forest_arrays(f, f"rk_fold{i}"))
    for o in ranks["out"][4]:
        for k, v in want.items():
            assert _close(o[k], v), k


@pytest.mark.parametrize("opt_name,loss", RANKER_CASES)
def test_dp_ranker_step_equal_to_jax(ranks, jax_mesh8, opt_name, loss):
    import jax
    import jax.numpy as jnp
    import optax

    from otto_tpu.parallel import make_dp_ranker_step

    inp = ranks["inp"]
    params = {k[len("jtower_"):]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith("jtower_")}
    opt = optax.sgd(0.1) if opt_name == "sgd" else optax.adamw(1e-3)
    step = make_dp_ranker_step(jax_mesh8, opt, loss_name=loss, dropout=0.0)
    new, _, value = step(params, opt.init(params), jnp.asarray(inp["tower_x"]),
                         jnp.asarray(inp["tower_y"]), jnp.asarray(inp["tower_m"]),
                         jax.random.PRNGKey(1))
    last_bias = f"b{sum(1 for k in new if k.startswith('w')) - 1}"
    for o in ranks["out"][8]:
        assert float(o[f"tower_{opt_name}_{loss}_loss"]) == pytest.approx(float(value), rel=1e-5)
        for k, v in new.items():
            got = o[f"tower_{opt_name}_{loss}_{k}"]
            if (opt_name, loss, k) == ("adamw", "lambdarank", last_bias):
                # a pairwise loss does not change when every score shifts, so
                # the output bias's gradient is 0 but for rounding (~1e-9),
                # and Adam's first step moves it by lr * g / (|g| + eps):
                # anywhere in [-lr, lr] (tests/test_torch_ranker.py's bound)
                assert np.abs(got - np.asarray(v)).max() <= 2 * 1e-3
                continue
            np.testing.assert_allclose(got, np.asarray(v), rtol=2e-4, atol=1e-6, err_msg=k)


def test_dp_steps_refuse_an_uneven_batch(ranks):
    assert "does not split over the 8 ranks" in str(ranks["out"][8][0]["uneven"])


@pytest.mark.parametrize("arch", ["gru", "transformer"])
def test_dp_sequence_step_equal_to_jax(ranks, jax_mesh8, arch):
    import jax
    import jax.numpy as jnp
    import optax

    from otto_tpu.models.sequence import init_params
    from otto_tpu.parallel import make_dp_sequence_step

    inp = ranks["inp"]
    params = init_params(jax.random.PRNGKey(0), SEQ["n_aids"], SEQ["dim"], SEQ["hidden"],
                         architecture=arch, max_len=SEQ["max_len"], n_layers=1,
                         n_heads=SEQ["n_heads"])
    opt = optax.adam(1e-2)
    new, _, value = make_dp_sequence_step(jax_mesh8, opt)(
        params, opt.init(params), *(jnp.asarray(a) for a in _seq_batch_of(inp, 0)))
    for o in ranks["out"][8]:
        assert abs(float(o[f"seq_{arch}_loss"]) - float(value)) < 1e-4
        for i, leaf in enumerate(jax.tree_util.tree_leaves(new)):
            np.testing.assert_allclose(o[f"seq_{arch}_{i}"], np.asarray(leaf), atol=2e-4)


@pytest.mark.parametrize("world", [8, 4])
def test_zero_step_equal_to_dp_step(ranks, world):
    for o in ranks["out"][world]:
        for i in range(1, 4):
            assert abs(float(o[f"zero_loss{i}"]) - float(o[f"zero_dp_loss{i}"])) < 1e-5
        n = sum(1 for k in o if k.startswith("zero_dp_") and "loss" not in k)
        assert n > 10
        for i in range(n):
            np.testing.assert_allclose(o[f"zero_{i}"], o[f"zero_dp_{i}"], rtol=0, atol=1e-5)
        assert int(o["zero_state_numel"]) <= (int(o["dp_state_numel"]) / world
                                              + int(o["zero_state_tensors"]))


@pytest.mark.parametrize("world", [8, 4])
def test_batch_loader_mesh_blocks_make_the_batch(ranks, world):
    import torch

    from otto_tpu_torch.data.loader import BatchLoader

    inp, outs = ranks["inp"], ranks["out"][world]
    single = list(BatchLoader((inp["loader_a"], inp["loader_b"]), LOADER_BATCH,
                              order=inp["loader_order"], drop_remainder=False,
                              transform=lambda a, b: (a * 2, b + 1), device="cpu"))
    assert all(int(o["loader_len"]) == len(single) == 5 for o in outs)
    for i, (a, b) in enumerate(single):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(np.concatenate([o[f"loader_{i}_a"] for o in outs]),
                                      a.numpy())
        np.testing.assert_array_equal(np.concatenate([o[f"loader_{i}_b"] for o in outs]),
                                      b.numpy())
    assert "does not split" in str(outs[0]["loader_uneven"])


def test_two_ranks_host_local_blocks(ranks):
    """tests/test_multihost.py's check: both ranks' loss and first leaf
    equal, equal to the whole batch's run, and to JAX's single process on a
    two-device mesh within the dp step's limits."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from otto_tpu.parallel.data_parallel import make_dp_ranker_step

    inp, outs = ranks["inp"], ranks["out"][2]
    for key in ("loss", "leaf0"):
        got = {float(o[f"mh_local_{key}"]) for o in outs} | {float(o[f"mh_whole_{key}"])
                                                             for o in outs}
        assert len(got) == 1, (key, got)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    params = {k[len("jmh_"):]: jnp.asarray(v) for k, v in inp.items() if k.startswith("jmh_")}
    opt = optax.sgd(0.1)
    new, _, loss = make_dp_ranker_step(mesh, opt, loss_name="lambdarank", dropout=0.0)(
        params, opt.init(params), *(jnp.asarray(inp[f"mh_{k}"]) for k in ("x", "y", "m")),
        jax.random.PRNGKey(2))
    assert float(outs[0]["mh_local_loss"]) == pytest.approx(float(loss), rel=1e-5)
    want = float(np.asarray(jax.tree_util.tree_leaves(new)[0]).ravel()[0])
    assert float(outs[0]["mh_local_leaf0"]) == pytest.approx(want, rel=2e-4, abs=1e-6)


def test_make_mesh_without_a_card_raises():
    """No fallback to the CPU: a mesh is on the cards unless
    ``device_type="cpu"`` asks (this machine has no card)."""
    import torch

    from otto_tpu_torch.config import MeshConfig
    from otto_tpu_torch.parallel import make_mesh, make_mesh3d

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        make_mesh(MeshConfig())
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        make_mesh3d(1, 1, 1)
    with pytest.raises(ValueError, match="neither"):
        make_mesh(MeshConfig(), device_type="tpu")
