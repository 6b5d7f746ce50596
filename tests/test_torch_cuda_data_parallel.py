"""Data-parallel GBDT growth on the card: K5's entry split so that its int64
fixed-point sums can cross ranks, and ``fit_gbdt`` over a world-1 NCCL mesh
in this process.

Marked ``cuda``: without a card these tests skip.  The module imports no
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_data_parallel.py

Tolerances: bit-equal everywhere (the sums are integers).
"""

import numpy as np
import pytest
import torch

from otto_tpu_torch.config import GBDTConfig, MeshConfig


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


def _row_list(key: torch.Tensor, n_keys: int):
    """The rows grouped by key (rows of key -1 first, unlisted)."""
    order = torch.argsort(key.long(), stable=True)
    counts = torch.bincount(key[key >= 0].long(), minlength=n_keys)
    pre = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return order.to(torch.int32), pre[:-1] + int((key < 0).sum()), pre


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,n_bins,n_keys,cut", [(20_000, 55, 256, 1, 9_001),
                                                   (77_777, 37, 64, 16, 1),
                                                   (4_096, 128, 256, 5, 4_096)])
def test_cuda_histogram_halves_summed_before_the_finish(n, f, n_bins, n_keys, cut):
    """K5 over two halves of the rows, at the whole's scale, their int64
    sums added before the finish, is bit-equal to one launch over all the
    rows; a block with no row listed, or no rows at all, still launches and
    hands its zero sums to ``reduce``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from otto_tpu_torch.ops import hist

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(n + f)
    binned = torch.randint(0, n_bins + 3, (n, f), generator=g, device=dev).to(torch.uint8)
    key = torch.randint(-1, n_keys, (n,), generator=g, device=dev).to(torch.int32)
    vals = torch.randn((n, 3), generator=g, device=dev) * torch.tensor([1.0, 1e-3, 30.0],
                                                                        device=dev)
    vmax = vals.abs().amax(dim=0)
    rows = hist.pad_rows(binned)
    whole = hist.node_histograms(rows, f, vals, vmax, *_row_list(key, n_keys), n_bins)
    sums = []
    parts = []
    for sl in (slice(0, cut), slice(cut, n)):
        parts.append(hist.node_histograms(
            rows[sl].contiguous(), f, vals[sl].contiguous(), vmax, *_row_list(key[sl], n_keys),
            n_bins, scale_rows=n,
            reduce=(lambda acc: sums.append(acc.clone())) if not sums else
            (lambda acc: acc.add_(sums[0]))))
    assert torch.equal(parts[1].view(torch.int32), whole.view(torch.int32))
    # a rank whose block lists no row, and one with no rows at all
    none_listed = hist.node_histograms(rows[:10].contiguous(), f, vals[:10].contiguous(), vmax,
                                       torch.zeros(0, dtype=torch.int32, device=dev),
                                       torch.zeros(n_keys, dtype=torch.int64, device=dev),
                                       torch.zeros(n_keys + 1, dtype=torch.int64, device=dev),
                                       n_bins, scale_rows=n, reduce=lambda acc: acc.add_(1))
    empty = hist.node_histograms(rows[:0], f, vals[:0], vmax,
                                 torch.zeros(0, dtype=torch.int32, device=dev),
                                 torch.zeros(n_keys, dtype=torch.int64, device=dev),
                                 torch.zeros(n_keys + 1, dtype=torch.int64, device=dev),
                                 n_bins, scale_rows=n, reduce=lambda acc: acc.add_(1))
    for h in (none_listed, empty):  # 1 quantum a cell: 2^-s_c
        assert bool((h > 0).all()) and bool((h < 1e-6 * vmax.max()).all())


def _fold(seed: int, S: int = 600, C: int = 40, F: int = 24):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, 64, (S, C, F)).astype(np.uint8)
    labels = (rng.random((S, C)) < 0.1).astype(np.int8)
    labels[:, 0] |= (binned[:, 0, 0] > 40).astype(np.int8)
    mask = rng.random((S, C)) < 0.95
    return binned, labels & mask, mask


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["bce", "lambdarank"])
def test_cuda_fit_gbdt_one_rank_mesh_bit_equal_to_plain(mesh, loss):
    from otto_tpu_torch.models.gbdt import fit_gbdt
    from otto_tpu_torch.ops import hist

    binned, labels, mask = _fold(3)
    cfg = GBDTConfig(n_trees=12, max_depth=6, n_bins=64, loss=loss, eval_every=2,
                     early_stopping_rounds=6, min_data_in_leaf=20)
    args = (binned[:500], labels[:500], mask[:500], mask[:500].astype(np.float32), cfg)
    val = (binned[500:], labels[500:], mask[500:])
    before = hist.node_histograms.launches
    plain = fit_gbdt(*args, val=val, device="cuda")
    mid = hist.node_histograms.launches
    dp = fit_gbdt(*args, val=val, mesh=mesh, device=None)
    # K5: one launch a level on both routes (early stopping waits >= 6 trees)
    assert mid - before == hist.node_histograms.launches - mid >= 6 * cfg.max_depth
    for k in ("feat", "thr", "leaf", "gain_importance", "split_importance"):
        a, b = getattr(plain, k), getattr(dp, k)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), k
    assert plain.best_iteration == dp.best_iteration and plain.base == dp.base
