"""The sequence recommenders on the card against the CPU, and the kernels
their serving path launches.

Marked ``cuda``: without a card these tests skip.  The module imports no
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sequence.py

Tolerances (those of ``chip_smoke.py`` phase 14a): session vectors within
1e-5 * (|x| + 0.1 max |x|) (cuBLAS sums the float32 products in other
orders, and the GRU carries the difference through 20 steps: some 1e-7 of
the vectors' O(1) scale, beyond 1e-5 of an entry near 0);
one training step's loss within 1e-5 relative and every updated parameter
within 1e-4 * (|x| + 0.01), but for entries whose CPU gradient is at most
1e-4 of its leaf's largest: Adam's first step moves an entry by
lr * g / (|g| + eps), about +-lr whatever |g|, so there a gradient at the
level of its rounding error decides the sign (those are held within
2 * lr and must be rare).
"""

import numpy as np
import pytest
import torch

from otto_tpu_torch.config import SequenceModelConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.models import sequence as tseq
from otto_tpu_torch.ops import fused_retrieval, fused_sessions, row_topk

VARIANTS = [("gru", 0, "sampled_softmax"), ("gru", 0, "bpr_max"), ("narm", 0, "sampled_softmax"),
            ("stamp", 0, "sampled_softmax"), ("caser", 0, "sampled_softmax"),
            ("transformer", 0, "sampled_softmax"), ("transformer", 4, "sampled_softmax")]
IDS = ["gru", "gru4rec_plus", "narm", "stamp", "caser", "transformer", "moe"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _config(arch, moe, loss, n_aids=50_000):
    """The published widths (configs/sequence_*.yaml) over a smaller catalog."""
    return SequenceModelConfig(n_aids=n_aids, dim=64, hidden=128, max_len=20, architecture=arch,
                               loss=loss, n_layers=2, n_heads=2, moe_experts=moe)


def _params(cfg, seed):
    return tseq.sequence_params_to_numpy(
        tseq._config_params(cfg, torch.Generator().manual_seed(seed)))


def _batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, cfg.max_len + 1, B)
    mask = np.arange(cfg.max_len)[None] < lens[:, None]
    seq = np.where(mask, rng.integers(0, cfg.n_aids, (B, cfg.max_len)), cfg.n_aids)
    return seq.astype(np.int32), mask


def step_matches(cpu: dict, card: dict, grads: dict, lr: float) -> int:
    """Hold the card's updated parameters to the CPU's (module docstring);
    returns the count of entries where Adam's sign was decided by a
    rounding-level gradient."""
    flipped = 0
    for c, g, grad in zip(tseq.tree_leaves(cpu), tseq.tree_leaves(card), tseq.tree_leaves(grads)):
        d = np.abs(g - c)
        off = d > 1e-4 * (np.abs(c) + 0.01)
        tiny = np.abs(grad) <= 1e-4 * np.abs(grad).max()
        assert not (off & ~tiny).any()
        assert (d[off] <= 2 * lr).all()
        flipped += int(off.sum())
    return flipped


@pytest.mark.cuda
@pytest.mark.parametrize("arch, moe, loss", VARIANTS, ids=IDS)
def test_cuda_encode_and_step_match_cpu(cuda_device, arch, moe, loss):
    cfg = _config(arch, moe, loss)
    params = _params(cfg, 1)
    seq, mask = _batch(cfg, 512, 2)
    rng = np.random.default_rng(3)
    tgt = rng.integers(0, cfg.n_aids, 512).astype(np.int32)
    negs = rng.integers(0, cfg.n_aids, (512, cfg.n_negatives)).astype(np.int32)
    out = {}
    for dev in ("cpu", cuda_device):
        p = tseq.sequence_params_from_numpy(params, cfg, device=dev)
        with torch.no_grad(), tseq.full_f32_matmul():
            vec = tseq.encode(p, torch.as_tensor(seq, device=dev),
                              torch.as_tensor(mask, device=dev)).cpu().numpy()
        p = tseq._tree_map(lambda t: t.requires_grad_(True), p)
        opt = tseq.make_optimizer(p, cfg)
        loss_v = tseq.train_step(p, opt, *(torch.as_tensor(a, device=dev)
                                           for a in (seq, mask, tgt, negs)), loss=loss)
        grads = tseq._tree_map(lambda t: t.grad.cpu().numpy(), p)
        out[str(dev)] = (vec, float(loss_v), tseq.sequence_params_to_numpy(p), grads)
    (cv, cl, cp, cg), (gv, gl, gp, _) = out["cpu"], out[str(cuda_device)]
    assert np.all(np.abs(gv - cv) <= 1e-5 * (np.abs(cv) + 0.1 * np.abs(cv).max()))
    assert gl == pytest.approx(cl, rel=1e-5)
    assert step_matches(cp, gp, cg, cfg.learning_rate) <= 1e-5 * sum(
        v.size for v in tseq.tree_leaves(cp))


def _sessions(n_sessions, n_aids, seed, min_events=1, max_events=30):
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_events, max_events + 1, n_sessions)
    sess = np.repeat(np.arange(n_sessions), lens)
    aid = rng.integers(0, n_aids, len(sess))
    typ = rng.integers(0, 3, len(sess)).astype(np.int8)
    return EventStore.from_flat(sess, aid, np.arange(len(sess)), typ)


@pytest.mark.cuda
def test_cuda_full_sort_topk_launches_k1_k2(cuda_device):
    """A catalog above 4 x 16,384 items takes the fused route on the card
    (K1, K2); its lists against the CPU twins': recall >= 0.99."""
    cfg = _config("gru", 0, "sampled_softmax", n_aids=100_000)
    params = _params(cfg, 4)
    params["item_emb"] = np.random.default_rng(5).normal(size=params["item_emb"].shape).astype(
        np.float32)
    store = _sessions(2_000, cfg.n_aids, 6)
    fused_retrieval.fused_stage1.launches = row_topk.peel_rows.launches = 0
    lists = {}
    for dev in ("cpu", cuda_device):
        model = tseq.SequenceModel(tseq.sequence_params_from_numpy(params, cfg, device=dev), cfg)
        lists[str(dev)] = model.full_sort_topk(store, k=20)
    assert fused_retrieval.fused_stage1.launches == 1  # 2,000 sessions: one batch
    assert row_topk.peel_rows.launches == 1
    got, want = lists[str(cuda_device)], lists["cpu"]
    assert np.mean([len(set(a) & set(b)) / 20 for a, b in zip(got, want)]) >= 0.99


@pytest.mark.cuda
def test_cuda_recency_route_launches_the_block_kernel(cuda_device):
    """Sessions of >= 20 distinct aids go to the recency route, packed 256
    wide: K3's block kernel (L > 128) on the card, equal to the CPU's
    lists but for near-ties (float32 sums in another order)."""
    cfg = _config("gru", 0, "sampled_softmax", n_aids=5_000)
    params = _params(cfg, 7)
    store = _sessions(600, cfg.n_aids, 8, min_events=25, max_events=300)
    fused_sessions.aid_vote_aggregate.launches = 0
    out = {}
    for dev in ("cpu", cuda_device):
        model = tseq.SequenceModel(tseq.sequence_params_from_numpy(params, cfg, device=dev), cfg)
        out[str(dev)] = tseq.sequence_serving_predictions(store, model, k=20)["clicks"]
    assert fused_sessions.aid_vote_aggregate.launches == 1
    got, want = out[str(cuda_device)], out["cpu"]
    assert (got >= 0).all()
    assert (got == want).all(axis=1).mean() >= 0.99
