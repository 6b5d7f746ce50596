"""Each hand-written CUDA kernel against its plain-torch twin, on the card.

Marked ``cuda``: without a card these tests skip (the kernels have no CPU
mode).  The module imports no JAX, so it also runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Shapes are the full-width ones of the serving path (1,855,603 items: stage 1
over 1,867,776 padded columns, the peel over [B, 14,592] at the neighbor
table's batches, 4096 and 115 rows; the bf16 stage-1 kernel also at those
batches over 6 chunks, and its FMA route at DA 257 and 300).  Tolerances:
the peel and stage 1 on integer-valued inputs are bit-equal; stage 1 on
normal data may move a packed maximum by one truncation step and change its
7-bit position code, so values agree within 2^8 ulps = 2^-15 relative and
the window position on >= 99.9% of windows.  The session vote runs at the
aid-weight path's shape [20,000, 76], at [4096, 256], at a ragged L and at
L = 300 (the block kernel): ``first`` and ``firstpos`` bit-equal, ``agg``
bit-equal on integer weights and within 2^-16 * sum_j |w_j| of its row on
normal weights.  The forest kernel routes the committed fold models at 1,
115 and 1,472,000 rows (the two-stage replay's rows a type): bit-equal to
its twin (the same float32 additions in the same order).
"""

import pytest
import torch

from otto_tpu_torch.ops import fused_retrieval as tfr
from otto_tpu_torch.ops import fused_sessions as tfs
from otto_tpu_torch.ops import row_topk as trt

N_PAD = 114 * 16384


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _peel_case(case, b, g, dev):
    m = N_PAD // 128
    if case == "normal":
        x = torch.randn((b, m), generator=g, device=dev)
        x[:, 5] = x[:, 7] = x[:, 100] = 9.0  # ties inside a window
        x[:, 128:256] = 3.0                  # an all-equal window
        return x
    if case == "ties":  # few distinct values: windows run out before R = 21
        return torch.randint(0, 6, (b, m), generator=g, device=dev).float()
    if case == "neginf":
        x = torch.randn((b, m), generator=g, device=dev)
        x[torch.rand((b, m), generator=g, device=dev) < 0.3] = float("-inf")
        x[:, 256:384] = float("-inf")
        x[:, 390:500] = float("-inf")
        return x
    # K1's pad windows: bit patterns in [0, 128), denormals kept distinct
    return torch.randint(0, 128, (b, m), generator=g, device=dev,
                         dtype=torch.int32).view(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4096, 115])
@pytest.mark.parametrize("case", ["normal", "ties", "neginf", "denormal"])
def test_cuda_peel_kernel_bit_equal_to_twin(cuda_device, case, b):
    g = torch.Generator(device=cuda_device).manual_seed(b)
    x = _peel_case(case, b, g, cuda_device)
    for rounds in (1, 6, 21, 40):
        before = trt.peel_rows.launches
        kv, kc = trt.peel_rows(x, rounds)
        torch.cuda.synchronize()
        assert trt.peel_rows.launches == before + 1
        rv, rc = trt.peel_rows_reference(x, rounds)
        assert torch.equal(kv.view(torch.int32), rv.view(torch.int32)), rounds
        assert torch.equal(kc, rc), rounds
    with pytest.raises(TypeError):
        trt.peel_rows(x.to(torch.float64), 6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_pad", [(256, N_PAD), (115, 6 * 16384), (4096, 6 * 16384)])
@pytest.mark.parametrize("da", [34, 102])
def test_cuda_stage1_kernel_matches_twin(cuda_device, da, b, n_pad):
    """The bf16 (wgmma) kernel at full width, and at the neighbor table's
    batch sizes (4096, and 115 for the last batch) on a slice of 6 chunks."""
    g = torch.Generator(device=cuda_device).manual_seed(da + b)
    q = torch.randint(-8, 9, (b, da), generator=g, device=cuda_device).to(torch.bfloat16)
    t = torch.randint(-8, 9, (da, n_pad), generator=g, device=cuda_device).to(torch.bfloat16)
    t[:, n_pad - 12_173:] = 0  # pad columns (as many as the full table has)
    before = tfr.fused_stage1.launches
    k = tfr.fused_stage1(q, t)
    torch.cuda.synchronize()
    assert tfr.fused_stage1.launches == before + 1
    r = tfr._stage1_reference(q, t)
    assert torch.equal(k.view(torch.int32), r.view(torch.int32))

    qn = torch.randn((b, da), generator=g, device=cuda_device)
    qn[:, -1] = 128.0
    tn = torch.randn((da, n_pad), generator=g, device=cuda_device)
    tn[-1] = 1.0
    k = tfr.fused_stage1(qn.to(torch.bfloat16), tn.to(torch.bfloat16))
    r = tfr._stage1_reference(qn.to(torch.bfloat16), tn.to(torch.bfloat16))
    torch.testing.assert_close(k, r, rtol=2.0**-15, atol=0)
    same = (k.view(torch.int32) & 127) == (r.view(torch.int32) & 127)
    assert same.float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("da", [1, 198, 256, 257, 300])
def test_cuda_stage1_kernel_contraction_depths(cuda_device, da):
    """The bf16 kernels at the other depths they take: one k step, a 64-dim
    compensated table (198), the wgmma kernel's deepest (256, a 3-slot
    ring), and past it (257, 300), where the FMA route takes over; deeper
    than the FMA kernel's query tile holds (1,817) raises.  The queries
    carry the retriever's positive shift in their last dimension, so no row
    is all zeros (whose scores the padded product would give as +0.0 where
    the twin gives -0.0)."""
    g = torch.Generator(device=cuda_device).manual_seed(da)
    q = torch.randint(-8, 9, (130, da), generator=g, device=cuda_device).to(torch.bfloat16)
    q[:, -1] = 64
    t = torch.randint(-8, 9, (da, 2 * 16384), generator=g, device=cuda_device).to(torch.bfloat16)
    wgmma, fma = tfr.fused_stage1.launches, tfr.fused_stage1.fma_launches
    k = tfr.fused_stage1(q, t)
    torch.cuda.synchronize()
    deep = da > tfr.K1_WGMMA_MAX_DA
    assert tfr.fused_stage1.launches == wgmma + (not deep)
    assert tfr.fused_stage1.fma_launches == fma + deep
    r = tfr._stage1_reference(q, t)
    assert torch.equal(k.view(torch.int32), r.view(torch.int32))
    with pytest.raises(ValueError):
        tfr.fused_stage1(torch.zeros((4, 1817), dtype=torch.bfloat16, device=cuda_device),
                         torch.zeros((1817, 16384), dtype=torch.bfloat16, device=cuda_device))


@pytest.mark.cuda
def test_cuda_stage1_f32_table_and_ragged_batch(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randint(-8, 9, (37, 34), generator=g, device=cuda_device).float()
    t = torch.randint(-8, 9, (34, 3 * 16384), generator=g, device=cuda_device).float()
    k = tfr.fused_stage1(q, t)
    r = tfr._stage1_reference(q, t)
    assert torch.equal(k.view(torch.int32), r.view(torch.int32))


@pytest.mark.cuda
def test_cuda_retriever_matches_twin_path(cuda_device):
    """The whole fused top-k on the card against the same path on the CPU."""
    g = torch.Generator().manual_seed(2)
    items = torch.randint(-8, 9, (5 * 16384 + 123, 32), generator=g).float()
    queries = torch.randint(-8, 9, (16, 32), generator=g).float()
    for precision in ("single", "compensated"):
        cpu = tfr.FusedRetriever(items, metric="euclidean", precision=precision, device="cpu")
        gpu = tfr.FusedRetriever(items, metric="euclidean", precision=precision,
                                 device=cuda_device)
        cs, ci = cpu.topk(queries, k=20)
        gs, gi = gpu.topk(queries, k=20)
        assert torch.equal(gi.cpu(), ci)
        assert torch.equal(gs.cpu(), cs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(20000, 76), (4096, 256), (333, 77), (257, 300), (64, 1)])
def test_cuda_vote_kernel_matches_twin(cuda_device, shape):
    """Rows kernel (L <= 128) and block kernel (longer rows), with
    all-padding, all-equal and interior-padding rows."""
    S, L = shape
    g = torch.Generator(device=cuda_device).manual_seed(L)
    aids = torch.randint(0, 24, shape, generator=g, device=cuda_device, dtype=torch.int32)
    tail = torch.randint(0, L + 1, (S, 1), generator=g, device=cuda_device)
    aids[torch.arange(L, device=cuda_device)[None, :] >= L - tail] = -1
    aids[0] = -1
    aids[1] = 5
    aids[2, ::3] = -1
    for w in (torch.randint(1, 7, shape, generator=g, device=cuda_device).float(),
              torch.randn(shape, generator=g, device=cuda_device)):
        w = torch.where(aids >= 0, w, 0.0)
        before = tfs.aid_vote_aggregate.launches
        ka, kf, kp = tfs.aid_vote_aggregate(aids, w)
        torch.cuda.synchronize()
        assert tfs.aid_vote_aggregate.launches == before + 1
        ra, rf, rp = (torch.cat(x) for x in zip(*(
            tfs._vote_reference(aids[i:i + 2048], w[i:i + 2048]) for i in range(0, S, 2048))))
        assert torch.equal(kf, rf) and torch.equal(kp, rp)
        bound = 2.0**-16 * w.abs().sum(dim=1, keepdim=True)
        assert bool(((ka - ra).abs() <= bound).all())
    assert torch.equal(ka[aids < 0], torch.zeros_like(ka[aids < 0]))
    int_w = torch.randint(1, 7, shape, generator=g, device=cuda_device).float()
    assert torch.equal(tfs.aid_vote_aggregate(aids, int_w)[0],
                       torch.cat([tfs._vote_reference(aids[i:i + 2048], int_w[i:i + 2048])[0]
                                  for i in range(0, S, 2048)]))
    with pytest.raises(TypeError):
        tfs.aid_vote_aggregate(aids.long(), w)
    with pytest.raises(ValueError):  # a strided view, non-contiguous at every L
        tfs.aid_vote_aggregate(aids.repeat(1, 2)[:, ::2], w.repeat(1, 2)[:, ::2])


def _forest_rows(n, seed):
    """Random bins [n, 55] with all-NaN rows (bin 0) and rows of bin 255;
    the committed models hold nodes with thr = 256, which every bin passes
    to the left."""
    g = torch.Generator().manual_seed(seed)
    b = torch.randint(0, 256, (n, 55), generator=g, dtype=torch.int32).to(torch.uint8)
    b[: max(n // 8, 1)] = 0
    b[n // 8: n // 4] = 255
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("etype", ["clicks", "carts", "orders"])
@pytest.mark.parametrize("n", [1, 115, 1_472_000])
def test_cuda_forest_kernel_bit_equal_to_twin(cuda_device, etype, n):
    """The committed fold models (three folds, depth 7) at one row, a
    ragged block and the replay's 1,472,000 rows a type: the kernel's
    fold-averaged scores bit-equal to the twin's fold loop."""
    from pathlib import Path

    import numpy as np

    from otto_tpu_torch.models.gbdt import load_ranker_model
    from otto_tpu_torch.ops import forest as tfo

    model = load_ranker_model(Path(__file__).resolve().parent.parent / "artifacts" /
                              "bench_e2e" / f"ranker_{etype}.npz")
    assert max(int(f.thr.max()) for f in model.forests) == 256
    pack = model.packed(cuda_device)
    x = _forest_rows(n, n).to(cuda_device)
    before = tfo.predict_forest.launches
    k = tfo.predict_forest(x, pack)
    torch.cuda.synchronize()
    assert tfo.predict_forest.launches == before + 1
    acc = None
    for feat, thr, leaf, base in pack.folds():
        r = tfo._predict_forest_reference(x, feat, thr, leaf, base, pack.depth)
        acc = r if acc is None else acc + r
    want = acc * torch.tensor(np.float32(1 / 3), device=cuda_device)
    assert torch.equal(k.view(torch.int32), want.view(torch.int32))
    if n == 115:
        cpu = tfo.predict_forest(x.cpu(), model.packed("cpu"))
        assert torch.equal(k.cpu().view(torch.int32), cpu.view(torch.int32))
        with pytest.raises(ValueError):  # rows and model on different devices
            tfo.predict_forest(x, model.packed("cpu"))
        with pytest.raises(ValueError):  # rows wider than the kernel stages
            tfo.predict_forest(torch.zeros((4, 385), dtype=torch.uint8, device=cuda_device),
                               pack)
        with pytest.raises(ValueError):  # a strided view
            tfo.predict_forest(x.repeat(1, 2)[:, ::2], pack)
