"""Each hand-written CUDA kernel against its plain-torch twin, on the card.

Marked ``cuda``: without a card these tests skip (the kernels have no CPU
mode).  The module imports no JAX, so it also runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Shapes are the full-width ones of the serving path (1,855,603 items: stage 1
over 1,867,776 padded columns, the peel over [B, 14,592]).  Tolerances: the
peel and stage 1 on integer-valued inputs are bit-equal; stage 1 on normal
data may move a packed maximum by one truncation step and change its 7-bit
position code, so values agree within 2^8 ulps = 2^-15 relative and the
window position on >= 99.9% of windows.
"""

import pytest
import torch

from otto_tpu_torch.ops import fused_retrieval as tfr
from otto_tpu_torch.ops import row_topk as trt

N_PAD = 114 * 16384


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_peel_kernel_bit_equal_to_twin(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((2048, N_PAD // 128), generator=g, device=cuda_device)
    x[:, 5] = x[:, 7] = x[:, 100] = 9.0  # ties inside a window
    x[:, 128:256] = 3.0
    before = trt.peel_rows.launches
    kv, kc = trt.peel_rows(x, 6)
    torch.cuda.synchronize()
    assert trt.peel_rows.launches == before + 1
    rv, rc = trt.peel_rows_reference(x, 6)
    assert torch.equal(kv.view(torch.int32), rv.view(torch.int32))
    assert torch.equal(kc, rc)
    with pytest.raises(TypeError):
        trt.peel_rows(x.to(torch.float64), 6)


@pytest.mark.cuda
@pytest.mark.parametrize("da", [34, 102])
def test_cuda_stage1_kernel_matches_twin(cuda_device, da):
    g = torch.Generator(device=cuda_device).manual_seed(da)
    q = torch.randint(-8, 9, (256, da), generator=g, device=cuda_device).to(torch.bfloat16)
    t = torch.randint(-8, 9, (da, N_PAD), generator=g, device=cuda_device).to(torch.bfloat16)
    t[:, 1_855_603:] = 0  # pad columns
    before = tfr.fused_stage1.launches
    k = tfr.fused_stage1(q, t)
    torch.cuda.synchronize()
    assert tfr.fused_stage1.launches == before + 1
    r = tfr._stage1_reference(q, t)
    assert torch.equal(k.view(torch.int32), r.view(torch.int32))

    qn = torch.randn((256, da), generator=g, device=cuda_device)
    qn[:, -1] = 128.0
    tn = torch.randn((da, N_PAD), generator=g, device=cuda_device)
    tn[-1] = 1.0
    k = tfr.fused_stage1(qn.to(torch.bfloat16), tn.to(torch.bfloat16))
    r = tfr._stage1_reference(qn.to(torch.bfloat16), tn.to(torch.bfloat16))
    torch.testing.assert_close(k, r, rtol=2.0**-15, atol=0)
    same = (k.view(torch.int32) & 127) == (r.view(torch.int32) & 127)
    assert same.float().mean().item() >= 0.999


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
