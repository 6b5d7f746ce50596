"""The int8 stage-1 kernel against its twin, and the retrieval backends'
routes, on the card.

Marked ``cuda``: without a card these tests skip (the kernel has no CPU
mode).  The module imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_retrieval_backends.py

``fused_stage1_int8_kernel`` computes exact integer dots on the int8 tensor
cores and a float32 epilogue written step by step (``__f*_rn``), so it is
bit-equal to ``_stage1_int8_reference`` on any operands: at every depth it
takes (D_pad 32-256, 1-8 k steps), at B 1-4,096 (33, 65, 100, 130, 200,
333: a last query tile part-empty), over tables whose item count is not a
multiple of 16,384 nor of 128 (the pad chunk's masked branch) and one
that fills its chunks, for both metrics, with negative scores and a zero
query row.  The int8 retriever's whole top-k on
the card equals the same path on the CPU to the bit (integer rescoring,
elementwise float32, stable sorts).
"""

import pytest
import torch

from otto_tpu_torch.ops import fused_retrieval as tfr
from otto_tpu_torch.ops import retrieval as tret
from otto_tpu_torch.ops import row_topk as trt

CHUNK = tfr.CHUNK


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _operands(dim, b, n_items, dev, seed):
    """q8 [b, D_pad], q_scale, table8 [N_pad, D_pad], item_scale, item_bias
    (pads zero), a zero query row, and a shift that puts every live key at
    >= 1 for both metrics."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d_pad = -(-dim // 32) * 32
    n_pad = -(-n_items // CHUNK) * CHUNK
    q8 = torch.zeros((b, d_pad), dtype=torch.int8, device=dev)
    q8[:, :dim] = torch.randint(-127, 128, (b, dim), generator=g, device=dev)
    q8[b // 2] = 0
    t8 = torch.zeros((n_pad, d_pad), dtype=torch.int8, device=dev)
    t8[:n_items, :dim] = torch.randint(-127, 128, (n_items, dim), generator=g, device=dev)
    q_scale = torch.rand(b, generator=g, device=dev) * 0.02 + 1e-3
    item_scale = torch.zeros(n_pad, device=dev)
    item_scale[:n_items] = torch.rand(n_items, generator=g, device=dev) * 0.02 + 1e-3
    item_bias = torch.zeros(n_pad, device=dev)
    item_bias[:n_items] = torch.rand(n_items, generator=g, device=dev) * 60.0
    bound = 2 * 127 * 127 * dim * 0.021 * 0.021 + 60.0 + 2.0
    shift = 2.0 ** int(torch.tensor(bound).log2().ceil())
    return (q8, q_scale, t8, item_scale, item_bias), shift


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["dot", "euclidean"])
@pytest.mark.parametrize("dim,b,n_items", [
    (8, 100, 3 * CHUNK - 77), (16, 1, 2 * CHUNK + 5), (32, 4096, 6 * CHUNK - 12_173),
    (48, 100, 3 * CHUNK - 77), (64, 333, 2 * CHUNK), (80, 65, 2 * CHUNK - 200),
    (128, 130, CHUNK + 1), (160, 64, 2 * CHUNK - 129), (192, 33, 3 * CHUNK - 1_000),
    (224, 200, CHUNK + 127), (256, 100, 2 * CHUNK - 1)])
def test_cuda_int8_kernel_bit_equal_to_twin(cuda_device, dim, b, n_items, metric):
    ops, shift = _operands(dim, b, n_items, cuda_device, seed=dim + b)
    before = tfr.fused_stage1_int8.launches
    k = tfr.fused_stage1_int8(*ops, n_items=n_items, shift=shift, metric=metric)
    torch.cuda.synchronize()
    assert tfr.fused_stage1_int8.launches == before + 1
    r = tfr._stage1_int8_reference(*ops, n_items=n_items, shift=shift, metric=metric)
    assert torch.equal(k.view(torch.int32), r.view(torch.int32))
    live = r.view(torch.int32) >= tfr.LIVE_BITS
    assert live[:, :128].all()
    if n_items % CHUNK and n_items % CHUNK < 128:  # windows of pads alone
        assert not live[:, -128 + n_items % CHUNK:].any()


@pytest.mark.cuda
def test_cuda_int8_kernel_raises_on_bad_operands(cuda_device):
    ops, shift = _operands(32, 64, CHUNK, cuda_device, seed=0)
    kw = {"n_items": CHUNK, "shift": shift, "metric": "dot"}
    q8, q_scale, t8, item_scale, item_bias = ops
    raw = torch.zeros(CHUNK * 32 + 16, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):  # a table off its boundary
        tfr.fused_stage1_int8(q8, q_scale, raw[1:1 + CHUNK * 32].view(CHUNK, 32), item_scale,
                              item_bias, **kw)
    with pytest.raises(TypeError):
        tfr.fused_stage1_int8(q8.float(), q_scale, t8, item_scale, item_bias, **kw)
    with pytest.raises(ValueError):  # D_pad not a multiple of 32
        tfr.fused_stage1_int8(q8[:, :24].contiguous(), q_scale, t8[:, :24].contiguous(),
                              item_scale, item_bias, **kw)
    with pytest.raises(ValueError):  # operands on two devices
        tfr.fused_stage1_int8(q8, q_scale.cpu(), t8, item_scale, item_bias, **kw)


@pytest.mark.cuda
def test_cuda_int8_kernel_has_no_cpu_fallback(cuda_device, monkeypatch):
    """A CUDA tensor launches the kernel; the twin is never called."""
    def refuse(*a, **kw):
        raise AssertionError("the twin ran on CUDA tensors")

    monkeypatch.setattr(tfr, "_stage1_int8_reference", refuse)
    ops, shift = _operands(32, 64, CHUNK, cuda_device, seed=1)
    before = tfr.fused_stage1_int8.launches
    out = tfr.fused_stage1_int8(*ops, n_items=CHUNK, shift=shift, metric="euclidean")
    torch.cuda.synchronize()
    assert out.is_cuda and tfr.fused_stage1_int8.launches == before + 1


def _launches():
    f = tfr.fused_stage1
    return {"wgmma": f.launches, "wgmma_deep": f.deep_launches, "fma": f.fma_launches,
            "int8": tfr.fused_stage1_int8.launches, "peel": trt.peel_rows.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("backend,route", [("int8", "int8"), ("hybrid", "fma"),
                                           ("approx", "fma"), ("pallas", "wgmma"),
                                           ("compensated", "wgmma")])
def test_cuda_backend_launches_its_route(cuda_device, backend, route):
    """Each backend of ``build_neighbor_table`` moves its own stage-1
    counter and the peel's, one launch a query batch, and no other.  (The
    int8 route's card-against-CPU equality is held below.)"""
    g = torch.Generator().manual_seed(5)
    items = torch.randn((5 * CHUNK + 123, 32), generator=g)
    before = _launches()
    table = tret.build_neighbor_table(items, k=10, query_batch=40_000, backend=backend,
                                      device=cuda_device)
    torch.cuda.synchronize()
    batches = -(-items.shape[0] // 40_000)
    moved = {name: n - before[name] for name, n in _launches().items()}
    assert moved == {**{name: 0 for name in moved}, route: batches, "peel": batches}
    assert table.shape == (items.shape[0], 10)
    assert not (table == torch.arange(items.shape[0])[:, None].numpy()).any()


@pytest.mark.cuda
def test_cuda_quantization_equals_cpu(cuda_device):
    """The card's per-row quantization gives the CPU's bits (the scale's
    division by 127 is a true division on both)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((200_000, 32), generator=g) * torch.rand((200_000, 1), generator=g) * 100
    for cpu, card in zip(tret.quantize_items_int8(x), tret.quantize_items_int8(x.to(cuda_device))):
        assert card.is_cuda and torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["dot", "euclidean"])
def test_cuda_int8_retriever_equals_cpu_path(cuda_device, metric):
    g = torch.Generator().manual_seed(6)
    # large enough for the recall target's windowed route (the kernel)
    items = torch.randn((16 * CHUNK + 9, 32), generator=g)
    queries = torch.cat([items[:300] + 0.1 * torch.randn((300, 32), generator=g),
                         torch.zeros((1, 32))])  # a zero query row
    quant = tret.quantize_items_int8(items)
    cs, ci = tret.topk_hybrid_int8(queries, *quant, k=21, metric=metric)
    before = tfr.fused_stage1_int8.launches
    gs, gi = tret.topk_hybrid_int8(queries.to(cuda_device),
                                   *(t.to(cuda_device) for t in quant), k=21, metric=metric)
    assert tfr.fused_stage1_int8.launches == before + 1
    assert torch.equal(gi.cpu(), ci)
    assert torch.equal(gs.cpu().view(torch.int32), cs.view(torch.int32))
