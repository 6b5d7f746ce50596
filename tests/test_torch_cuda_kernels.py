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
115 and 1,472,000 rows (the two-stage replay's rows a type), on uint8 bins
and on float32 rows it bins itself (NaN, +-inf, +-0.0, denormals, edge
values and one ulp either side, float32 max among them), and synthetic
models whose folds end inside its 32-tree slices at depths 1-12 (the
shared-memory route to depth 7, the device-memory route beyond): bit-equal
to its twins (the same bins; the same float32 additions in the same order).
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
        with pytest.raises(ValueError):  # rows wider than the kernel's 128 features
            tfo.predict_forest(torch.zeros((4, 129), dtype=torch.uint8, device=cuda_device),
                               pack)
        with pytest.raises(ValueError):  # a strided view
            tfo.predict_forest(x.repeat(1, 2)[:, ::2], pack)


def _float_rows(edges, n, seed):
    """Float32 rows [n, F]: lognormal, with a third of the cells an edge
    value, the float above or below one, or a special value."""
    import numpy as np

    rng = np.random.default_rng(seed)
    F, E = edges.shape
    e = edges[np.arange(F)[None, :], rng.integers(0, E, (n, F))]
    fmax = np.finfo(np.float32).max
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 5e-40, -5e-40,
                        1.1754942e-38, fmax, -fmax], np.float32)
    x = rng.lognormal(size=(n, F)).astype(np.float32)
    kind = rng.integers(0, 9, (n, F))
    x = np.where(kind == 0, e, x)
    with np.errstate(over="ignore"):
        x = np.where(kind == 1, np.nextafter(e, np.float32(np.inf)), x)
        x = np.where(kind == 2, np.nextafter(e, np.float32(-np.inf)), x)
    return torch.from_numpy(np.where(kind == 3, special[rng.integers(0, 12, (n, F))], x))


def _forest_twin(x, pack):
    import numpy as np

    from otto_tpu_torch.ops import forest as tfo

    acc = None
    for feat, thr, leaf, base in pack.folds():
        r = tfo._predict_forest_reference(x, feat, thr, leaf, base, pack.depth)
        acc = r if acc is None else acc + r
    return acc * torch.tensor(np.float32(1 / pack.n_folds), device=x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("etype", ["clicks", "carts", "orders"])
@pytest.mark.parametrize("n", [1, 115, 1_472_000])
def test_cuda_forest_rows_kernel_bit_equal_to_twin(cuda_device, etype, n):
    """Float32 rows binned in the kernel's staging against the committed
    model's edges, then routed: bit-equal to the twin's binning and routing,
    and to the CPU route on the same rows."""
    from pathlib import Path

    from otto_tpu_torch.models.gbdt import load_ranker_model
    from otto_tpu_torch.ops import forest as tfo

    model = load_ranker_model(Path(__file__).resolve().parent.parent / "artifacts" /
                              "bench_e2e" / f"ranker_{etype}.npz")
    pack, edges = model.packed(cuda_device), model.packed_edges(cuda_device)
    x = _float_rows(model.edges, n, n).to(cuda_device)
    before = tfo.predict_forest_rows.launches
    k = tfo.predict_forest_rows(x, edges, pack)
    torch.cuda.synchronize()
    assert tfo.predict_forest_rows.launches == before + 1
    want = _forest_twin(tfo._bin_rows_reference(x, edges), pack)
    assert torch.equal(k.view(torch.int32), want.view(torch.int32))
    if n == 115:
        cpu = model.predict_rows(x.cpu())
        assert torch.equal(k.cpu().view(torch.int32), cpu.view(torch.int32))
        with pytest.raises(TypeError):  # float64 rows
            tfo.predict_forest_rows(x.double(), edges, pack)
        with pytest.raises(ValueError):  # edges on the CPU
            tfo.predict_forest_rows(x, model.packed_edges("cpu"), pack)
        with pytest.raises(ValueError):  # a strided view
            tfo.predict_forest_rows(x.repeat(1, 2)[:, ::2], edges, pack)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 3, 7, 8, 12])
def test_cuda_forest_kernel_slices_and_depths(cuda_device, depth):
    """Folds of 5, 40, 0 and 29 trees (ends inside 32-tree slices, an empty
    fold, a ragged last slice) over 20 features, and 100 features (128-byte
    row slots), on bins and on float rows: bit-equal to the twins."""
    import numpy as np

    from otto_tpu_torch.ops import forest as tfo

    rng = np.random.default_rng(depth)
    for n_feat in (20, 100):
        folds = []
        for n_trees in (5, 40, 0, 29):
            ni = (1 << depth) - 1
            folds.append((rng.integers(0, n_feat, (n_trees, ni)).astype(np.int32),
                          rng.integers(0, 257, (n_trees, ni)).astype(np.int32),
                          rng.normal(size=(n_trees, ni + 1)).astype(np.float32),
                          float(rng.normal())))
        pack = tfo.pack_forests(folds, device=cuda_device)
        edges_np = np.sort(rng.normal(size=(n_feat, 254)).astype(np.float32), axis=1)
        edges = tfo.pack_edges(edges_np, device=cuda_device)
        x = _float_rows(edges_np, 1300, depth).to(cuda_device)
        binned = tfo._bin_rows_reference(x, edges)
        want = _forest_twin(binned, pack)
        for got in (tfo.predict_forest(binned, pack), tfo.predict_forest_rows(x, edges, pack)):
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_cli_two_stage_launches_forest_kernel_once_a_type(cuda_device, tmp_path):
    """``main two_stage validation`` from a copy of the committed artifacts
    (200 sessions over the bench's 20,000 aids): one float-row forest launch
    a type, and lists equal to the CPU path's given the card's heuristic
    lists (the heuristic's recency route differs by device, ROADMAP §3)."""
    import shutil
    from pathlib import Path

    import numpy as np

    from otto_tpu_torch import EVENT_TYPES, pipelines, twostage
    from otto_tpu_torch.data.splits import split_by_fraction
    from otto_tpu_torch.data.synthetic import synthetic_events_v2
    from otto_tpu_torch.ops import forest as tfo

    bench = Path(__file__).resolve().parent.parent / "artifacts" / "bench_e2e"
    store = synthetic_events_v2(n_sessions=200, n_aids=20_000, seed=2)
    store.to_parquet(tmp_path / "events.parquet")
    for name in ("cuda", "cpu"):
        shutil.copytree(bench, tmp_path / name)
    heur = []
    real = twostage._heuristic_lists

    def keep(*args):
        heur.append(real(*args))
        return heur[-1]

    tfo.predict_forest_rows.launches = 0
    twostage._heuristic_lists = keep
    try:
        got = pipelines.main(["two_stage", "validation", "--ranker", "gbdt", "--n-aids", "20000",
                              "--val-fraction", "0.5", "--seed", "0", "--device", "cuda",
                              "--events", str(tmp_path / "events.parquet"),
                              "--artifact-dir", str(tmp_path / "cuda")])
    finally:
        twostage._heuristic_lists = real
    assert tfo.predict_forest_rows.launches == 3
    sp = split_by_fraction(store, val_fraction=0.5, seed=0)
    want = twostage.run_two_stage(sp.train, sp.val_input, 20_000, labels=sp.val_labels,
                                  artifact_dir=tmp_path / "cpu", heuristic_preds=heur[0],
                                  device="cpu")
    for t in EVENT_TYPES:
        np.testing.assert_array_equal(got.predictions[t], want.predictions[t], err_msg=t)


@pytest.mark.cuda
@pytest.mark.parametrize("n, f, n_bins, n_keys", [
    (1, 1, 2, 1), (115, 55, 16, 32), (115, 128, 2, 64), (1_000_000, 55, 256, 32),
    (1_000_000, 128, 256, 64), (1_000_000, 1, 16, 1)])
def test_cuda_histogram_kernel_matches_twin(cuda_device, n, f, n_bins, n_keys):
    """K5 against its twin: bit-equal on dyadic vals (k/256, |k| < 256; the
    sums are exact), within 2^-20 of each column's sum of |vals| on normal
    vals, and there bit-equal to the plain fixed-point reference (the
    kernel's scale rule); two launches on the same inputs bit-identical; -1
    keys and a crowded bin included."""
    from otto_tpu_torch.ops import hist as ths

    g = torch.Generator(device=cuda_device).manual_seed(n + f + n_keys)
    binned = torch.randint(0, n_bins, (n, f), generator=g, device=cuda_device,
                           dtype=torch.int32).to(torch.uint8)
    binned[: n // 2, 0] = 0  # half the rows in one bin
    key = torch.randint(-1 if n_keys > 1 else 0, n_keys, (n,), generator=g,
                        device=cuda_device, dtype=torch.int32)
    dyadic = torch.randint(-255, 256, (n, 3), generator=g, device=cuda_device).float() / 256
    normal = torch.randn((n, 3), generator=g, device=cuda_device)
    before = ths.node_histograms.launches
    for vals in (dyadic, normal):
        got = ths.build_histogram(binned, key, vals, n_keys, n_bins)
        again = ths.build_histogram(binned, key, vals, n_keys, n_bins)
        want = ths._build_histogram_reference(binned, key, vals, n_keys, n_bins)
        torch.cuda.synchronize()
        assert got.shape == (n_keys, f, n_bins, 3)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        if vals is dyadic:
            assert torch.equal(got, want)
        else:
            tol = 2.0 ** -20 * vals.abs().sum(dim=0)
            assert bool(((got - want).abs() <= tol).all())
        fixed = ths._fixed_point_histogram(binned, key, vals, n_keys, n_bins)
        assert torch.equal(got.view(torch.int32), fixed.view(torch.int32))
    assert ths.node_histograms.launches == before + 4
    with pytest.raises(ValueError):  # inputs on different devices
        ths.build_histogram(binned, key.cpu(), normal, n_keys, n_bins)
    with pytest.raises(ValueError):  # more keys than the kernel takes
        ths.build_histogram(binned, key, normal, ths.MAX_KEYS + 1, n_bins)


@pytest.mark.cuda
def test_cuda_gbdt_fit_deterministic_and_equal_to_cpu_on_dyadic_tree(cuda_device):
    """One tree on dyadic grad/hess (k/1024, |k| <= 7: every histogram cell
    and cumulative sum is exact in float32, so the card's cumsum, summing in
    another order than the CPU's, gives the same bits): the card's
    ``_grow_tree`` equals the CPU twin's in every output; two 6-tree fits on
    the card give the same forest, bit for bit."""
    import numpy as np

    from otto_tpu_torch.config import GBDTConfig
    from otto_tpu_torch.models import gbdt as tg

    rng = np.random.default_rng(5)
    n, f = 200_000, 55
    binned = rng.integers(0, 256, (n, f)).astype(np.uint8)
    grad = (rng.integers(-7, 8, n) / 1024).astype(np.float32)
    hess = (rng.integers(1, 8, n) / 1024).astype(np.float32)
    weight = (rng.random(n) < 0.8).astype(np.float32)
    args = [binned, grad, hess, weight, np.ones(n, np.float32), rng.random(f) < 0.9]
    kw = dict(depth=7, n_bins=256)
    scalars = (0.01, 1e-5, 200.0, 1e-3, 0.05)
    card = tg._grow_tree(*(torch.as_tensor(a, device=cuda_device) for a in args), *scalars, **kw)
    cpu = tg._grow_tree(*(torch.as_tensor(a) for a in args), *scalars, **kw)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    S, C = 2000, 100
    x = rng.integers(0, 256, (S, C, f)).astype(np.uint8)
    labels = (rng.random((S, C)) < 0.05).astype(np.int8)
    mask = np.ones((S, C), bool)
    cfg = GBDTConfig(n_trees=6, loss="bce", min_data_in_leaf=200)
    fits = [tg.fit_gbdt(x, labels, mask, mask.astype(np.float32), cfg, device=cuda_device)
            for _ in range(2)]
    for name in ("feat", "thr", "leaf", "gain_importance"):
        assert np.array_equal(getattr(fits[0], name), getattr(fits[1], name)), name


@pytest.mark.cuda
def test_cuda_histogram_kernel_over_one_trees_row_lists(cuda_device):
    """The launches of one depth-7 tree (row lists split by the tree's own
    routing, zero-val rows left off), on session-like rows (runs of equal
    bins, a crowded missing bin) at 55 features: each launch bit-equal to the
    plain fixed-point reference on the tree's real vals, and to the twin on
    dyadic vals; a repeated launch bit-identical."""
    import numpy as np

    from otto_tpu_torch.models import gbdt as tg
    from otto_tpu_torch.ops import hist as ths

    rng = np.random.default_rng(9)
    n, f = 300_000, 55
    binned = rng.integers(0, 256, (n, f)).astype(np.uint8)
    binned[:, :10] = np.repeat(rng.integers(0, 256, (n // 100 + 1, 10)), 100, axis=0)[:n]
    binned[rng.random((n, f)) < 0.3] = 0
    x = torch.as_tensor(binned, device=cuda_device)
    grad = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=cuda_device)
    hess = torch.as_tensor(rng.random(n).astype(np.float32), device=cuda_device)
    weight = torch.as_tensor((rng.random(n) < 0.3).astype(np.float32), device=cuda_device)
    bag = torch.as_tensor((rng.random(n) < 0.9).astype(np.float32), device=cuda_device)
    calls = []
    real = tg.node_histograms

    def keep(*args):
        calls.append(args)
        return real(*args)

    tg.node_histograms = keep
    try:
        tg._grow_tree(x, grad, hess, weight, bag, torch.ones(f, dtype=torch.bool,
                                                             device=cuda_device),
                      0.01, 1e-5, 200.0, 1e-3, 0.05, depth=7, n_bins=256)
    finally:
        tg.node_histograms = real
    assert len(calls) == 7
    dyadic = torch.as_tensor((rng.integers(-255, 256, (n, 3)) / 256).astype(np.float32),
                             device=cuda_device)
    for rows, n_feat, vals, vmax, order, start, pre, n_bins in calls:
        key = ths.list_keys(order, start, pre, n)
        got = ths.node_histograms(rows, n_feat, vals, vmax, order, start, pre, n_bins)
        again = ths.node_histograms(rows, n_feat, vals, vmax, order, start, pre, n_bins)
        fixed = ths._fixed_point_histogram(x, key, vals, start.shape[0], n_bins)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        assert torch.equal(got.view(torch.int32), fixed.view(torch.int32))
        dy = ths.node_histograms(rows, n_feat, dyadic, dyadic.abs().amax(dim=0), order, start,
                                 pre, n_bins)
        assert torch.equal(dy, ths._build_histogram_reference(x, key, dyadic, start.shape[0],
                                                              n_bins))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 2, 3, 5, 31, 55, 64, 100, 128])
def test_cuda_bin_rows_bit_equal_to_twin_and_numpy(cuda_device, f):
    """The binning kernel on float32 rows with NaN, +-inf, +-0.0, denormals,
    the edges' own values and one ulp either side, at N F not a multiple of
    4 and on a misaligned view: bit-equal to its twin and to numpy
    ``bin_features``."""
    import numpy as np

    from otto_tpu_torch.models import gbdt as tg
    from otto_tpu_torch.ops import forest as tfo

    rng = np.random.default_rng(f)
    edges = np.sort(rng.normal(size=(f, 254)).astype(np.float32), axis=1)
    edges[:, 200:] = np.finfo(np.float32).max  # pads, as fit_bin_edges writes them
    edges[:, 10:14] = edges[:, 10:11]  # equal edges
    packed = tfo.pack_edges(edges, device=cuda_device)
    n = 20_001
    x = rng.normal(size=(n, f)).astype(np.float32)
    pick = rng.integers(0, 200, (n, f))
    on_edge = edges[np.arange(f)[None, :], pick]
    x = np.where(rng.random((n, f)) < 0.3, on_edge, x)
    x = np.where(rng.random((n, f)) < 0.1, np.nextafter(on_edge, np.float32(np.inf)), x)
    x = np.where(rng.random((n, f)) < 0.1, np.nextafter(on_edge, np.float32(-np.inf)), x)
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40,
                         np.finfo(np.float32).max], np.float32)
    x[: len(specials) * 3] = np.repeat(specials, 3)[:, None]
    x = x.astype(np.float32)
    xd = torch.as_tensor(x, device=cuda_device)
    before = tfo.bin_rows.launches
    got = tfo.bin_rows(xd, packed)
    torch.cuda.synchronize()
    assert tfo.bin_rows.launches == before + 1
    assert torch.equal(got, tfo._bin_rows_reference(xd, packed))
    np.testing.assert_array_equal(got.cpu().numpy(), tg.bin_features(x, edges))
    shifted = torch.empty(n * f + 1, device=cuda_device)[1:].view(n, f)  # 4 bytes off
    shifted.copy_(xd)
    assert torch.equal(tfo.bin_rows(shifted, packed), got)
    with pytest.raises(TypeError):
        tfo.bin_rows(xd.double(), packed)
    with pytest.raises(ValueError):
        tfo.bin_rows(xd, packed.cpu())


@pytest.mark.cuda
def test_cuda_train_gbdt_ranker_bins_on_the_card(cuda_device):
    """``train_gbdt_ranker`` on the card: the device edges value-equal to
    numpy ``fit_bin_edges`` (and the model keeps them), the binning kernel and
    K5 launched, numpy ``bin_features`` and the histogram twin never called;
    two runs give the same forests, bit for bit."""
    import numpy as np

    from otto_tpu_torch.config import GBDTConfig
    from otto_tpu_torch.models import gbdt as tg
    from otto_tpu_torch.models.ranker import RankerData
    from otto_tpu_torch.ops import forest as tfo
    from otto_tpu_torch.ops import hist as ths

    rng = np.random.default_rng(13)
    S, C, F = 400, 60, 20
    X = rng.normal(size=(S, C, F)).astype(np.float32)
    X[..., 3] = rng.integers(0, 4, (S, C))
    X[rng.random(X.shape) < 0.1] = np.nan
    labels = (X[..., 0] + rng.normal(size=(S, C)) > 1.5).astype(np.int8)
    mask = rng.random((S, C)) < 0.9
    data = RankerData(X, labels, mask, np.arange(S), np.zeros((S, C), np.int32))
    cfg = GBDTConfig(n_trees=8, n_folds=2, loss="bce", min_data_in_leaf=50)
    refused = []
    real = (tg.bin_features, ths._build_histogram_reference)
    tg.bin_features = lambda *a: refused.append("bin_features")
    ths._build_histogram_reference = lambda *a: refused.append("twin")
    before = (tfo.bin_rows.launches, ths.node_histograms.launches)
    try:
        runs = [tg.train_gbdt_ranker(data, cfg, device=cuda_device) for _ in range(2)]
    finally:
        tg.bin_features, ths._build_histogram_reference = real
    assert not refused
    assert tfo.bin_rows.launches == before[0] + 2 and ths.node_histograms.launches > before[1]
    np.testing.assert_array_equal(runs[0][0].edges, tg.fit_bin_edges(X[mask], cfg.n_bins))
    for a, b in zip(runs[0][0].forests, runs[1][0].forests):
        for name in ("feat", "thr", "leaf"):
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert np.array_equal(runs[0][1], runs[1][1])
