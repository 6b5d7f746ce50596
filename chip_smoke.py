"""Drive the PyTorch port's serving paths once on one NVIDIA card: the
embedding-kNN path, the baselines with the covisitation heuristic, and the
two-stage prediction path.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure ends the run with a non-zero
exit code):

1. device and build: require CUDA, print the card's name and power limit,
   build the hand-written kernels from ``otto_tpu_torch/csrc`` and print
   each kernel's ptxas report (registers, spills);
2. each kernel against its plain-torch twin at the full-width shapes
   (1,855,603 items x 32 dims: stage 1 over 1,867,776 padded items at 256
   queries, at 115, the neighbor table's last batch, and at 4,096 x 102,
   the table's other batches, on the very inputs it is timed on; stage 1's
   FMA route for bf16 deeper than 256 at DA 300; the peel on those batches'
   packed maxima and on tie-heavy and -inf rows, R = 1, 6, 21, 40), with
   the times of both at a 4,096-query batch (the peel's by CUDA graphs:
   device time alone), each kernel's share of its bound, ``torch.matmul``
   on the bare bf16 product as stage 1's yardstick and a windowed
   ``torch.topk`` as the peel's context (it differs on ties);
3. full-width retrieval: a seeded 1,855,603 x 32 SGNS table round-tripped
   through ``SGNSModel.save``/``load``, ``FusedRetriever`` queries/s and its
   recall against the exact scan;
3b. ``FusedRetriever`` on a seeded 1,000,000 x 96 table (compensated: a
   contraction of 294, past the wgmma kernel's 256, so stage 1 runs its FMA
   route), recall against the exact scan, with the counters zeroed before
   and read after; then that route against its twin on the retriever's own
   operands, and the times of both;
4. the serving path in the order of ``otto_tpu.pipelines.run_embedding_knn``:
   ``neighbor_table(k=21)`` over every aid, ``embedding_knn_predictions`` on
   20,000 synthetic sessions, ``evaluate_predictions``; the kernels' launch
   counters are zeroed just before and read just after (its recency route
   launches the session vote);
5. the session vote against its twin at [4096, 256] and [1024, 300] (the
   block kernel for rows longer than 128; duplicates common, -1 tails):
   ``first``/``firstpos`` bit-equal, ``agg`` bit-equal on integer weights
   and within 2^-16 * sum_j |w_j| of its row on normal weights,
   ``per_aid_weight_top_fused`` against ``per_aid_weight_top`` and the CPU
   twin path; the kernel's times warm and cold (CUDA graphs; cold over
   rotating input copies of more than 50 MB) and the twin's;
6. ``build_covisitation`` on the card over the bench's data
   (``artifacts/bench_e2e/bench_fit.json``: ``synthetic_events_v2`` then
   ``split_by_time``) against the committed tables of
   ``artifacts/bench_e2e/covisitation``, which the JAX package wrote: six
   kinds bit-equal, ``time_weighted`` modulo near-ties;
7. ``pipelines.run_aid_frequency``, ``run_aid_weight`` and
   ``run_covisit_heuristic`` on 200,000 synthetic sessions over the
   1,855,603-aid catalog, ``CovisitConfig()`` defaults, with the counters
   zeroed before and read after; then the heuristic re-served on the host
   routes: the covisitation route must equal the device route;
8. the session vote at the shape phase 7's aid-weight runner gave it (the
   whole packed target, [20,000, L] with L the longest session; the warp
   kernel for rows up to 128): on the runner's own inputs against the
   twin, the runner's lists against the twin's ranking (equal up to
   near-ties), the checks of phase 5 on synthetic rows at [1,024, L], and
   the times of both at that shape, warm and cold;
9. the two-stage artifact replay, in the order of
   ``bench.py::e2e_artifact_bench``: phase 6's data, the committed
   covisitation tables and fold models of ``artifacts/bench_e2e``, aid
   features over train + target against the committed ``aid_feats.npz``,
   the first 8,000 training-disjoint sessions, the heuristic on the host
   routes, ``predict_two_stage`` on the card (counters zeroed before, read
   after; each stage's seconds), recall, lift and the paired bootstrap held
   to the CPU replay's numbers in ``BENCH_r05.json``; then the card's lists
   against the CPU twin path on 512 sessions (bit-equal), the forest kernel
   against its twin on the path's own rows of each type (bit-equal; CUDA
   events and a CUDA graph), and the path once more with an SGNS model in
   the artifacts, so the kNN candidate route launches stage 1 and the
   peel: on the full catalog (phase 3's model, phase 7's tables and
   sessions), since a 20,000-aid table takes the dense route.

The line before the last is a JSON object describing each kernel (its
launches on the path it serves and on each path, largest error against the
twin, ms, the twin's ms, the bound and what sets it, and ``library_ms``,
null where no one PyTorch call computes the function); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.  The phase functions take the device and the sizes, so a
rehearsal can import them and run them on the CPU at a small size (the
wrappers then run the plain twins).
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20260101
N_AIDS = 1_855_603        # real OTTO items (SURVEY §0)
DIM = 32                  # configs/fasttext.yaml, SGNSConfig.dim
K_NNS = 21                # run_embedding_knn's validation n_nns
QUERY_BATCH = 4096        # build_neighbor_table's query batch

REPO = Path(__file__).resolve().parent
K1_SOURCE = "otto_tpu_torch/csrc/retrieval_kernels.cu"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events around a
    loop of calls (the host's launch cost shows where a call is short)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fns, reps: int = 5) -> float:
    """Mean device milliseconds of one call of ``fns`` (a list of calls,
    each on its own inputs), captured once in a CUDA graph and replayed
    ``reps`` times: the kernel's time without the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(max(1, 20 // len(fns))):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * max(1, 20 // len(fns)) * len(fns))


def warm_cold_ms(torch, call, inputs, min_bytes: float = 64e6) -> tuple[float, float]:
    """Device ms of ``call(*inputs)`` on the same inputs every time (warm:
    they stay in the 50 MB L2), and over rotating copies of the inputs
    that together exceed ``min_bytes`` (cold)."""
    per = sum(t.numel() * t.element_size() for t in inputs)
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(int(min_bytes // per))]
    warm = graph_ms(torch, [lambda: call(*inputs)])
    cold = graph_ms(torch, [lambda c=c: call(*c) for c in copies])
    return warm, cold


# Published H100 SXM peaks at 700 W (NVIDIA's data sheet, dense): device
# memory, bf16 tensor cores, float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
# int32 operations outside the tensor cores: 132 SMs x 64 int32 lanes x
# 1.98 GHz (Hopper white paper)
INT32_OPS_PER_S = 16.7e12


def bound(n_bytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time the card could take for a kernel's work, in ms, and
    what sets it: each input read once and each output written once over
    the memory rate, or the operations over their peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stage1_bound(q, t) -> tuple[float, str]:
    """Stage 1's bound: q [B, DA] and t [DA, N_pad] read once, [B, N_pad/128]
    float32 written once, 2 B DA N_pad operations at the bf16 tensor rate."""
    n_pad = t.shape[1]
    return bound(q.numel() * q.element_size() + t.numel() * t.element_size()
                 + q.shape[0] * (n_pad // 128) * 4, 2.0 * q.numel() * n_pad,
                 BF16_TENSOR_OPS_PER_S)


def matmul_yardstick_ms(torch, q, t, reps: int) -> tuple[float, int]:
    """CUDA-event ms of ``torch.matmul`` computing the bf16 product q @ t
    alone (no pack, no window max), in equal column slices of whole chunks
    into one reused output; returns (ms summed over the slices, slices).
    Timed as a yardstick only: the port never calls it."""
    from otto_tpu_torch.ops.fused_retrieval import CHUNK

    n_pad = t.shape[1]
    n_chunks = n_pad // CHUNK
    per = max(d for d in range(1, 17) if n_chunks % d == 0) * CHUNK
    buf = torch.empty((q.shape[0], per), dtype=torch.bfloat16, device=q.device)

    def run():
        for c0 in range(0, n_pad, per):
            torch.matmul(q, t[:, c0:c0 + per], out=buf)

    return cuda_ms(torch, run, reps), n_pad // per


def compare_kernels(torch, dev, n_items: int, b_cmp: int, peel_rows_cmp: int,
                    b_time: int, b_last: int) -> list[dict]:
    """Phase 2: each kernel against its twin at the shapes a table of
    ``n_items`` gives them; returns the kernels' records.

    Stage 1 runs at ``b_cmp`` queries and at ``b_last``, the neighbor
    table's last batch.  On integer-valued inputs it is exact, so bit-equal.
    On normal data the tensor cores and cuBLAS sum in other orders: a packed
    maximum may move by one truncation step (2^7 ulps) and change its 7-bit
    position code, so the bound is 2^8 ulps = 2^-15 relative.  Its FMA
    route (bf16 deeper than 256) is held to the same limits at DA 300.  The
    peel is pure selection, bit-equal on the path's own packed maxima and on
    tie-heavy and -inf rows of ``peel_rows_cmp`` rows.
    """
    from otto_tpu_torch.ops import fused_retrieval as fr
    from otto_tpu_torch.ops import row_topk as rt

    n_pad = -(-n_items // fr.CHUNK) * fr.CHUNK
    g = torch.Generator(device=dev).manual_seed(SEED)
    k1_err = 0.0
    for b, da in ((b, da) for b in (b_cmp, b_last) for da in (34, 102)):
        q = torch.randint(-8, 9, (b, da), generator=g, device=dev).to(torch.bfloat16)
        t = torch.randint(-8, 9, (da, n_pad), generator=g, device=dev).to(torch.bfloat16)
        t[:, n_items:] = 0  # pad columns
        k = fr.fused_stage1(q, t)
        r = fr._stage1_reference(q, t)
        sync(torch, dev)
        check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
              f"stage 1 DA={da} B={b}: kernel and twin differ on integer-valued inputs")
        # normal data, with a positivity shift in the last dimension as the
        # retriever folds one in
        qn = torch.randn((b, da), generator=g, device=dev)
        qn[:, -1] = 128.0
        tn = torch.randn((da, n_pad), generator=g, device=dev)
        tn[-1] = 1.0
        qn, tn = qn.to(torch.bfloat16), tn.to(torch.bfloat16)
        k = fr.fused_stage1(qn, tn)
        r = fr._stage1_reference(qn, tn)
        rel = ((k - r).abs() / r.abs()).max().item()
        same = ((k.view(torch.int32) & 127) == (r.view(torch.int32) & 127)).float().mean().item()
        k1_err = max(k1_err, (k - r).abs().max().item())
        # the float32 instantiation (FMA on the CUDA cores) on the same values
        kf = fr.fused_stage1(qn.float(), tn.float())
        rel_fma = ((kf - r).abs() / r.abs()).max().item()
        del kf
        print(f"stage 1 DA={da} B={b} N_pad={n_pad}: integer inputs bit-equal; "
              f"normal inputs max rel err {rel:.3e} (limit 2^-15; the float32 FMA kernel "
              f"on the same values {rel_fma:.3e}), same window position "
              f"{same:.6f} (limit 0.999)", flush=True)
        check(rel <= 2.0**-15, f"stage 1 DA={da} B={b}: relative error {rel}")
        check(same >= 0.999, f"stage 1 DA={da} B={b}: window positions agree on {same}")

    # the whole fused top-k on a small integer-valued table: the card's path
    # (kernels) equals the CPU's (twins), indices and scores
    gc = torch.Generator().manual_seed(SEED)
    items = torch.randint(-8, 9, (5 * fr.CHUNK + 123, DIM), generator=gc).float()
    queries = torch.randint(-8, 9, (64, DIM), generator=gc).float()
    for precision in ("single", "compensated"):
        (ks, ki), (rs, ri) = (
            fr.FusedRetriever(items, metric="euclidean", precision=precision,
                              device=d).topk(queries, k=K_NNS) for d in (dev, "cpu"))
        check(torch.equal(ki.cpu(), ri) and torch.equal(ks.cpu(), rs),
              f"FusedRetriever({precision}): card and CPU paths differ")
    print(f"FusedRetriever on {items.shape[0]} integer-valued items: card path equals "
          "the CPU twins' path (single, compensated)", flush=True)

    # the main path's shape, a 4096-query batch against the compensated
    # table: integer inputs bit-equal, then the timed normal inputs (with the
    # positivity shift, pad columns zero) within the limits
    qi = torch.randint(-8, 9, (b_time, 102), generator=g, device=dev).to(torch.bfloat16)
    ti = torch.randint(-8, 9, (102, n_pad), generator=g, device=dev).to(torch.bfloat16)
    ti[:, n_items:] = 0
    k, r = fr.fused_stage1(qi, ti), fr._stage1_reference(qi, ti)
    sync(torch, dev)
    check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
          f"stage 1 DA=102 B={b_time}: kernel and twin differ on integer-valued inputs")
    del qi, ti
    qt = torch.randn((b_time, 102), generator=g, device=dev)
    qt[:, -1] = 128.0
    tt = torch.randn((102, n_pad), generator=g, device=dev)
    tt[-1] = 1.0
    tt[:, n_items:] = 0
    qt, tt = qt.to(torch.bfloat16), tt.to(torch.bfloat16)
    packed, r = fr.fused_stage1(qt, tt), fr._stage1_reference(qt, tt)
    live = r >= 1.0  # pad windows pack below 1.0 in both
    check(torch.equal(live, packed >= 1.0), f"stage 1 DA=102 B={b_time}: live windows differ")
    rel = ((packed - r).abs() / r.abs())[live].max().item()
    same = ((packed.view(torch.int32) & 127) == (r.view(torch.int32) & 127)).float().mean().item()
    k1_err = max(k1_err, (packed - r).abs().max().item())
    del r
    print(f"stage 1 DA=102 B={b_time} N_pad={n_pad} (the path's shape): integer inputs "
          f"bit-equal; normal inputs max rel err {rel:.3e} (limit 2^-15), same window "
          f"position {same:.6f} (limit 0.999)", flush=True)
    check(rel <= 2.0**-15, f"stage 1 DA=102 B={b_time}: relative error {rel}")
    check(same >= 0.999, f"stage 1 DA=102 B={b_time}: window positions agree on {same}")

    # stage 1's FMA route: bf16 deeper than the wgmma kernel's 256, at DA 300
    # over 2 chunks (a compensated table of 98 dims)
    fma_n = 2 * fr.CHUNK
    qi = torch.randint(-8, 9, (b_last, 300), generator=g, device=dev).to(torch.bfloat16)
    qi[:, -1] = 64
    ti = torch.randint(-8, 9, (300, fma_n), generator=g, device=dev).to(torch.bfloat16)
    k, r = fr.fused_stage1(qi, ti), fr._stage1_reference(qi, ti)
    sync(torch, dev)
    check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
          "stage 1 FMA route DA=300: kernel and twin differ on integer-valued inputs")
    qf = torch.randn((b_time, 300), generator=g, device=dev)
    qf[:, -1] = 128.0
    tf = torch.randn((300, fma_n), generator=g, device=dev)
    tf[-1] = 1.0
    qf, tf = qf.to(torch.bfloat16), tf.to(torch.bfloat16)
    k, r = fr.fused_stage1(qf, tf), fr._stage1_reference(qf, tf)
    rel_fma = ((k - r).abs() / r.abs()).max().item()
    check(rel_fma <= 2.0**-15, f"stage 1 FMA route DA=300: relative error {rel_fma}")
    print(f"stage 1 FMA route, bf16 DA=300 over {fma_n} columns: integer inputs bit-equal "
          f"(B={b_last}); normal inputs (B={b_time}) max rel err {rel_fma:.3e} (limit 2^-15)",
          flush=True)

    # the peel on the path's own packed maxima (this batch and the table's
    # last), and on tie-heavy (few distinct values) and -inf rows, for the
    # path's R = 6 and for R = 1, 21, 40
    m = n_pad // 128
    ties = torch.randint(0, 6, (peel_rows_cmp, m), generator=g, device=dev).float()
    ties[:, 128:256] = 3.0
    neginf = torch.randn((peel_rows_cmp, m), generator=g, device=dev)
    neginf[torch.rand((peel_rows_cmp, m), generator=g, device=dev) < 0.3] = float("-inf")
    neginf[:, 256:384] = float("-inf")
    k2_err = 0.0
    for name, x in (("K1's packed maxima", packed),
                    ("K1's packed maxima, last batch", fr.fused_stage1(qt[:b_last], tt)),
                    ("tie-heavy rows", ties), ("-inf rows", neginf)):
        for rounds in (1, 6, 21, 40):
            kv, kc = rt.peel_rows(x, rounds)
            rv, rc = rt.peel_rows_reference(x, rounds)
            check(torch.equal(kv.view(torch.int32), rv.view(torch.int32)) and torch.equal(kc, rc),
                  f"peel {name} R={rounds}: kernel and twin differ")
            k2_err = max(k2_err, torch.where(kv == rv, 0.0, (kv - rv).abs()).max().item())
        print(f"peel {name} {list(x.shape)} R=1, 6, 21, 40: kernel and twin bit-equal",
              flush=True)
    del ties, neginf

    # times at the path's shapes, on those inputs: loops of calls for the
    # long kernels, CUDA graphs (device time alone) for the peel
    reps = 3
    if dev.type == "cuda":
        loop_ms = lambda fn, n: cuda_ms(torch, fn, n)  # noqa: E731
        dev_ms = lambda fn: graph_ms(torch, [fn])  # noqa: E731
    else:  # a rehearsal on the CPU
        loop_ms, dev_ms = _host_ms, lambda fn: _host_ms(fn, 1)  # noqa: E731
    k1_ms = loop_ms(lambda: fr.fused_stage1(qt, tt), 10 * reps)
    k1_plain = loop_ms(lambda: fr._stage1_reference(qt, tt), reps)
    k1_ms2 = loop_ms(lambda: fr.fused_stage1(qt, tt), 10 * reps)
    fma_ms = loop_ms(lambda: fr.fused_stage1(qf, tf), 5)
    fma_plain = loop_ms(lambda: fr._stage1_reference(qf, tf), reps)
    k2_ms = dev_ms(lambda: rt.peel_rows(packed, 6))
    k2_plain = loop_ms(lambda: rt.peel_rows_reference(packed, 6), reps)
    k2_ms2 = dev_ms(lambda: rt.peel_rows(packed, 6))
    w = m // 128
    topk_ms = loop_ms(lambda: packed.view(b_time, w, 128).topk(6, dim=2), reps)
    k1_best, k2_best = min(k1_ms, k1_ms2), min(k2_ms, k2_ms2)
    mm_ms, slices = (matmul_yardstick_ms(torch, qt, tt, reps) if dev.type == "cuda"
                     else (None, 0))
    k1_bound = stage1_bound(qt, tt)
    fma_bound = stage1_bound(qf, tf)
    k2_bound = bound(packed.numel() * 4 + 2 * b_time * 6 * w * 4,
                     2.0 * 6 * packed.numel(), F32_OPS_PER_S)
    print(f"stage 1 [{b_time} x 102] x [102 x {n_pad}] bf16 (wgmma): kernel {k1_ms:.3f} / "
          f"{k1_ms2:.3f} ms, twin {k1_plain:.3f} ms; bound {k1_bound[0]:.3f} ms "
          f"({k1_bound[1]}): {100 * k1_bound[0] / k1_best:.1f}% of it", flush=True)
    if mm_ms is not None:
        print(f"torch.matmul yardstick, the bf16 product alone (no pack, no window max) in "
              f"{slices} column slices: {mm_ms:.3f} ms", flush=True)
    print(f"stage 1 FMA route [{b_time} x 300] x [300 x {fma_n}] bf16: kernel {fma_ms:.3f} ms, "
          f"twin {fma_plain:.3f} ms; bound {fma_bound[0]:.4f} ms ({fma_bound[1]}): "
          f"{100 * fma_bound[0] / fma_ms:.1f}% of it", flush=True)
    print(f"peel [{b_time}, {m}] R=6 on K1's packed maxima: kernel {k2_ms:.4f} / "
          f"{k2_ms2:.4f} ms (CUDA graph), twin {k2_plain:.3f} ms; bound {k2_bound[0]:.4f} ms "
          f"({k2_bound[1]}): {100 * k2_bound[0] / k2_best:.1f}% of it; context, not the same "
          f"function (it differs on ties): x.view(B, W, 128).topk(6, dim=2) {topk_ms:.3f} ms",
          flush=True)
    # library_ms: no one PyTorch call computes either function (K1 is a
    # product, a bit pack and a strided window max; torch.topk differs from
    # K2 on ties, since K2 clears every slot equal to the max)
    return [
        {"name": "fused_stage1", "route": "cuda", "source": K1_SOURCE,
         "replaces": "otto_tpu/ops/pallas_retrieval.py:68", "launches": 0,
         "max_abs_err": k1_err, "ms": k1_best, "plain_ms": k1_plain,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None},
        {"name": "peel_rows", "route": "cuda", "source": K1_SOURCE,
         "replaces": "otto_tpu/ops/row_topk.py:38", "launches": 0,
         "max_abs_err": k2_err, "ms": k2_best, "plain_ms": k2_plain,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None},
    ]


def _host_ms(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def overlap(a: np.ndarray, b: np.ndarray) -> float:
    return sum(len(set(x.tolist()) & set(y.tolist())) for x, y in zip(a, b)) / a.size


def retrieval(torch, dev, n_aids: int, n_queries: int, n_recall: int, workdir: Path):
    """Phase 3: seeded table through save/load, fused top-k rate and recall.
    Returns the loaded model."""
    from otto_tpu_torch.models.embeddings import SGNSModel
    from otto_tpu_torch.ops.fused_retrieval import FusedRetriever
    from otto_tpu_torch.ops.retrieval import topk_scan

    rng = np.random.default_rng(SEED)
    w_in = rng.standard_normal((n_aids, DIM), dtype=np.float32)
    path = workdir / "sgns.npz"
    SGNSModel.from_jax_arrays(w_in, np.zeros_like(w_in), np.zeros(n_aids, np.float32),
                              device="cpu").save(path)
    model = SGNSModel.load(path, device=dev)
    check(model.w_in.shape == (n_aids, DIM) and model.device.type == dev.type,
          "loaded table shape/device")
    check(np.array_equal(model.w_in.cpu().numpy(), w_in), "save/load round trip")

    retriever = FusedRetriever(model.w_in, metric="euclidean", precision="compensated",
                               device=dev)
    q = model.w_in[torch.as_tensor(rng.choice(n_aids, n_queries, replace=False), device=dev)]
    retriever.topk(q, k=K_NNS)  # warm-up
    sync(torch, dev)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        s, i = retriever.topk(q, k=K_NNS)
    sync(torch, dev)
    per_batch = (time.perf_counter() - t0) / reps
    check(bool(torch.isfinite(s).all()) and i.shape == (n_queries, K_NNS), "top-k output")
    _, ei = topk_scan(q[:n_recall], model.w_in, k=K_NNS, metric="euclidean")
    rec = overlap(i[:n_recall].cpu().numpy(), ei.cpu().numpy())
    print(f"FusedRetriever(euclidean, compensated) {n_aids} x {DIM}, {n_queries} queries "
          f"k={K_NNS}: {per_batch * 1e3:.1f} ms per batch, "
          f"{n_queries / per_batch:.0f} queries/s; recall vs exact scan on {n_recall} "
          f"queries {rec:.4f} (limit 0.99)", flush=True)
    check(rec >= 0.99, f"recall {rec} < 0.99")
    return model


def wide_retrieval(torch, dev, n_items: int, dim: int, n_queries: int):
    """Phase 3b: ``FusedRetriever`` (euclidean, compensated) on a seeded
    ``n_items`` x ``dim`` table with dim >= 84, so that the contraction
    3(dim + 2) passes the wgmma kernel's 256 and stage 1 takes its FMA
    route; recall against the exact scan.  The caller zeroes the launch
    counters before and reads them after.  Returns the retriever and the
    queries."""
    from otto_tpu_torch.ops.fused_retrieval import FusedRetriever
    from otto_tpu_torch.ops.retrieval import topk_scan

    rng = np.random.default_rng(SEED + 3)
    items = torch.as_tensor(rng.standard_normal((n_items, dim), dtype=np.float32), device=dev)
    q = items[torch.as_tensor(rng.choice(n_items, n_queries, replace=False), device=dev)]
    t0 = time.perf_counter()
    retriever = FusedRetriever(items, metric="euclidean", precision="compensated", device=dev)
    s, i = retriever.topk(q, k=K_NNS)
    sync(torch, dev)
    secs = time.perf_counter() - t0
    check(bool(torch.isfinite(s).all()) and i.shape == (n_queries, K_NNS), "wide top-k output")
    _, ei = topk_scan(q, items, k=K_NNS, metric="euclidean")
    rec = overlap(i.cpu().numpy(), ei.cpu().numpy())
    print(f"FusedRetriever(euclidean, compensated) {n_items} x {dim} (contraction "
          f"{retriever.items_aug_t.shape[0]}), {n_queries} queries k={K_NNS}: {secs:.2f} s "
          f"with the table's preparation; recall vs exact scan {rec:.4f} (limit 0.99)",
          flush=True)
    check(rec >= 0.99, f"wide-table recall {rec} < 0.99")
    return retriever, q


def wide_stage1_vs_twin(torch, dev, retriever, q, reps: int = 3) -> dict:
    """Phase 3b, after its counters are read: stage 1's FMA route against its
    twin on the wide table's own operands (the retriever's augmented table,
    and the queries augmented and split as ``FusedRetriever.topk`` does),
    then the times of both.  The kernel sums each product in ascending d,
    cuBLAS's float32 matmul in another order, so as in phase 2 the live
    windows agree within 2^-15 relative and the window positions on >= 0.999
    of cells.  Returns the route's record for the kernels line."""
    from otto_tpu_torch.ops import fused_retrieval as fr

    q_aug, _ = fr._augment_queries(q, retriever.max_sq, retriever.metric)
    qhi, qlo = fr._bf16_split(q_aug)
    q_aug = torch.cat([qhi, qhi, qlo], dim=1)
    t = retriever.items_aug_t
    k, r = fr.fused_stage1(q_aug, t), fr._stage1_reference(q_aug, t)
    sync(torch, dev)
    live = r >= 1.0  # pad windows pack below 1.0 in both
    check(torch.equal(live, k >= 1.0), "stage 1 FMA route on the wide table: live windows differ")
    rel = ((k - r).abs() / r.abs())[live].max().item()
    same = ((k.view(torch.int32) & 127) == (r.view(torch.int32) & 127)).float().mean().item()
    err = (k - r).abs().max().item()
    check(rel <= 2.0**-15, f"stage 1 FMA route on the wide table: relative error {rel}")
    check(same >= 0.999, f"stage 1 FMA route on the wide table: positions agree on {same}")
    del k, r
    loop_ms = ((lambda fn, n: cuda_ms(torch, fn, n)) if dev.type == "cuda" else _host_ms)
    ms = loop_ms(lambda: fr.fused_stage1(q_aug, t), reps)
    plain_ms = loop_ms(lambda: fr._stage1_reference(q_aug, t), reps)
    ms2 = loop_ms(lambda: fr.fused_stage1(q_aug, t), reps)
    b = stage1_bound(q_aug, t)
    print(f"stage 1 FMA route on the wide table's operands [{q_aug.shape[0]} x {t.shape[0]}] x "
          f"[{t.shape[0]} x {t.shape[1]}] bf16: max rel err {rel:.3e} (limit 2^-15), same "
          f"window position {same:.6f} (limit 0.999); kernel {ms:.3f} / {ms2:.3f} ms, twin "
          f"{plain_ms:.3f} ms; bound {b[0]:.4f} ms ({b[1]}): {100 * b[0] / min(ms, ms2):.1f}% "
          f"of it", flush=True)
    return {"name": "fused_stage1_fma", "route": "cuda", "source": K1_SOURCE,
            "replaces": "otto_tpu/ops/pallas_retrieval.py:68", "launches": 0,
            "max_abs_err": err, "ms": min(ms, ms2), "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None}


def serve(torch, dev, model, n_sessions: int, n_check: int):
    """Phase 4: the serving path of run_embedding_knn, then its checks."""
    from otto_tpu_torch.data.splits import split_by_fraction
    from otto_tpu_torch.data.synthetic import synthetic_events_v2
    from otto_tpu_torch.eval.harness import evaluate_predictions
    from otto_tpu_torch.models.embeddings import embedding_knn_predictions
    from otto_tpu_torch.ops.retrieval import topk_scan

    n_aids = model.w_in.shape[0]
    sp = split_by_fraction(synthetic_events_v2(n_sessions=n_sessions, n_aids=n_aids,
                                               seed=SEED))
    t0 = time.perf_counter()
    table = model.neighbor_table(k=K_NNS)
    table_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    preds = embedding_knn_predictions(sp.val_input, table, k=20, device=dev)
    sync(torch, dev)
    predict_s = time.perf_counter() - t0
    report = evaluate_predictions(sp.val_labels, preds["clicks"], preds["carts"],
                                  preds["orders"], device=dev)
    print(f"neighbor table k={K_NNS} over {n_aids} aids: {table_s:.2f} s; predict "
          f"{sp.val_input.n_sessions} sessions: {predict_s:.2f} s", flush=True)
    print(f"weighted recall@20 {report.weighted:.6f} (clicks {report.clicks:.6f}, carts "
          f"{report.carts:.6f}, orders {report.orders:.6f})", flush=True)

    check(table.shape == (n_aids, K_NNS) and table.min() >= 0 and table.max() < n_aids,
          "neighbor table range")
    check(not (table == np.arange(n_aids)[:, None]).any(), "self in neighbor rows")
    p = preds["clicks"]
    check(p.shape == (sp.val_input.n_sessions, 20) and p.min() >= -1 and p.max() < n_aids,
          "prediction shape/range")
    check(0.0 <= report.weighted <= 1.0 and np.isfinite(report.weighted), "weighted recall")
    # table rows against the exact scan (self excluded) on sampled aids
    sample = np.random.default_rng(SEED + 1).choice(n_aids, n_check, replace=False)
    _, ei = topk_scan(model.w_in[torch.as_tensor(sample, device=dev)], model.w_in,
                      k=K_NNS + 1, metric="euclidean")
    ei = ei.cpu().numpy()
    exact = np.stack([r[r != a][:K_NNS] for r, a in zip(ei, sample)])
    rec = overlap(table[sample], exact)
    print(f"neighbor rows vs exact scan on {n_check} aids: overlap {rec:.4f} "
          f"(limit 0.99)", flush=True)
    check(rec >= 0.99, f"neighbor-table overlap {rec} < 0.99")
    return report


def vote_bound(torch, w):
    """The bound on ``agg`` against the twin, per row: the twin sums by
    einsum, so on fractional weights the last bits may differ."""
    return 2.0**-16 * w.abs().sum(dim=1, keepdim=True)


def vote_time_bound(torch, aids) -> tuple[float, str]:
    """The session vote's bound on these rows: aids and weights read, agg,
    first and firstpos written, 4 bytes each a position; or its operations,
    a compare and an add for each pair of positions in a row's live prefix
    (up to its last aid >= 0; no later slot can match a real aid)."""
    S, L = aids.shape
    live = aids >= 0
    hi = torch.where(live.any(dim=1), L - live.flip(1).to(torch.int32).argmax(dim=1), 0)
    return bound(S * L * 4 * 5, 2.0 * float((hi.double() ** 2).sum()), F32_OPS_PER_S)


def compare_vote(torch, dev, S: int, L: int, n_cpu: int, reps: int = 20) -> dict:
    """The session vote against its twin on synthetic rows at [S, L]: the
    largest ``agg`` error and, when ``reps`` > 0, the times of both."""
    from otto_tpu_torch.ops import fused_sessions as fs
    from otto_tpu_torch.ops import sessions as ses

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    aids = torch.randint(0, 48, (S, L), generator=g, device=dev, dtype=torch.int32)
    tail = torch.randint(0, L + 1, (S, 1), generator=g, device=dev)
    aids[torch.arange(L, device=dev)[None, :] >= L - tail] = -1
    valid = aids >= 0
    w_int = torch.where(valid, torch.randint(1, 7, (S, L), generator=g, device=dev).float(), 0.0)
    w_norm = torch.where(valid, torch.randn((S, L), generator=g, device=dev), 0.0)
    err = 0.0
    for name, w in (("integer", w_int), ("normal", w_norm)):
        ka, kf, kp = fs.aid_vote_aggregate(aids, w)
        ra, rf, rp = fs._vote_reference(aids, w)
        sync(torch, dev)
        check(torch.equal(kf, rf) and torch.equal(kp, rp),
              f"vote ({name} weights): first/firstpos differ from the twin")
        d = (ka - ra).abs()
        check(bool((d <= vote_bound(torch, w)).all()),
              f"vote ({name} weights): agg beyond 2^-16 * sum|w|")
        if name == "integer":
            check(torch.equal(ka, ra), "vote (integer weights): agg differs from the twin")
        err = max(err, d.max().item())
        print(f"vote [{S}, {L}] {name} weights: first/firstpos bit-equal, agg max abs err "
              f"{d.max().item():.3e} (limit 2^-16 * sum|w| of the row)", flush=True)

    fa, fw = fs.per_aid_weight_top_fused(aids, w_int, valid, k=20)
    pa, pw = ses.per_aid_weight_top(aids, w_int, valid, k=20)
    ca, cw = ses.per_aid_weight_top(aids[:n_cpu].cpu(), w_int[:n_cpu].cpu(), valid[:n_cpu].cpu(),
                                    k=20)
    check(torch.equal(fa, pa) and torch.equal(torch.where(pa >= 0, pw, 0.0), fw),
          "per_aid_weight_top_fused and per_aid_weight_top differ")
    check(torch.equal(pa[:n_cpu].cpu(), ca) and torch.equal(pw[:n_cpu].cpu(), cw),
          "per_aid_weight_top on the card and on the CPU twin differ")
    print(f"top-20 on integer weights: fused == per_aid_weight_top on [{S}, {L}], == CPU twin "
          f"path on {n_cpu} rows", flush=True)

    if not reps:
        return {"err": err}
    return {"err": err, "bound": vote_time_bound(torch, aids),
            **time_vote(torch, aids, w_norm, reps)}


def time_vote(torch, aids, w, reps: int) -> dict:
    """The kernel's device ms warm (the same inputs, in L2) and cold (over
    rotating copies of the inputs, more than 50 MB in all), each by a CUDA
    graph, twice, in turns with the twin's ms by a loop of calls."""
    from otto_tpu_torch.ops import fused_sessions as fs

    warm, cold = warm_cold_ms(torch, fs.aid_vote_aggregate, (aids, w))
    plain_ms = cuda_ms(torch, lambda: fs._vote_reference(aids, w), reps)
    warm2, cold2 = warm_cold_ms(torch, fs.aid_vote_aggregate, (aids, w))
    print(f"vote {list(aids.shape)}: kernel warm {warm:.4f} / {warm2:.4f} ms, cold "
          f"{cold:.4f} / {cold2:.4f} ms (CUDA graphs), twin {plain_ms:.4f} ms", flush=True)
    return {"ms": min(cold, cold2), "warm_ms": min(warm, warm2), "plain_ms": plain_ms}


def vote_on_path(torch, dev, target, served: np.ndarray, chunk: int = 1024) -> dict:
    """Phase 8: the session vote at the shape the aid-weight runner gave it
    in phase 7 (the packed target, one launch).  On the runner's own inputs
    the kernel is held against its twin (run ``chunk`` rows at a time), and
    the runner's lists ``served`` against the twin's ranking: equal wherever
    the twin's neighbouring scores differ by more than twice the row's
    bound.  Then the checks of phase 5 on synthetic rows at [chunk, L].
    Returns the largest ``agg`` error and the times at the path's shape."""
    from otto_tpu_torch import pipelines
    from otto_tpu_torch.models.recency import VALIDATION_COEFFICIENTS
    from otto_tpu_torch.ops import fused_sessions as fs
    from otto_tpu_torch.ops import sessions as ses

    packed = pipelines._packed(target)

    def t(a):
        return torch.as_tensor(a, device=dev)

    mask = t(packed.mask)
    coef = torch.tensor(VALIDATION_COEFFICIENTS, dtype=torch.float32, device=dev)
    w = ses.recency_event_weights(t(packed.aids), t(packed.types), mask, t(packed.lengths), coef)
    aids = torch.where(mask, t(packed.aids), -1).to(torch.int32)
    w = torch.where(mask, w, 0.0)
    S, L = aids.shape
    print(f"aid-weight path's vote input [{S}, {L}], {int(mask.sum())} events, "
          f"{int(mask.sum()) / S:.2f} a session: the kernel scans each row's live prefix",
          flush=True)
    ka, kf, kp = fs.aid_vote_aggregate(aids, w)
    ra, rf, rp = (torch.cat(x) for x in zip(*(
        fs._vote_reference(aids[i:i + chunk], w[i:i + chunk]) for i in range(0, S, chunk))))
    sync(torch, dev)
    check(torch.equal(kf, rf) and torch.equal(kp, rp),
          "vote on the path's inputs: first/firstpos differ from the twin")
    bound = vote_bound(torch, w)
    d = (ka - ra).abs()
    check(bool((d <= bound).all()), "vote on the path's inputs: agg beyond 2^-16 * sum|w|")
    err = d.max().item()

    k = served.shape[1]
    kl, ks = ses._rank_select(aids, torch.where(kf > 0, ka, ses.NEG), kp, k)
    check(np.array_equal(kl.cpu().numpy(), served),
          "the aid-weight runner's lists are not the ranking of the kernel's sums")
    rl, rs = ses._rank_select(aids, torch.where(rf > 0, ra, ses.NEG), rp, min(k + 1, L))
    check(torch.equal(kl >= 0, rl[:, :k] >= 0), "kernel and twin rank different aid counts")
    live = rl[:, :k] >= 0
    check(bool(((ks - rs[:, :k]).abs() <= bound)[live].all()),
          "ranked scores beyond the bound")
    close = (rs[:, 1:] - rs[:, :-1]).abs() <= 2 * bound
    near = torch.zeros_like(rs, dtype=torch.bool)
    near[:, 1:] |= close
    near[:, :-1] |= close
    differ = kl != rl[:, :k]
    check(not bool((differ & ~near[:, :k]).any()), "lists differ away from near-ties")
    print(f"vote on the path's inputs: first/firstpos bit-equal, agg max abs err {err:.3e} "
          f"(limit 2^-16 * sum|w| of the row); the runner's lists equal the twin's ranking "
          f"but {int(differ.any(dim=1).sum())} of {S} rows (near-ties)", flush=True)

    err = max(err, compare_vote(torch, dev, chunk, L, n_cpu=512, reps=0)["err"])
    return {"err": err, "shape": (S, L), "bound": vote_time_bound(torch, aids),
            **time_vote(torch, aids, w, 5)}


def tables_match(got, want) -> tuple[int, int]:
    """Covisitation tables of the port against the reference's: the six
    integer-weighted kinds bit-equal; ``time_weighted`` weights within 1e-5
    relative and its ids equal wherever the row's adjacent weights differ by
    more than 1e-5 relative.  Returns (ids that differ at near-ties, live
    entries) of ``time_weighted``."""
    from otto_tpu_torch.config import COVISIT_KINDS

    swapped = live = 0
    for kind in COVISIT_KINDS:
        (ga, gw), (wa, ww) = got.tables[kind], want.tables[kind]
        check(ga.shape == wa.shape and ga.dtype == wa.dtype and gw.dtype == ww.dtype,
              f"{kind}: table shape/dtype")
        if kind != "time_weighted":
            check(np.array_equal(ga, wa) and np.array_equal(gw, ww),
                  f"{kind}: table differs from the committed one")
            continue
        check(bool(np.all(np.abs(gw - ww) <= 1e-5 * np.abs(ww))), f"{kind}: weights beyond 1e-5")
        close = np.abs(np.diff(ww, axis=1)) <= 1e-5 * np.abs(ww[:, 1:])
        near = np.zeros(ww.shape, bool)
        near[:, 1:] |= close
        near[:, :-1] |= close
        differ = ga != wa
        check(not (differ & ~near).any(), f"{kind}: ids differ away from near-ties")
        swapped, live = int(differ.sum()), int((wa >= 0).sum())
    return swapped, live


def covisit_build(torch, dev) -> dict:
    """Phase 6: the bench's covisitation build on the card against the
    committed tables.  Returns its numbers."""
    from otto_tpu_torch.data.splits import split_by_time
    from otto_tpu_torch.data.synthetic import synthetic_events_v2
    from otto_tpu_torch.models.covisitation import CovisitationMatrices, build_covisitation

    art = REPO / "artifacts" / "bench_e2e"
    fit = json.loads((art / "bench_fit.json").read_text())
    t0 = time.perf_counter()
    store = synthetic_events_v2(n_sessions=fit["sessions"], n_aids=fit["aids"], seed=fit["seed"])
    split = split_by_time(store, val_fraction=fit["val_fraction"], seed=fit["seed"])
    data_s = time.perf_counter() - t0
    stats: dict = {}
    t0 = time.perf_counter()
    mats = build_covisitation(split.train, fit["aids"], stats_out=stats, device=dev)
    build_s = time.perf_counter() - t0
    swapped, live = tables_match(mats, CovisitationMatrices.load(art / "covisitation"))
    n_ev = split.train.n_events
    print(f"data {data_s:.2f} s; build_covisitation over {split.train.n_sessions} sessions, "
          f"{n_ev} events, {fit['aids']} aids: {build_s:.2f} s ({n_ev / build_s:.0f} events/s), "
          f"dispatch {stats['dispatch_s']} s, drain {stats['drain_s']} s", flush=True)
    print(f"tables vs artifacts/bench_e2e/covisitation: six kinds bit-equal; time_weighted "
          f"{swapped} of {live} ids swapped at near-ties", flush=True)
    return {"build_s": build_s, "events": n_ev, "split": split}


def baselines(torch, dev, n_sessions: int) -> dict:
    """Phase 7: the three runners of ``pipelines`` at full width, then the
    heuristic re-served on the host routes.  The caller zeroes the launch
    counters before and reads them after."""
    from otto_tpu_torch import EVENT_TYPES, pipelines
    from otto_tpu_torch.data.splits import split_by_fraction
    from otto_tpu_torch.data.synthetic import synthetic_events_v2
    from otto_tpu_torch.models.covisitation import (
        covisit_heuristic_predictions, session_unique_counts)
    from otto_tpu_torch.models.frequency import FrequencyStatistics

    t0 = time.perf_counter()
    sp = split_by_fraction(synthetic_events_v2(n_sessions=n_sessions, n_aids=N_AIDS, seed=SEED))
    target = sp.val_input
    print(f"data {time.perf_counter() - t0:.2f} s: {sp.train.n_sessions} train sessions "
          f"({sp.train.n_events} events), {target.n_sessions} target sessions", flush=True)

    built = {}
    build = pipelines.build_covisitation

    def build_and_keep(*args, **kwargs):  # the runner's own build, kept for the re-serve
        t = time.perf_counter()
        built["mats"] = build(*args, **kwargs)
        built["s"] = time.perf_counter() - t
        return built["mats"]

    runs = {}
    pipelines.build_covisitation = build_and_keep
    try:
        for name, run in (
            ("aid_frequency", lambda: pipelines.run_aid_frequency(
                sp.train, target, N_AIDS, sp.val_labels, device=dev)),
            ("aid_weight", lambda: pipelines.run_aid_weight(target, sp.val_labels, device=dev)),
            ("covisitation", lambda: pipelines.run_covisit_heuristic(
                sp.train, target, N_AIDS, sp.val_labels, device=dev)),
        ):
            t = time.perf_counter()
            res = run()
            sync(torch, dev)
            runs[name] = (res, time.perf_counter() - t)
    finally:
        pipelines.build_covisitation = build
    for name, (res, s) in runs.items():
        r = res.report
        for t in EVENT_TYPES:
            p = res.predictions[t]
            check(p.shape == (target.n_sessions, 20) and p.min() >= -1 and p.max() < N_AIDS,
                  f"{name} {t}: prediction shape/range")
        check(0.0 < r.weighted < 1.0 and np.isfinite(r.weighted), f"{name}: weighted recall")
        print(f"{name}: {s:.2f} s ({target.n_sessions / s:.0f} sessions/s), weighted recall@20 "
              f"{r.weighted:.6f} (clicks {r.clicks:.6f}, carts {r.carts:.6f}, orders "
              f"{r.orders:.6f})", flush=True)

    heur = runs["covisitation"][0].predictions
    counts = session_unique_counts(target)
    cov = counts < 20
    print(f"covisitation: build {built['s']:.2f} s inside the runner; routes: {int(cov.sum())} "
          f"covisitation, {int((~cov).sum())} recency sessions", flush=True)
    stats = FrequencyStatistics.compute(sp.train, n_aids=N_AIDS, device=dev)
    top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
    t0 = time.perf_counter()
    again = covisit_heuristic_predictions(target, built["mats"], top, device=dev)
    sync(torch, dev)
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = covisit_heuristic_predictions(target, built["mats"], top, recency_host_f64=True,
                                         covisit_host=True, device=dev)
    host_s = time.perf_counter() - t0
    agree = {}
    for t in EVENT_TYPES:
        check(np.array_equal(again[t], heur[t]), f"heuristic {t}: two device serves differ")
        check(np.array_equal(host[t][cov], heur[t][cov]),
              f"heuristic {t}: covisitation route, device and host differ")
        agree[t] = float((host[t][~cov] == heur[t][~cov]).all(axis=1).mean()) if (~cov).any() \
            else 1.0
    print(f"heuristic serve on the card (build excluded, tables uploaded): {serve_s:.2f} s "
          f"({target.n_sessions / serve_s:.0f} sessions/s); host routes {host_s:.2f} s; "
          f"covisitation route device == host; recency route rows equal to the host's f64 "
          f"route: {agree}", flush=True)
    return {"serve_s": serve_s, "target": target, "train": sp.train, "mats": built["mats"],
            "heur": heur, "aid_weight": runs["aid_weight"][0].predictions["clicks"]}


# What the JAX package's CPU replay of bench.py::e2e_artifact_bench recorded
# for the 8,000 training-disjoint sessions (BENCH_r05.json, "e2e"): rows
# scored by the rankers, the weighted recalls and lift to four decimals, and
# the paired bootstrap (300 draws, seed 0).
REPLAY_SESSIONS = 8000
REPLAY_EXPECTED = {
    "rows": 4_416_000, "weighted": 0.6372, "heuristic": 0.6226, "lift": 0.0145,
    "bootstrap": {"lift": 0.014549, "weighted_a": 0.637178, "weighted_b": 0.622629,
                  "ci95": [0.008279, 0.021078], "p_le_0": 0.0, "boot_mean": 0.014389,
                  "boot_std": 0.003385, "n_sessions": 8000, "n_boot": 300,
                  "significant": True},
}
FOREST_SOURCE = "otto_tpu_torch/csrc/forest_kernels.cu"


def forest_bound(x, pack) -> tuple[float, str]:
    """The forest pass's bound on these rows: the binned rows and the model
    (nodes and leaves as the kernel reads them) read once and the scores
    written once; or its operations, one int32 operation for each node step
    (rows x trees x depth)."""
    n = x.shape[0]
    n_bytes = (x.numel() + 4 * n + 4 * (pack.nodes.numel() + pack.leaf.numel())
               + 8 * pack.n_folds)
    return bound(n_bytes, float(n) * pack.feat.shape[0] * pack.depth, INT32_OPS_PER_S)


def forest_twin(torch, x, pack):
    """The fold average of ``_predict_forest_reference`` as
    ``predict_forest`` forms it on a CPU tensor, here on ``x``'s device."""
    from otto_tpu_torch.ops import forest

    acc = None
    for feat, thr, leaf, base in pack.folds():
        r = forest._predict_forest_reference(x, feat, thr, leaf, base, pack.depth)
        acc = r if acc is None else acc + r
    return acc * torch.tensor(np.float32(1.0 / pack.n_folds), device=x.device)


def two_stage_artifacts(sgns=None, matrices=None):
    """The committed artifacts of ``artifacts/bench_e2e`` for the port: the
    covisitation tables the JAX package wrote (or ``matrices``), the three
    GBDT fold models, the training-time settings of meta.json, and ``sgns``
    if given."""
    from otto_tpu_torch.models.covisitation import CovisitationMatrices
    from otto_tpu_torch.models.gbdt import load_ranker_model
    from otto_tpu_torch.twostage import TwoStageArtifacts

    art = REPO / "artifacts" / "bench_e2e"
    meta = json.loads((art / "meta.json").read_text())
    rankers = {n: load_ranker_model(art / f"ranker_{n}.npz") for n in meta["ranker_names"]}
    if matrices is None:
        matrices = CovisitationMatrices.load(art / "covisitation")
    return TwoStageArtifacts(
        matrices=matrices, sgns=sgns, candidates=None,
        rankers=rankers, predictions={}, report=None, max_recall=meta.get("max_recall", {}),
        heuristic_union=meta.get("heuristic_union", True), feature_list=meta["feature_list"])


def two_stage_replay(torch, dev, split, n_eval: int, n_boot: int, zero_counters,
                     read_counters) -> dict:
    """Phase 9: ``bench.py::e2e_artifact_bench`` in artifact mode on the
    port, in its order: the bench's data (``split``), the committed tables
    and fold models, aid features over train + target (against the
    committed ``aid_feats.npz``), the first ``n_eval`` training-disjoint
    sessions, the heuristic on the host routes, ``predict_two_stage`` on the
    card with the launch counters zeroed before and read after, recall,
    lift and the paired bootstrap, printed beside ``REPLAY_EXPECTED`` (the
    caller holds them to it).  Returns the path's launches, the forest
    pass's inputs (the binned rows and the packed model of each type, kept
    on their way into ``predict_binned_folds``) and the evaluated
    sessions."""
    from otto_tpu_torch import EVENT_TYPES, streaming
    from otto_tpu_torch.eval.harness import evaluate_predictions, paired_bootstrap_lift
    from otto_tpu_torch.features import compute_aid_features
    from otto_tpu_torch.models.covisitation import covisit_heuristic_predictions
    from otto_tpu_torch.models.frequency import FrequencyStatistics
    from otto_tpu_torch.models.gbdt import GBDTRankerModel
    from otto_tpu_torch.twostage import predict_two_stage

    art = REPO / "artifacts" / "bench_e2e"
    fit = json.loads((art / "bench_fit.json").read_text())
    n_aids = fit["aids"]
    artifacts = two_stage_artifacts()

    t0 = time.perf_counter()
    aid_feats = compute_aid_features(streaming._union_stats_store(split.train, split.val_input),
                                     n_aids)
    feats_s = time.perf_counter() - t0
    worst, worst_key, differ = 0.0, None, []
    with np.load(art / "aid_feats.npz") as z:
        check(set(z.files) == set(aid_feats), "aid feature names differ from aid_feats.npz")
        for k in sorted(z.files):
            a, b = aid_feats[k], z[k]
            check(np.array_equal(np.isnan(a), np.isnan(b)), f"aid feature {k}: NaN pattern")
            fin = ~np.isnan(b)
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = float(np.max(np.abs(a[fin] - b[fin]) / np.abs(b[fin]), initial=0.0,
                                   where=b[fin] != 0))
            rel = max(rel, float(np.max(np.abs(a[fin]), initial=0.0, where=b[fin] == 0)))
            if rel > 0:
                differ.append(f"{k} {rel:.3e}")
            if rel >= worst:
                worst, worst_key = rel, k
    print(f"aid features over train + target ({len(aid_feats)} keys, {feats_s:.2f} s) vs "
          f"artifacts/bench_e2e/aid_feats.npz: NaN in the same places; largest relative "
          f"difference {worst:.3e} ({worst_key}); keys that differ: "
          f"{', '.join(differ) if differ else 'none'}", flush=True)
    check(worst <= 1e-6, f"aid features: relative difference {worst} ({worst_key})")

    S = split.val_input.n_sessions
    fit_idx = streaming.train_subset_indices(S, fit["train_sessions"], fit["train_subset_seed"])
    pool = np.ones(S, bool)
    pool[fit_idx] = False
    eval_idx = np.flatnonzero(pool)[:n_eval]
    emask = np.zeros(S, bool)
    emask[eval_idx] = True
    sub = split.val_input.select_sessions(emask)
    sub_labels = split.val_labels.take(eval_idx)

    t0 = time.perf_counter()
    stats = FrequencyStatistics.compute(split.train, n_aids=n_aids, device=dev)
    heur = covisit_heuristic_predictions(
        sub, artifacts.matrices, {t: stats.top_by_type[t] for t in EVENT_TYPES},
        chunk_sessions=512, recency_host_f64=True, covisit_host=True, device=dev)
    heur_s = time.perf_counter() - t0

    captured = []
    real = GBDTRankerModel.predict_binned_folds

    def keep_inputs(self, binned, *, device):  # the path's own forest inputs, kept
        captured.append((binned, self))
        return real(self, binned, device=device)

    pstats: dict = {}
    GBDTRankerModel.predict_binned_folds = keep_inputs
    try:
        zero_counters()
        t0 = time.perf_counter()
        preds = predict_two_stage(artifacts, split.train, sub, n_aids, aid_feats=aid_feats,
                                  heuristic_preds=heur, chunk_sessions=512, stats_out=pstats,
                                  device=dev)
        sync(torch, dev)
        predict_s = time.perf_counter() - t0
        launches = read_counters("two-stage path", ("predict_forest",))
    finally:
        GBDTRankerModel.predict_binned_folds = real
    rows = sum(v for k, v in pstats.items() if k.startswith("rows_"))
    print(f"predict_two_stage on {sub.n_sessions} training-disjoint sessions: {predict_s:.2f} s "
          f"({sub.n_sessions / predict_s:.0f} sessions/s, {rows / predict_s:.0f} ranker rows/s); "
          f"{rows} ranker rows", flush=True)
    print("stages (s): " + ", ".join(
        f"{k[:-2]} {pstats[k]:.3f}" for k in ("candidates_s", "union_s", "features_s",
                                               "binning_s", "forest_s", "blend_s"))
          + f"; heuristic on the host routes (given to the path) {heur_s:.3f}", flush=True)

    for t in EVENT_TYPES:
        p = preds[t]
        check(p.shape == (sub.n_sessions, 20) and p.min() >= -1 and p.max() < n_aids,
              f"two-stage {t}: prediction shape/range")
    rep = evaluate_predictions(sub_labels, preds["clicks"], preds["carts"], preds["orders"],
                               device=dev)
    heur_rep = evaluate_predictions(sub_labels, heur["clicks"], heur["carts"], heur["orders"],
                                    device=dev)
    boot = paired_bootstrap_lift(sub_labels, preds, heur, n_boot=n_boot)
    got = {"rows": rows, "weighted": round(rep.weighted, 4),
           "heuristic": round(heur_rep.weighted, 4),
           "lift": round(rep.weighted - heur_rep.weighted, 4), "bootstrap": boot}
    print(f"weighted recall@20 {rep.weighted:.6f} (clicks {rep.clicks:.6f}, carts "
          f"{rep.carts:.6f}, orders {rep.orders:.6f}); heuristic {heur_rep.weighted:.6f}; lift "
          f"{rep.weighted - heur_rep.weighted:+.6f}; paired bootstrap {json.dumps(boot)}",
          flush=True)
    same = {k: got[k] == v for k, v in REPLAY_EXPECTED.items()}
    print(f"against BENCH_r05.json's CPU replay (rows, recalls and lift to four decimals, the "
          f"bootstrap): equal {same} (held to it once phase 9's other checks have run)",
          flush=True)
    check(len(captured) == 3 and (dev.type != "cuda" or launches["predict_forest"] == 3),
          "the path did not make one forest launch a type")
    forest_inputs = [(torch.as_tensor(b, device=dev), m.packed(dev)) for b, m in captured]
    return {"launches": launches, "forest_inputs": forest_inputs, "artifacts": artifacts,
            "replay": got, "sub": sub, "heur": heur, "aid_feats": aid_feats,
            "n_aids": n_aids}


def two_stage_parity(torch, dev, split, replay: dict, n_parity: int) -> None:
    """Phase 9: on the first ``n_parity`` replay sessions, the card's lists
    equal those of the port's CPU twin path (kernels' plain twins, the same
    numpy host stages), bit for bit.  (Not the full run's lists: the
    per-candidate-aid interaction features aggregate over the sessions
    scored together.)"""
    from otto_tpu_torch import EVENT_TYPES
    from otto_tpu_torch.twostage import predict_two_stage

    sub = replay["sub"]
    keep = np.zeros(sub.n_sessions, bool)
    keep[:n_parity] = True
    part = sub.select_sessions(keep)
    heur = {t: h[:n_parity] for t, h in replay["heur"].items()}
    kw = dict(aid_feats=replay["aid_feats"], heuristic_preds=heur, chunk_sessions=512)
    t0 = time.perf_counter()
    on_card = predict_two_stage(replay["artifacts"], split.train, part, replay["n_aids"],
                                device=dev, **kw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = predict_two_stage(replay["artifacts"], split.train, part, replay["n_aids"],
                               device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    for t in EVENT_TYPES:
        check(np.array_equal(on_card[t], on_cpu[t]), f"two-stage {t}: card and CPU twin differ")
    print(f"{n_parity} sessions: the card's lists equal the CPU twin path's, bit for bit "
          f"(card {card_s:.2f} s, CPU {cpu_s:.2f} s)", flush=True)


def forest_vs_twin(torch, dev, replay: dict) -> dict:
    """Phase 9: the forest kernel against its twin on the path's own binned
    rows of each type, bit-equal; then its time by CUDA events over a loop
    of calls and by a CUDA graph (device time alone), the twin's, and the
    bound.  Returns the kernel's record (at the clicks launch, the largest
    model)."""
    from otto_tpu_torch import EVENT_TYPES
    from otto_tpu_torch.ops import forest

    rec = None
    for etype, (x, pack) in zip(EVENT_TYPES, replay["forest_inputs"]):
        k, r = forest.predict_forest(x, pack), forest_twin(torch, x, pack)
        sync(torch, dev)
        check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
              f"forest kernel {etype}: differs from its twin on the path's rows")
        err = (k - r).abs().max().item()
        if dev.type == "cuda":
            loop = cuda_ms(torch, lambda: forest.predict_forest(x, pack), 10)
            dev_ms = graph_ms(torch, [lambda: forest.predict_forest(x, pack)])
            plain = cuda_ms(torch, lambda: forest_twin(torch, x, pack), 1)
        else:  # a rehearsal on the CPU
            loop = dev_ms = _host_ms(lambda: forest.predict_forest(x, pack), 1)
            plain = _host_ms(lambda: forest_twin(torch, x, pack), 1)
        b = forest_bound(x, pack)
        trees = pack.feat.shape[0]
        print(f"forest {etype} [{x.shape[0]} x {x.shape[1]}] uint8, {pack.n_folds} folds, "
              f"{trees} trees of depth {pack.depth}: kernel bit-equal to its twin; kernel "
              f"{loop:.4f} ms (loop) / {dev_ms:.4f} ms (CUDA graph), twin {plain:.3f} ms; bound "
              f"{b[0]:.4f} ms ({b[1]}: {x.shape[0] * trees * pack.depth:.3e} node steps): "
              f"{100 * b[0] / dev_ms:.1f}% of it", flush=True)
        if rec is None:
            rec = {"name": "predict_forest", "route": "cuda", "source": FOREST_SOURCE,
                   "replaces": "otto_tpu/models/gbdt.py:334 (XLA, not Pallas)", "launches": 0,
                   "max_abs_err": err, "ms": dev_ms, "plain_ms": plain, "bound_ms": b[0],
                   "bound_by": b[1], "library_ms": None}
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return rec


def two_stage_knn(torch, dev, model, base: dict, n_sessions: int, zero_counters,
                  read_counters) -> dict:
    """Phase 9: ``predict_two_stage`` with an SGNS model in the artifacts, so
    the candidates take the kNN route.  At the bench's 20,000 aids the
    neighbor table takes the dense route in both packages (a table of at
    most 4 x 16,384 padded items is scored by one matmul, no stage 1), so
    this pass runs on the full catalog: phase 3's seeded 1,855,603 x 32
    model, phase 7's covisitation tables and heuristic lists, and the first
    ``n_sessions`` of phase 7's target, with the committed fold models.  The
    counters are zeroed before and read after: stage 1, the peel and the
    forest pass must all launch.  No equality demand (the table is
    approximate): the path's own table against the exact scan on 256 aids,
    overlap >= 0.99.  Returns the launches."""
    from otto_tpu_torch.ops.retrieval import topk_scan
    from otto_tpu_torch.twostage import predict_two_stage

    n_aids = model.w_in.shape[0]
    artifacts = two_stage_artifacts(sgns=model, matrices=base["mats"])
    keep = np.zeros(base["target"].n_sessions, bool)
    keep[:n_sessions] = True
    sub = base["target"].select_sessions(keep)
    heur = {t: h[:n_sessions] for t, h in base["heur"].items()}
    tables = []
    real = model.neighbor_table

    def keep_table(k, **kw):  # the path's own neighbor table, kept for the check
        tables.append(real(k, **kw))
        return tables[-1]

    pstats: dict = {}
    model.neighbor_table = keep_table
    try:
        zero_counters()
        t0 = time.perf_counter()
        preds = predict_two_stage(artifacts, base["train"], sub, n_aids, heuristic_preds=heur,
                                  chunk_sessions=512, stats_out=pstats, device=dev)
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read_counters("two-stage path with an SGNS model",
                                 ("fused_stage1", "peel_rows", "predict_forest"))
    finally:
        del model.neighbor_table
    rows = sum(v for k, v in pstats.items() if k.startswith("rows_"))
    for t, p in preds.items():
        check(p.shape == (n_sessions, 20) and p.min() >= -1 and p.max() < n_aids,
              f"two-stage with SGNS {t}: prediction shape/range")
    table = tables[0]
    sample = np.random.default_rng(SEED + 10).choice(n_aids, 256, replace=False)
    _, ei = topk_scan(model.w_in[torch.as_tensor(sample, device=dev)], model.w_in, k=21,
                      metric="euclidean")
    ei = ei.cpu().numpy()
    exact = np.stack([r[r != a][:20] for r, a in zip(ei, sample)])
    rec = overlap(table[sample], exact)
    print(f"predict_two_stage with a {n_aids} x {model.w_in.shape[1]} SGNS model over "
          f"{n_sessions} sessions ({rows} ranker rows): {secs:.2f} s, of which candidates "
          f"(the neighbor table included) {pstats['candidates_s']:.2f}, features "
          f"{pstats['features_s']:.2f}, binning {pstats['binning_s']:.2f}, forest "
          f"{pstats['forest_s']:.3f}; its neighbor table (k=20) vs the exact scan on 256 aids: "
          f"overlap {rec:.4f} (limit 0.99)", flush=True)
    check(rec >= 0.99, f"two-stage SGNS neighbor-table overlap {rec} < 0.99")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    from otto_tpu_torch.ops import _kernels, forest, fused_retrieval, fused_sessions, row_topk

    # each kernel's launch counter: (the wrapper, its attribute)
    counters = {"fused_stage1": (fused_retrieval.fused_stage1, "launches"),
                "fused_stage1_fma": (fused_retrieval.fused_stage1, "fma_launches"),
                "peel_rows": (row_topk.peel_rows, "launches"),
                "aid_vote": (fused_sessions.aid_vote_aggregate, "launches"),
                "predict_forest": (forest.predict_forest, "launches")}

    def zero_counters():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counters(path: str, expected) -> dict:
        launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        print(f"kernel launches in the {path}: {launches}", flush=True)
        for name in expected:
            check(launches[name] > 0, f"{name} was not launched by the {path}")
        return launches

    dev = torch.device("cuda", 0)
    with phase("1 device and build"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             check=True, capture_output=True, text=True).stdout.strip()
        print(smi, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        t0 = time.perf_counter()
        lib_path = _kernels.build()
        _kernels.lib()
        print(f"kernel build+load {time.perf_counter() - t0:.2f} s -> {lib_path.name}",
              flush=True)
        report = lib_path.with_suffix(".ptxas.txt")
        if report.exists():
            for line in report.read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    print(line.strip(), flush=True)

    with phase("2 kernels vs plain twins"):
        records = compare_kernels(torch, dev, N_AIDS, 256, 2048, QUERY_BATCH,
                                  N_AIDS % QUERY_BATCH)

    workdir = REPO / "tmp" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        with phase("3 full-width retrieval"):
            model = retrieval(torch, dev, N_AIDS, QUERY_BATCH, 256, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    zero_counters()
    with phase("3b wide-table retrieval (stage 1's FMA route)"):
        retriever, wide_q = wide_retrieval(torch, dev, 1_000_000, 96, 256)
    wide = read_counters("wide-table retrieval", ("fused_stage1_fma", "peel_rows"))
    with phase("3b stage 1's FMA route vs its twin on the wide table"):
        records.insert(1, wide_stage1_vs_twin(torch, dev, retriever, wide_q))
    del retriever, wide_q

    zero_counters()
    with phase("4 serving path"):
        serve(torch, dev, model, 20_000, 256)
    knn = read_counters("embedding-kNN serving path", ("fused_stage1", "peel_rows", "aid_vote"))
    torch.cuda.empty_cache()

    with phase("5 session vote vs plain twin"):
        vote = compare_vote(torch, dev, 4096, 256, 512)
        vote["err"] = max(vote["err"], compare_vote(torch, dev, 1024, 300, 256, reps=0)["err"])
        b5 = vote["bound"]
        print(f"session vote [4096, 256]: bound {b5[0]:.4f} ms ({b5[1]}): cold "
              f"{100 * b5[0] / vote['ms']:.1f}%, warm {100 * b5[0] / vote['warm_ms']:.1f}% of it",
              flush=True)

    with phase("6 covisitation build vs committed tables"):
        bench_split = covisit_build(torch, dev)["split"]

    zero_counters()
    with phase("7 baselines and covisitation heuristic"):
        path = baselines(torch, dev, 200_000)
    heur = read_counters("baseline and heuristic path", ("aid_vote",))

    with phase("8 session vote at the aid-weight path's shape"):
        on_path = vote_on_path(torch, dev, path["target"], path["aid_weight"])
    # No one PyTorch call returns K3's three per-position quantities
    # (library_ms null).  Its ms is the cold one, over input copies that do
    # not fit in L2.
    s_rows, width = on_path["shape"]
    k3_bound = on_path["bound"]
    records.append({"name": "aid_vote", "route": "cuda",
                    "source": "otto_tpu_torch/csrc/session_kernels.cu",
                    "replaces": "otto_tpu/ops/pallas_sessions.py:30", "launches": 0,
                    "max_abs_err": max(vote["err"], on_path["err"]), "ms": on_path["ms"],
                    "plain_ms": on_path["plain_ms"], "bound_ms": k3_bound[0],
                    "bound_by": k3_bound[1], "library_ms": None})
    print(f"session vote [{s_rows}, {width}]: bound {k3_bound[0]:.4f} ms ({k3_bound[1]}): "
          f"cold {100 * k3_bound[0] / on_path['ms']:.1f}%, warm "
          f"{100 * k3_bound[0] / on_path['warm_ms']:.1f}% of it", flush=True)

    with phase("9 two-stage artifact replay (bench.py::e2e_artifact_bench on the card)"):
        replay = two_stage_replay(torch, dev, bench_split, REPLAY_SESSIONS, 300, zero_counters,
                                  read_counters)
    two_stage = replay["launches"]
    with phase("9 two-stage: card vs CPU twin path on 512 sessions"):
        two_stage_parity(torch, dev, bench_split, replay, 512)
    with phase("9 forest kernel vs its twin on the path's rows"):
        records.append(forest_vs_twin(torch, dev, replay))
    check(replay["replay"] == REPLAY_EXPECTED, f"two-stage replay {replay['replay']} differs "
          f"from BENCH_r05.json's {REPLAY_EXPECTED}")
    del replay, bench_split
    with phase("9 two-stage with an SGNS model on the full catalog (the kNN candidate route)"):
        two_stage_sgns = two_stage_knn(torch, dev, model, path, 2000, zero_counters,
                                       read_counters)
    del model, path

    # launches: each kernel's count on the path it serves (the FMA route on
    # the wide table, the vote on the baselines' path, whose shape is timed;
    # the forest pass on the two-stage path)
    paths = {"embedding_knn": knn, "wide_table_retrieval": wide, "baselines": heur,
             "two_stage": two_stage, "two_stage_sgns": two_stage_sgns}
    home = {"fused_stage1": knn, "fused_stage1_fma": wide, "peel_rows": knn, "aid_vote": heur,
            "predict_forest": two_stage}
    for rec in records:
        rec["launches"] = home[rec["name"]][rec["name"]]
        rec["launches_by_path"] = {p: c[rec["name"]] for p, c in paths.items()}
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
