"""Drive the PyTorch port's paths once on one NVIDIA card: the
embedding-kNN path, the baselines with the covisitation heuristic, the
two-stage prediction path, the file CLI, and GBDT training.

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
   after: one float-row forest launch a type, no host binning; each
   stage's seconds), recall, lift and the paired bootstrap held to the CPU
   replay's numbers in ``BENCH_r05.json``; then the card's lists against
   the CPU twin path on 512 sessions (bit-equal); the pre-binned scoring
   path (``predict_binned_folds`` on numpy bins: the kernel's uint8 entry);
   the forest kernel's two entries against their twins on the path's own
   rows of each type and on rows of edge and special values (bit-equal;
   CUDA events and a CUDA graph), and the path once more with an SGNS model in
   the artifacts, so the kNN candidate route launches stage 1 and the
   peel: on the full catalog (phase 3's model, phase 7's tables and
   sessions), since a 20,000-aid table takes the dense route;
10. the file CLI, ``otto_tpu_torch.pipelines.main(argv)`` in this process
   with ``--device cuda`` (each step's seconds, the kernels' launches):
   10a phase 7's store written as a raw OTTO ``.jsonl`` (millisecond
   stamps) and as parquet, both read back (the native parser;
   ``EventStore.from_parquet``) equal to it, the parse's events/s;
   10b ``covisitation validation`` on the ``.jsonl``, its report equal to
   phase 7's field for field; 10c ``aid_weight submission`` on the
   parquet, the session vote launched, the file read back equal to
   ``run_aid_weight``'s lists, the writer's rows/s; 10d ``two_stage
   validation --ranker gbdt`` from a copy of ``artifacts/bench_e2e`` on
   phase 6's store cut to 20,000 sessions (10,000 target sessions): three
   float-row forest launches, recall, ``report_disjoint``, the stage
   seconds, sessions/s, and the saved lists equal to ``predict_two_stage``
   on the same train and target; 10e that command at 500 target
   sessions on the card and on the CPU, lists bit-equal (where they
   differ: every differing heuristic row a recency-route session, and the
   CPU path given the card's heuristic lists bit-equal to the card, the
   rows printed); 10f ``python -m otto_tpu_torch.pipelines aid_frequency
   submission --device cuda`` in a process of its own, exit 0 and a
   readable file;
11. GBDT training on the card (run in the order 11c, 11a, 11b, 11d: 11a and
   11b take the refit's rows): 11c the bench refit, ``run_two_stage_streamed``
   in training mode on phase 6's data with ``artifacts/BENCH_FIT_r05.json``'s
   settings (20,000 training sessions drawn with seed 23, bce, 150 trees, 3
   folds, early stop 50, ``min_data_in_leaf`` 200, selection seed 17) and
   the committed tables, streaming phase 9's 8,000 training-disjoint
   sessions; counters zeroed before and read after (the histogram kernel
   and the binning kernel launch, once a type; the histogram twin and numpy
   ``fit_bin_edges`` and ``bin_features`` are never called); the fits'
   seconds by function (upload, device edges, binning, tree growth, K5,
   OOF); best iterations and the lift with its paired bootstrap (1,000
   draws) held equal to the recorded refit to the printed digit, the ci95 above
   0 and overlapping the committed models'; the train-subsample report and
   the candidates' ceiling beside the JSON's; then each type's device edges
   held value-equal to numpy ``fit_bin_edges`` on the same rows; and the
   committed rankers resumed on the same training sessions, their fold
   average held to the JSON's train-subsample report and to the committed
   ``predictions.npz`` (that report is this in-sample one); 11a the
   histogram kernel against its twin at one tree's launches on the first
   clicks fold's rows (level 0, the root's row list; levels 1-6, the left
   children's stretches of the list as the tree's routing splits it):
   bit-equal on dyadic vals, bit-equal to the plain fixed-point reference
   on the fold's bce gradients and within 2^-20 of each column's sum of
   |vals| of the float64 twin, two launches bit-identical; its times (CUDA
   graph), the twin's, ``index_add_``'s, the list's split and the bound;
   then the binning kernel on the refit's clicks features against its
   twin and numpy (times of the kernel, the twin and ``torch.searchsorted``,
   and the bound); 11b one tree on dyadic grad/hess, card against the CPU
   twin, bit-equal; two 10-tree bce fits on the card bit-identical; a
   5-tree lambdarank fit (``configs/gbdt_lambdarank.yaml``, trees cut) and
   ``_lambdarank_gh`` on its scores, card within 1e-5 relative of the CPU;
   11d the CLI's ``two_stage validation --config <20 trees, 3 folds>`` on
   phase 6's store cut to 40,000 sessions into an empty directory (three
   rankers saved, the histogram and binning kernels launched), the same
   command resuming (neither launched; lists equal to ``predict_two_stage``
   with the saved artifacts), and ``two_stage_streamed validation
   --train-sessions 5000`` on its first 20,000 sessions (a lift printed).

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
    return {"build_s": build_s, "events": n_ev, "split": split, "store": store}


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
    store = synthetic_events_v2(n_sessions=n_sessions, n_aids=N_AIDS, seed=SEED)
    sp = split_by_fraction(store)
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
            "heur": heur, "aid_weight": runs["aid_weight"][0].predictions["clicks"],
            "store": store, "covisitation_report": runs["covisitation"][0].report}


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


def forest_bound(x, pack, edges=None) -> tuple[float, str]:
    """The forest pass's bound on these rows: the rows (uint8 bins, or
    float32 rows with ``edges``, the [F, 256] edges the kernel reads) and the
    model (its slices, as the kernel reads them) read once and the scores
    written once; or its operations at the int32 rate: one for each node step
    (rows x trees x depth), and for float rows 8 compares a value (the edge
    search)."""
    n, F = x.shape
    n_bytes = (x.numel() * x.element_size() + 4 * n + 4 * pack.model.numel()
               + 8 * pack.n_folds)
    ops = float(n) * pack.n_trees * pack.depth
    if edges is not None:
        n_bytes += edges.numel() * 4
        ops += 8.0 * n * F
    return bound(n_bytes, ops, INT32_OPS_PER_S)


def edge_rows(edges: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Float32 rows [n, F] against a model's ``edges`` [F, E]: lognormal
    values, with a third of the cells an edge value, the float above or below
    one, or a special value (NaN, +-inf, +-0.0, denormals, float32 max)."""
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
    return np.where(kind == 3, special[rng.integers(0, len(special), (n, F))], x)


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
    caller holds them to it).  On the card the path must make one launch of
    the float-row forest kernel a type and call the host binning
    (``bin_features``) not once.  Returns the path's launches, the forest
    pass's inputs (the float32 rows on the card and the model of each type,
    kept on their way into ``predict_rows``) and the evaluated sessions."""
    from otto_tpu_torch import EVENT_TYPES, streaming
    from otto_tpu_torch.eval.harness import evaluate_predictions, paired_bootstrap_lift
    from otto_tpu_torch.features import compute_aid_features
    from otto_tpu_torch.models import gbdt
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

    captured, host_binning = [], []
    real, real_bin = GBDTRankerModel.predict_rows, gbdt.bin_features

    def keep_inputs(self, x, stats=None):  # the path's own forest inputs, kept
        captured.append((x, self))
        return real(self, x, stats)

    def count_binning(*args):  # host binning calls on the path
        host_binning.append(1)
        return real_bin(*args)

    pstats: dict = {}
    GBDTRankerModel.predict_rows, gbdt.bin_features = keep_inputs, count_binning
    try:
        zero_counters()
        t0 = time.perf_counter()
        preds = predict_two_stage(artifacts, split.train, sub, n_aids, aid_feats=aid_feats,
                                  heuristic_preds=heur, chunk_sessions=512, stats_out=pstats,
                                  device=dev)
        sync(torch, dev)
        predict_s = time.perf_counter() - t0
        launches = read_counters("two-stage path", ("predict_forest_rows",))
    finally:
        GBDTRankerModel.predict_rows, gbdt.bin_features = real, real_bin
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
    print(f"host binning calls on the path: {len(host_binning)}", flush=True)
    check(len(captured) == 3 and not host_binning
          and (dev.type != "cuda" or launches["predict_forest_rows"] == 3),
          "the path did not make one float-row forest launch a type without host binning")
    forest_inputs = [(x, m) for x, m in captured]
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


def prebinned_path(torch, dev, replay: dict, zero_counters, read_counters) -> dict:
    """Phase 9: the uint8 entry of the forest kernel through its user entry
    point: the clicks rows of the replay binned by the host's numpy
    ``bin_features`` (``GBDTRankerModel.bin``, the JAX package's API) and
    scored by ``predict_binned_folds`` on the card, counters zeroed before
    and read after.  The host's bins must equal the card twin's binning of
    the same rows, and the scores the float-row kernel's.  Returns the
    launches."""
    from otto_tpu_torch.ops import forest

    x, model = replay["forest_inputs"][0]
    t0 = time.perf_counter()
    host_bins = model.bin(x.cpu().numpy())
    bin_s = time.perf_counter() - t0
    check(np.array_equal(host_bins, forest._bin_rows_reference(x, model.packed_edges(dev))
                         .cpu().numpy()), "numpy bin_features and the twin's binning differ")
    zero_counters()
    got = model.predict_binned_folds(host_bins, device=dev)
    sync(torch, dev)
    launches = read_counters("pre-binned scoring path", ("predict_forest",))
    want = model.predict_rows(x).cpu().numpy()
    check(np.array_equal(got.view(np.int32), want.view(np.int32)),
          "predict_binned_folds on numpy bins and the float-row kernel differ")
    print(f"pre-binned path, clicks [{x.shape[0]} x {x.shape[1]}]: numpy bin_features "
          f"{bin_s:.2f} s on the host, equal to the twin's binning on the card; "
          f"predict_binned_folds equal to the float-row kernel, bit for bit", flush=True)
    return launches


def forest_vs_twin(torch, dev, replay: dict) -> list[dict]:
    """Phase 9: the forest kernel against its twins on the path's own float32
    rows of each type: the float-row entry against the twin's binning
    (``torch.searchsorted``) and routing, the uint8 entry against the
    routing twin on the same rows binned, all bit-equal; then on rows of
    edge values and special values for each model.  Times (CUDA events over
    a loop of calls, and a CUDA graph: device time alone) of both entries,
    the twins, the twin's binning alone (``torch.searchsorted``, context for
    the kernel's staging) and the bounds.  Returns the records of both
    entries (at the clicks launch, the largest model)."""
    from otto_tpu_torch import EVENT_TYPES
    from otto_tpu_torch.ops import forest

    recs: dict = {}
    for etype, (x, model) in zip(EVENT_TYPES, replay["forest_inputs"]):
        pack, edges = model.packed(dev), model.packed_edges(dev)
        binned = forest._bin_rows_reference(x, edges)
        r = forest_twin(torch, binned, pack)
        k_rows, k_bins = forest.predict_forest_rows(x, edges, pack), forest.predict_forest(binned,
                                                                                          pack)
        sync(torch, dev)
        for name, k in (("float-row", k_rows), ("uint8", k_bins)):
            check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
                  f"forest kernel ({name} entry) {etype}: differs from its twin on the path's "
                  "rows")
        xe = torch.as_tensor(edge_rows(model.edges, 100_000, SEED + 20), device=dev)
        be = forest._bin_rows_reference(xe, edges)
        check(np.array_equal(be.cpu().numpy(), model.bin(xe.cpu().numpy())),
              f"{etype}: the twin's binning of edge rows differs from numpy bin_features")
        ke, re_ = forest.predict_forest_rows(xe, edges, pack), forest_twin(torch, be, pack)
        sync(torch, dev)
        check(torch.equal(ke.view(torch.int32), re_.view(torch.int32)),
              f"forest kernel (float-row entry) {etype}: differs from its twin on edge rows")
        err = max((k_rows - r).abs().max().item(), (ke - re_).abs().max().item())
        del xe, be, ke, re_
        calls = {"float-row": (lambda: forest.predict_forest_rows(x, edges, pack),
                               lambda: forest_twin(torch, forest._bin_rows_reference(x, edges),
                                                   pack), forest_bound(x, pack, edges)),
                 "uint8": (lambda: forest.predict_forest(binned, pack),
                           lambda: forest_twin(torch, binned, pack), forest_bound(binned, pack))}
        if dev.type == "cuda":
            search_ms = cuda_ms(torch, lambda: forest._bin_rows_reference(x, edges), 3)
        else:  # a rehearsal on the CPU
            search_ms = _host_ms(lambda: forest._bin_rows_reference(x, edges), 1)
        for name, (kernel, twin, b) in calls.items():
            if dev.type == "cuda":
                loop = cuda_ms(torch, kernel, 10)
                dev_ms = graph_ms(torch, [kernel])
                plain = cuda_ms(torch, twin, 1)
            else:
                loop = dev_ms = _host_ms(kernel, 1)
                plain = _host_ms(twin, 1)
            print(f"forest {etype} {name} entry [{x.shape[0]} x {x.shape[1]}], "
                  f"{pack.n_folds} folds, {pack.n_trees} trees of depth {pack.depth}: bit-equal "
                  f"to its twin (and on 100,000 edge-value rows); kernel {loop:.4f} ms (loop) / "
                  f"{dev_ms:.4f} ms (CUDA graph), twin {plain:.3f} ms; bound {b[0]:.4f} ms "
                  f"({b[1]}): {100 * b[0] / dev_ms:.1f}% of it", flush=True)
            rec = recs.get(name)
            if rec is None:
                recs[name] = {
                    "name": "predict_forest_rows" if name == "float-row" else "predict_forest",
                    "route": "cuda", "source": FOREST_SOURCE,
                    "replaces": ("otto_tpu/models/gbdt.py:334 (XLA, not Pallas) with the numpy "
                                 "bin_features of :80" if name == "float-row" else
                                 "otto_tpu/models/gbdt.py:334 (XLA, not Pallas)"),
                    "launches": 0, "max_abs_err": err, "ms": dev_ms, "plain_ms": plain,
                    "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
            recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], err)
        print(f"forest {etype}: the twin's binning alone (torch.searchsorted on the card, "
              f"context for the kernel's staging) {search_ms:.4f} ms", flush=True)
    return [recs["uint8"], recs["float-row"]]


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
                                 ("fused_stage1", "peel_rows", "predict_forest_rows"))
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


# ------------------------------------------------------------- phase 10
TYPE_NAMES = ("clicks", "carts", "orders")


def write_jsonl(store, path: Path) -> None:
    """``store`` as a raw OTTO ``.jsonl`` (one line a session, timestamps in
    milliseconds: the store's seconds times 1000 plus a deterministic
    0-999, which ``read_jsonl(ts_unit="ms")`` drops again)."""
    ms = store.ts.astype(np.int64) * 1000 + (np.arange(store.n_events) * 7919) % 1000
    aid, typ, off = store.aid.tolist(), store.type.tolist(), store.offsets.tolist()
    ms = ms.tolist()
    with open(path, "w") as f:
        for s, sid in enumerate(store.session_ids.tolist()):
            events = ", ".join(f'{{"aid": {aid[i]}, "ts": {ms[i]}, "type": "{TYPE_NAMES[typ[i]]}"}}'
                               for i in range(off[s], off[s + 1]))
            f.write(f'{{"session": {sid}, "events": [{events}]}}\n')


def same_store(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("session_ids", "offsets", "session_idx", "aid", "ts", "type"))


def head_sessions(store, n: int):
    keep = np.zeros(store.n_sessions, bool)
    keep[:n] = True
    return store.select_sessions(keep)


def submission_lists(sub: dict, session_ids) -> dict:
    """A read-back submission as [S, 20] int32 arrays in ``session_ids``'
    order."""
    out = {}
    for t in TYPE_NAMES:
        rows = [sub[t][int(s)] for s in session_ids]
        out[t] = np.full((len(rows), 20), -1, np.int32)
        for i, r in enumerate(rows):
            out[t][i, :len(r)] = r
    return out


def report_fields(r) -> dict:
    return {f: getattr(r, f) for f in ("clicks", "carts", "orders", "weighted",
                                       "corpus_weighted", "clicks_n", "carts_n", "orders_n")}


@contextlib.contextmanager
def wrapped(module, name: str, wrapper):
    """``module.name`` replaced by ``wrapper(original)`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, wrapper(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def cli_files(torch, dev, store, workdir: Path) -> dict:
    """Phase 10a: phase 7's store written as a raw OTTO ``.jsonl`` and as
    parquet, both read back (the native parser; ``EventStore.from_parquet``)
    and held equal to it."""
    from otto_tpu_torch.data.events import EventStore
    from otto_tpu_torch.data.ingest import read_jsonl

    jsonl, parquet = workdir / "events.jsonl", workdir / "events.parquet"
    t0 = time.perf_counter()
    write_jsonl(store, jsonl)
    write_s = time.perf_counter() - t0
    store.to_parquet(parquet)
    read_jsonl(jsonl)  # builds the native parser once, outside the timed parse
    t0 = time.perf_counter()
    from_jsonl = read_jsonl(jsonl)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_parquet = EventStore.from_parquet(parquet)
    parquet_s = time.perf_counter() - t0
    check(same_store(from_jsonl, store), "the .jsonl read back differs from the store")
    check(same_store(from_parquet, store), "the parquet read back differs from the store")
    mb = jsonl.stat().st_size / 1e6
    print(f"{store.n_sessions} sessions, {store.n_events} events: .jsonl {mb:.1f} MB written in "
          f"{write_s:.2f} s; read_jsonl (native) {parse_s:.3f} s ({store.n_events / parse_s:.0f} "
          f"events/s, {mb / parse_s:.0f} MB/s); from_parquet {parquet_s:.3f} s; both equal to "
          "the store", flush=True)
    return {"jsonl": jsonl, "parquet": parquet, "parse_s": parse_s,
            "events_per_s": store.n_events / parse_s}


def cli_covisitation(torch, dev, files: dict, phase7_report) -> None:
    """Phase 10b: ``covisitation validation`` on the ``.jsonl``; its defaults
    (``--val-fraction 0.1 --seed 42``) are ``split_by_fraction``'s, so its
    report equals phase 7's heuristic report field for field."""
    from otto_tpu_torch import pipelines

    t0 = time.perf_counter()
    res = pipelines.main(["covisitation", "validation", "--events", str(files["jsonl"]),
                          "--n-aids", str(N_AIDS), "--device", dev.type])
    secs = time.perf_counter() - t0
    got, want = report_fields(res.report), report_fields(phase7_report)
    print(f"CLI covisitation validation on the .jsonl: {secs:.2f} s; report {got}", flush=True)
    check(got == want, f"CLI covisitation report {got} differs from phase 7's {want}")
    print("its report equals phase 7's, field for field", flush=True)


def cli_aid_weight(torch, dev, files: dict, store, workdir: Path, zero_counters,
                   read_counters) -> dict:
    """Phase 10c: ``aid_weight submission`` on the parquet (counters zeroed
    before, read after: the session vote launches); the file read back
    equals ``run_aid_weight(store, None)``'s lists.  Returns the launches and
    the writer's rate."""
    from otto_tpu_torch import pipelines
    from otto_tpu_torch.data import submission

    out = workdir / "aid_weight.csv.gz"
    writes = []

    def timed(real):
        def write(*args, **kwargs):
            t = time.perf_counter()
            real(*args, **kwargs)
            writes.append(time.perf_counter() - t)
        return write

    with wrapped(submission, "write_submission", timed):
        zero_counters()
        t0 = time.perf_counter()
        pipelines.main(["aid_weight", "submission", "--events", str(files["parquet"]),
                        "--output", str(out), "--device", dev.type])
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read_counters("CLI aid_weight submission", ("aid_vote",))
    rows = 3 * store.n_sessions
    print(f"CLI aid_weight submission: {secs:.2f} s; write_submission (native) {writes[0]:.3f} "
          f"s for {rows} rows ({rows / writes[0]:.0f} rows/s, {out.stat().st_size / 1e6:.1f} "
          "MB)", flush=True)
    want = pipelines.run_aid_weight(store, None, device=dev).predictions
    got = submission_lists(submission.read_submission(out), store.session_ids)
    for t in TYPE_NAMES:
        check(np.array_equal(got[t], want[t]), f"CLI aid_weight submission {t}: the file "
              "differs from run_aid_weight's lists")
    print("read_submission of the file equals run_aid_weight(store, None)'s lists", flush=True)
    return {"launches": launches, "rows_per_s": rows / writes[0]}


def two_stage_argv(events: Path, adir: Path, device: str) -> list[str]:
    return ["two_stage", "validation", "--ranker", "gbdt", "--n-aids", "20000",
            "--val-fraction", "0.5", "--seed", "0", "--artifact-dir", str(adir),
            "--events", str(events), "--device", device]


def cli_two_stage(torch, dev, bench_store, workdir: Path, zero_counters, read_counters) -> dict:
    """Phase 10d: ``two_stage validation --ranker gbdt`` on phase 6's store
    cut to its first 20,000 sessions (10,000 target sessions), resuming
    from a copy of ``artifacts/bench_e2e``: counters zeroed before, read
    after (one float-row forest launch a type, no more); the lists it saves
    equal ``predict_two_stage`` on the same train and target with the
    artifacts loaded from the committed directory.  Returns the launches."""
    from otto_tpu_torch import pipelines, twostage
    from otto_tpu_torch.data.splits import split_by_fraction

    art = REPO / "artifacts" / "bench_e2e"
    store = head_sessions(bench_store, 20_000)
    events, adir = workdir / "bench_20k.parquet", workdir / "bench_e2e_10d"
    store.to_parquet(events)
    shutil.copytree(art, adir)
    stats: dict = {}
    runs = []

    def with_stats(real):  # the stage seconds, and the artifacts for report_disjoint
        def run(*args, **kwargs):
            runs.append(real(*args, stats_out=stats, **kwargs))
            return runs[-1]
        return run

    with wrapped(twostage, "run_two_stage", with_stats):
        zero_counters()
        t0 = time.perf_counter()
        res = pipelines.main(two_stage_argv(events, adir, dev.type))
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read_counters("CLI two_stage validation", ("predict_forest_rows",))
    check(dev.type != "cuda" or launches["predict_forest_rows"] == 3,
          f"CLI two_stage made {launches['predict_forest_rows']} float-row forest launches, not 3")
    sp = split_by_fraction(store, val_fraction=0.5, seed=0)
    S = sp.val_input.n_sessions
    disjoint = runs[0].report_disjoint
    print(f"CLI two_stage validation: {S} target sessions, {secs:.2f} s ({S / secs:.0f} "
          f"sessions/s); weighted recall@20 {res.report.weighted:.6f} (clicks "
          f"{res.report.clicks:.6f}, carts {res.report.carts:.6f}, orders "
          f"{res.report.orders:.6f}); report_disjoint ({int((~runs[0].selection_mask).sum())} "
          f"sessions) {report_fields(disjoint)}; stages (s): "
          + ", ".join(f"{k[:-2]} {v:.3f}" for k, v in stats.items()), flush=True)
    with np.load(adir / "predictions.npz") as z:
        saved = {t: z[t] for t in TYPE_NAMES}
    meta = json.loads((adir / "meta.json").read_text())
    print(f"saved meta.json max_recall {meta['max_recall']}", flush=True)
    t0 = time.perf_counter()
    want = twostage.predict_two_stage(two_stage_artifacts(), sp.train, sp.val_input, 20_000,
                                      device=dev)
    predict_s = time.perf_counter() - t0
    for t in TYPE_NAMES:
        differ = int((saved[t] != want[t]).any(axis=1).sum())
        check(np.array_equal(saved[t], res.predictions[t]), f"CLI two_stage {t}: saved lists "
              "differ from the returned ones")
        check(differ == 0, f"CLI two_stage {t}: {differ} sessions' saved lists differ from "
              "predict_two_stage's")
    print(f"the saved lists equal predict_two_stage's on the same train and target "
          f"({predict_s:.2f} s)", flush=True)
    return {"launches": launches, "sessions_per_s": S / secs}


def cli_card_vs_cpu(torch, dev, bench_store, workdir: Path) -> None:
    """Phase 10e: the same ``two_stage validation`` command at 500 target
    sessions with ``--device cuda`` and with ``--device cpu``.  The lists
    must be bit-equal.  On the CPU the heuristic takes the host float64
    routes and on the card the device routes, as the JAX package does on a
    CPU and on a TPU; the device recency route may order near-tied aids
    otherwise (ROADMAP §3).  So where the lists differ, each run's heuristic
    lists are compared: every differing heuristic row must be a
    recency-route session, and the CPU path given the card's heuristic lists
    must give the card's lists bit for bit; the rows and aids are printed."""
    from otto_tpu_torch import pipelines, twostage
    from otto_tpu_torch.data.splits import split_by_fraction
    from otto_tpu_torch.models.covisitation import session_unique_counts

    art = REPO / "artifacts" / "bench_e2e"
    store = head_sessions(bench_store, 1_000)
    events = workdir / "bench_1k.parquet"
    store.to_parquet(events)
    runs, heur = [], []  # the card's run, then the CPU's

    def keep(real):
        def lists(*args):
            heur.append(real(*args))
            return heur[-1]
        return lists

    for device in (dev.type, "cpu"):
        adir = workdir / f"bench_e2e_10e_{len(runs)}"
        shutil.copytree(art, adir)
        with wrapped(twostage, "_heuristic_lists", keep):
            t0 = time.perf_counter()
            runs.append(pipelines.main(two_stage_argv(events, adir, device)).predictions)
            print(f"CLI two_stage validation at 500 target sessions, --device {device}: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
    card, cpu = runs
    differ = {t: np.flatnonzero((card[t] != cpu[t]).any(axis=1)) for t in TYPE_NAMES}
    if not any(len(r) for r in differ.values()):
        print("card and CPU lists bit-equal", flush=True)
        return
    sp = split_by_fraction(store, val_fraction=0.5, seed=0)
    recency = session_unique_counts(sp.val_input) >= 20
    print(f"card and CPU lists differ in sessions {({t: r.tolist() for t, r in differ.items()})}",
          flush=True)
    for t in TYPE_NAMES:
        rows = np.flatnonzero((heur[0][t] != heur[1][t]).any(axis=1))
        for r in rows:
            print(f"  heuristic {t} session {r} (recency route {bool(recency[r])}): card "
                  f"{heur[0][t][r].tolist()} cpu {heur[1][t][r].tolist()}", flush=True)
        check(bool(recency[rows].all()), f"heuristic {t}: card and CPU differ on a "
              "covisitation-route session")
    adir = workdir / "bench_e2e_10e_cpu_given"
    shutil.copytree(art, adir)
    given = twostage.run_two_stage(sp.train, sp.val_input, 20_000, labels=sp.val_labels,
                                   artifact_dir=adir, heuristic_preds=heur[0],
                                   device="cpu").predictions
    for t in TYPE_NAMES:
        check(np.array_equal(given[t], card[t]), f"two_stage {t}: with the card's "
              "heuristic lists the CPU path differs from the card")
    print("cause: the heuristic's recency route differs by route in the sessions above (the "
          "card's device route sums float32 weights, the CPU's host route float64 ones, so "
          "near-tied aids may change places; models/heuristic_host.py's docstring); given the "
          "card's heuristic lists, the CPU path's lists equal the card's bit for bit",
          flush=True)


def cli_subprocess(torch, dev, bench_store, workdir: Path) -> None:
    """Phase 10f: ``python -m otto_tpu_torch.pipelines aid_frequency
    submission ... --device cuda`` in a process of its own: exit 0 and a
    readable file with a row a session and type."""
    from otto_tpu_torch.data import submission

    store = head_sessions(bench_store, 2_000)
    events, out = workdir / "bench_2k_sub.parquet", workdir / "aid_frequency.csv.gz"
    store.to_parquet(events)
    cmd = [sys.executable, "-m", "otto_tpu_torch.pipelines", "aid_frequency", "submission",
           "--events", str(events), "--n-aids", "20000", "--output", str(out),
           "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
    sub = submission.read_submission(out)
    check(all(len(sub[t]) == store.n_sessions for t in TYPE_NAMES)
          and set(sub["clicks"]) == set(store.session_ids.tolist()),
          "the subprocess's submission does not hold a row a session and type")
    print(f"python -m otto_tpu_torch.pipelines aid_frequency submission --device {dev.type}: exit 0 "
          f"in {secs:.2f} s; {out.stat().st_size / 1e6:.2f} MB, {3 * store.n_sessions} rows "
          f"read back; stdout {proc.stdout.strip()!r}", flush=True)


# ------------------------------------------------------------- phase 11
HIST_SOURCE = "otto_tpu_torch/csrc/hist_kernels.cu"
# The bench refit, as tools/stream_scale_run.py:149-152 builds its GBDTConfig
# for artifacts/BENCH_FIT_r05.json: 20,000 training sessions drawn with seed
# 23, bce, 150 trees, 3 folds, early stop 50, min_data_in_leaf 200,
# selection seed 17 (subsample and colsample at their 0.9 default).
REFIT_TRAIN_SESSIONS = 20_000
REFIT_STREAM_SESSIONS = 8_000  # phase 9's sessions: the first training-disjoint ones
# The refit as recorded on an H100 with the first histogram kernel (PERF.md
# §6; the same in every run): each type's fold best iterations, and the lift
# with its ci95, printed to six places.  The same bins and integer sums give
# the same forests, so every later kernel must reproduce them.
REFIT_RECORDED = {
    "best": {"clicks": [90, 90, 80], "carts": [30, 50, 60], "orders": [60, 140, 80]},
    "lift": ("+0.010251", ["0.007652", "0.013098"])}


def refit_config():
    from otto_tpu_torch.config import GBDTConfig

    return GBDTConfig(n_trees=150, n_folds=3, early_stopping_rounds=50, min_data_in_leaf=200,
                      loss="bce")


def refit(torch, dev, split, zero_counters, read_counters) -> dict:
    """Phase 11c: ``run_two_stage_streamed`` in training mode on phase 6's
    data with the bench refit's settings and the committed covisitation
    tables: the rankers fit on 20,000 target sessions, then the first 8,000
    training-disjoint sessions stream (phase 9's).  Counters zeroed before,
    read after: the histogram kernel launches and its twin is never called.
    The fits bin on the card: the binning kernel launches, and numpy
    ``fit_bin_edges`` and ``bin_features`` are never called; afterwards each
    type's device edges are held value-equal to numpy ``fit_bin_edges`` on
    the same rows.  Prints the stage seconds, the fits' seconds by function,
    each fold's best iteration beside the committed models', the
    train-subsample report beside ``BENCH_FIT_r05.json``'s, and the lift
    with its paired bootstrap (1,000 draws, seeded); holds the best
    iterations and the lift with its ci95 equal to the recorded refit (the same
    bins, and K5's integer sums, give the same forests), and the ci95 above
    0 and overlapping the committed models' interval on the same sessions
    (``BENCH_r05.json``).  Returns the first clicks fold's ``fit_gbdt``
    inputs (11a, 11b use them), a type's features with their edges (for
    ``bin_rows``'s times), and the launches."""
    from otto_tpu_torch import EVENT_TYPES, streaming, twostage
    from otto_tpu_torch.models import gbdt
    from otto_tpu_torch.ops import hist

    fit_ref = json.loads((REPO / "artifacts" / "BENCH_FIT_r05.json").read_text())
    committed = two_stage_artifacts()
    first_fold, twin_calls, stats = {}, [], {}

    def keep_first(real):  # the first fold's inputs (clicks, fold 0)
        def fit(*args, **kwargs):
            if not first_fold:
                first_fold.update(args=args, val=kwargs["val"])
            return real(*args, **kwargs)
        return fit

    def count_twin(real):
        def twin(*args):
            twin_calls.append(real.__name__)
            return real(*args)
        return twin

    trained = []

    def keep_data(real):  # each type's training data and the edges fitted on it
        def train(data, *args, **kwargs):
            out = real(data, *args, **kwargs)
            trained.append((data, out[0].edges))
            return out
        return train

    def with_stats(real):
        def run(*args, **kwargs):
            return real(*args, stats_out=stats, **kwargs)
        return run

    spent: dict = {}

    def timed(name):  # seconds spent in a function of the fit, the card drained after
        def wrapper(real):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = real(*args, **kwargs)
                sync(torch, dev)
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
                return out
            return call
        return wrapper

    with wrapped(gbdt, "fit_gbdt", keep_first), \
            wrapped(hist, "_build_histogram_reference", count_twin), \
            wrapped(gbdt, "fit_bin_edges", count_twin), \
            wrapped(gbdt, "bin_features", count_twin), \
            wrapped(streaming, "run_two_stage", with_stats), \
            wrapped(gbdt, "fit_bin_edges_rows", timed("edges")), \
            wrapped(gbdt, "bin_rows", timed("binning")), \
            wrapped(gbdt, "_grow_tree", timed("grow")), \
            wrapped(gbdt, "node_histograms", timed("histograms")), \
            wrapped(gbdt.GBDTForest, "predict_binned", timed("oof")), \
            wrapped(twostage, "train_gbdt_ranker", timed("train_gbdt_ranker")), \
            wrapped(twostage, "train_gbdt_ranker", keep_data):
        zero_counters()
        t0 = time.perf_counter()
        res = streaming.run_two_stage_streamed(
            split.train, split.val_input, 20_000, labels=split.val_labels,
            ranker_config=refit_config(), train_sessions=REFIT_TRAIN_SESSIONS,
            shard_sessions=30_000, selection_seed=17, train_subset_seed=23, chunk_sessions=512,
            matrices=committed.matrices, n_boot=1000, max_stream_sessions=REFIT_STREAM_SESSIONS,
            device=dev)
        sync(torch, dev)
        secs = time.perf_counter() - t0
        launches = read_counters("bench refit", ("node_histograms", "bin_rows",
                                                 "predict_forest", "predict_forest_rows"))
    check(not twin_calls, f"the refit called host or twin routes: {sorted(set(twin_calls))} "
          f"({len(twin_calls)} calls)")
    check(launches["bin_rows"] == len(trained) == 3, f"{launches['bin_rows']} binning launches "
          f"for {len(trained)} trained rankers")
    tm = res.timings
    trees = launches["node_histograms"] / refit_config().max_depth
    print(f"run_two_stage_streamed, training mode: {secs:.2f} s; train_s {tm['train_s']} "
          f"({tm['train_sessions']} sessions), stream_s {tm['stream_s']} "
          f"({tm['streamed_sessions']} sessions), global_features_s "
          f"{tm['global_features_s']}; {launches['node_histograms']} histogram launches = "
          f"{trees:.0f} trees grown ({1e3 * stats['train_s'] / max(trees, 1):.1f} ms a tree, "
          f"all of the fit included); run_two_stage stages (s): "
          + ", ".join(f"{k[:-2]} {v:.3f}" for k, v in stats.items()), flush=True)
    rest = spent["train_gbdt_ranker"] - sum(spent[k] for k in ("edges", "binning", "grow", "oof"))
    print(f"the fits (s; each timed call drains the card): train_gbdt_ranker "
          f"{spent['train_gbdt_ranker']:.3f} = upload, edges (fit_bin_edges_rows) "
          f"{spent['edges']:.3f} + binning (bin_rows) {spent['binning']:.3f} + grow "
          f"{spent['grow']:.3f} (of it K5's wrapper {spent['histograms']:.3f}) + OOF "
          f"{spent['oof']:.3f} + the rest (the upload, fold indexing; in fit_gbdt the "
          f"padded copy, gradients, bags, validation routing, MAP@20, reads) {rest:.3f}",
          flush=True)
    for t in EVENT_TYPES:
        got = [f.best_iteration for f in res.artifacts.rankers[t].forests]
        want = [f.best_iteration for f in committed.rankers[t].forests]
        print(f"  {t}: fold best iterations {got} (committed models {want}; the recorded refit "
              f"{REFIT_RECORDED['best'][t]}); fold recalls "
              f"{[round(r, 6) for r in res.artifacts.rankers[t].fold_recalls]}; alpha "
              f"{res.artifacts.rankers[t].prior_alpha}", flush=True)
        check(got == REFIT_RECORDED["best"][t], f"{t}: best iterations {got} differ from the "
              f"recorded refit {REFIT_RECORDED['best'][t]}")
    sub = res.artifacts.report.weighted
    print(f"train-subsample report: weighted {sub:.6f} (BENCH_FIT_r05.json "
          f"{fit_ref['train_subsample_report']['weighted']:.6f}); disjoint half "
          f"{res.artifacts.report_disjoint.weighted:.6f} "
          f"({fit_ref['train_subsample_report_disjoint']['weighted']:.6f}); the candidates' "
          f"ceiling on the training sessions {json.dumps(res.artifacts.max_recall)} "
          f"(BENCH_FIT_r05.json {json.dumps(fit_ref['max_recall_train_subsample'])})",
          flush=True)
    boot = res.bootstrap_vs_heuristic
    want_ci = REPLAY_EXPECTED["bootstrap"]["ci95"]
    print(f"streamed {tm['streamed_sessions']} sessions: weighted {res.report.weighted:.6f}, "
          f"heuristic {res.heuristic_report.weighted:.6f}, lift {res.lift_vs_heuristic:+.6f}; "
          f"paired bootstrap {json.dumps(boot)}; the committed models on the same sessions: "
          f"lift {REPLAY_EXPECTED['bootstrap']['lift']}, ci95 {want_ci} (BENCH_r05.json)",
          flush=True)
    check(tm["streamed_sessions"] == REFIT_STREAM_SESSIONS and boot["n_boot"] == 1000,
          "the refit did not stream phase 9's sessions with 1,000 bootstrap draws")
    lift = (f"{res.lift_vs_heuristic:+.6f}", [f"{c:.6f}" for c in boot["ci95"]])
    check(lift == REFIT_RECORDED["lift"], f"refit lift and ci95 {lift} differ from the "
          f"recorded refit's {REFIT_RECORDED['lift']}")
    check(boot["ci95"][0] > 0, f"refit lift ci95 {boot['ci95']} does not lie above 0")
    check(boot["ci95"][0] <= want_ci[1] and want_ci[0] <= boot["ci95"][1],
          f"refit lift ci95 {boot['ci95']} does not overlap the committed models' {want_ci}")
    for data, edges in trained:  # the device edges against numpy's on the same rows
        t0 = time.perf_counter()
        want = gbdt.fit_bin_edges(data.features[data.mask], refit_config().n_bins)
        check(np.array_equal(edges, want), "the device edges differ from numpy fit_bin_edges "
              f"on the refit's {data.features.shape} features")
        print(f"device edges of {data.features.shape} features ({int(data.mask.sum())} masked "
              f"rows): value-equal to numpy fit_bin_edges ({time.perf_counter() - t0:.2f} s on "
              f"the host; {int((np.signbit(edges) != np.signbit(want)).sum())} edges differ in "
              f"the sign of a zero)", flush=True)
    return {"launches": launches, "fold": first_fold, "train_s": tm["train_s"],
            "stream_s": tm["stream_s"], "lift": boot, "trees": trees, "spent": spent,
            "typed": trained[0]}


def resumed_train_report(torch, dev, split) -> dict:
    """Phase 11c: the committed rankers resumed on the refit's 20,000
    training sessions (seed 23), as ``BENCH_FIT_r05.json``'s run resumed
    them from its ``artifact_dir`` (``artifacts/bench_e2e``): their fold
    average on the sessions they were trained on, the heuristic on the host
    routes.  Held to the JSON's ``train_subsample_report`` per type and to
    the committed ``predictions.npz`` (that run's lists) in every session:
    the JSON's report is this in-sample one, a training run's (11c's) the
    out-of-fold one."""
    from otto_tpu_torch import EVENT_TYPES, streaming
    from otto_tpu_torch.eval.harness import evaluate_predictions
    from otto_tpu_torch.models.covisitation import covisit_heuristic_predictions
    from otto_tpu_torch.models.frequency import FrequencyStatistics
    from otto_tpu_torch.twostage import predict_two_stage

    art = REPO / "artifacts" / "bench_e2e"
    fit = json.loads((art / "bench_fit.json").read_text())
    want = json.loads((REPO / "artifacts" / "BENCH_FIT_r05.json").read_text())
    S = split.val_input.n_sessions
    idx = streaming.train_subset_indices(S, fit["train_sessions"], fit["train_subset_seed"])
    keep = np.zeros(S, bool)
    keep[idx] = True
    sub = split.val_input.select_sessions(keep)
    artifacts = two_stage_artifacts()
    with np.load(art / "aid_feats.npz") as z:
        aid_feats = {k: z[k] for k in z.files}
    t0 = time.perf_counter()
    stats = FrequencyStatistics.compute(split.train, n_aids=fit["aids"], device=dev)
    heur = covisit_heuristic_predictions(
        sub, artifacts.matrices, {t: stats.top_by_type[t] for t in EVENT_TYPES},
        chunk_sessions=512, recency_host_f64=True, covisit_host=True, device=dev)
    preds = predict_two_stage(artifacts, split.train, sub, fit["aids"], aid_feats=aid_feats,
                              heuristic_preds=heur, chunk_sessions=512, device=dev)
    rep = evaluate_predictions(split.val_labels.take(idx), preds["clicks"], preds["carts"],
                               preds["orders"], device="cpu")
    with np.load(art / "predictions.npz") as z:
        same = {t: int((preds[t] == z[t]).all(axis=1).sum()) for t in EVENT_TYPES}
    got = {t: round(getattr(rep, t), 6) for t in EVENT_TYPES}
    ref = {t: round(want["train_subsample_report"][t], 6) for t in EVENT_TYPES}
    print(f"the committed rankers resumed on the refit's {len(idx)} training sessions "
          f"({time.perf_counter() - t0:.2f} s): weighted {rep.weighted:.6f}, {got} "
          f"(BENCH_FIT_r05.json's train-subsample report {ref}); sessions whose lists equal "
          f"the committed predictions.npz: {same}", flush=True)
    check(got == ref, f"the resumed fold average on the training sessions {got} differs from "
          f"BENCH_FIT_r05.json's train-subsample report {ref}")
    check(all(v == len(idx) for v in same.values()),
          f"the resumed lists differ from artifacts/bench_e2e/predictions.npz: {same}")
    return {"weighted": rep.weighted}


def hist_bound(listed: int, n_keys: int, n_feat: int, n_bins: int) -> tuple[float, str]:
    """The histogram's bound on these inputs: each listed row's id (4 bytes),
    vals (12) and bins (one a feature) read once, the float32 histogram
    written once; or its adds (three a listed row and feature) at the float32
    rate."""
    n_bytes = listed * (4 + 12 + n_feat) + 12 * n_keys * n_feat * n_bins
    return bound(n_bytes, 3.0 * listed * n_feat, F32_OPS_PER_S)


def fold_gradients(torch, dev, fold: dict):
    """The first fold's rows on ``dev`` and the gradients of its first
    tree: bce at the boost-from-average base, times the keep weights."""
    from otto_tpu_torch.models import gbdt

    binned, labels, mask, weight, cfg = fold["args"][:5]
    S, C, F = binned.shape
    x = binned.reshape(S * C, F).to(dev)
    p0 = min(max(float((labels * weight).sum()) / max(float(weight.sum()), 1.0), 1e-6), 1 - 1e-6)
    w = torch.as_tensor(weight.reshape(-1), device=dev)
    g, h = gbdt._bce_gh(torch.full((S, C), float(np.log(p0 / (1 - p0))), device=dev),
                        torch.as_tensor(labels, device=dev),
                        torch.as_tensor(weight > 0, device=dev))
    return x, g.reshape(-1) * w, h.reshape(-1) * w, w


def hist_vs_twin(torch, dev, fold: dict) -> dict:
    """Phase 11a: the histogram kernel against its twin on the first clicks
    fold's binned training rows, at the launches of one tree of the fit
    (level 0, the root's row list; levels 1-6, the left children's stretches
    of the list as the tree's own routing splits it), with the fold's bce
    gradients, a bag and the keep weights as the tree hands them over: on
    dyadic vals (k/256) bit-equal to the twin, on the real vals bit-equal to
    the plain fixed-point reference (the kernel's scale rule) and within
    2^-20 of each column's sum of |vals| of the float64 twin, two launches
    bit-identical.  Times (CUDA graph: device time alone) of the kernel (its
    wrapper: the int64 sums and the float32 finish), the twin, ``index_add_``
    in float32 of the listed rows' entries at their flat keys (the one
    PyTorch call that computes the function; timed, used nowhere), the row
    list's split after each level
    (``_split_rows``, torch) and the bound.  Returns the record of the level-0
    launch with the largest error over all levels."""
    from otto_tpu_torch.models import gbdt
    from otto_tpu_torch.ops import hist

    cfg = fold["args"][4]
    x, g, h, w = fold_gradients(torch, dev, fold)
    n, F = x.shape
    gen = torch.Generator().manual_seed(cfg.seed)
    bag = (torch.rand(n, generator=gen) < cfg.subsample).to(device=dev, dtype=torch.float32)
    launches, splits = [], []

    def keep(real):
        def build(*args):
            launches.append(args)
            return real(*args)
        return build

    def keep_split(real):
        def split(*args):
            splits.append(args)
            return real(*args)
        return split

    with wrapped(gbdt, "node_histograms", keep), wrapped(gbdt, "_split_rows", keep_split):
        gbdt._grow_tree(x, g, h, w, bag, torch.ones(F, dtype=torch.bool, device=dev),
                        cfg.reg_lambda, cfg.min_split_gain, cfg.min_data_in_leaf,
                        cfg.min_child_weight, cfg.learning_rate, depth=cfg.max_depth,
                        n_bins=cfg.n_bins)
    print(f"the first clicks fold: {n} rows x {F} features, {cfg.n_bins} bins; one tree's "
          f"{len(launches)} launches", flush=True)
    g_dy = torch.Generator(device=dev).manual_seed(SEED + 11)
    rec, totals = None, np.zeros(5)
    for level, (rows, n_feat, vals, vmax, order, start, pre, n_bins) in enumerate(launches):
        n_keys, listed = start.shape[0], int(pre[-1])
        key = hist.list_keys(order, start, pre, n)
        dyadic = torch.randint(-255, 256, (n, 3), generator=g_dy, device=dev).float() / 256
        for kind, v in (("dyadic", dyadic), ("real", vals)):
            args = (rows, n_feat, v, v.abs().amax(dim=0), order, start, pre, n_bins)
            a = hist.node_histograms(*args)
            b = hist.node_histograms(*args)
            want = hist._build_histogram_reference(x, key, v, n_keys, n_bins)
            sync(torch, dev)
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  f"histogram level {level} ({kind}): two launches differ")
            if kind == "dyadic":
                check(torch.equal(a, want), f"histogram level {level}: differs from its twin "
                      "on dyadic vals")
            else:
                fixed = hist._fixed_point_histogram(x, key, v, n_keys, n_bins)
                check(torch.equal(a.view(torch.int32), fixed.view(torch.int32)),
                      f"histogram level {level}: differs from the fixed-point reference")
                tol = 2.0 ** -20 * v.abs().sum(dim=0)
                err = (a - want).abs()
                check(bool((err <= tol).all()), f"histogram level {level}: off its twin by "
                      f"{err.amax(dim=(0, 1, 2)).tolist()} > {tol.tolist()}")
                max_err = float(err.max())
                del fixed
        del dyadic, a, b, want
        # index_add_ over the listed rows' (row, feature) entries, the flat
        # keys and vals made before it is timed
        size = n_keys * F * n_bins
        on = torch.nonzero((key >= 0) & (key < n_keys))[:, 0]
        flat = ((key[on].long()[:, None] * F + torch.arange(F, device=dev)) * n_bins
                + x[on].long()).reshape(-1)
        flat_vals = vals[on][:, None, :].expand(-1, F, 3).reshape(-1, 3).contiguous()
        lib_out = torch.zeros((size, 3), device=dev)
        launch = (rows, n_feat, vals, vmax, order, start, pre, n_bins)
        if dev.type == "cuda":
            ms = graph_ms(torch, [lambda: hist.node_histograms(*launch)])
            plain = cuda_ms(torch, lambda: hist._build_histogram_reference(x, key, vals,
                                                                           n_keys, n_bins), 2)
            lib = cuda_ms(torch, lambda: lib_out.zero_().index_add_(0, flat, flat_vals), 3)
            split_ms = (graph_ms(torch, [lambda: gbdt._split_rows(*splits[level])])
                        if level < len(splits) else 0.0)
        else:  # a rehearsal on the CPU
            ms = plain = _host_ms(lambda: hist.node_histograms(*launch), 1)
            lib = _host_ms(lambda: lib_out.zero_().index_add_(0, flat, flat_vals), 1)
            split_ms = (_host_ms(lambda: gbdt._split_rows(*splits[level]), 1)
                        if level < len(splits) else 0.0)
        del on, flat, flat_vals, lib_out
        b_ms, b_by = hist_bound(listed, n_keys, F, n_bins)
        totals += (ms, plain, lib, b_ms, split_ms)
        print(f"  level {level}: {n_keys} keys, {listed} listed rows: bit-equal on dyadic vals "
              f"and to the fixed-point reference, deterministic, largest error against the "
              f"float64 twin on the real vals {max_err:.3e}; kernel {ms:.4f} ms (CUDA graph), "
              f"twin {plain:.3f} ms, index_add_ float32 {lib:.3f} ms; bound {b_ms:.4f} ms "
              f"({b_by}: 16 + {F} bytes a listed row, 12 a cell out; 3 float32 adds a listed "
              f"row and feature at 67e12/s): {100 * b_ms / ms:.1f}% of it; the list's split "
              f"after the level {split_ms:.4f} ms", flush=True)
        if rec is None:
            rec = {"name": "node_histograms", "route": "cuda", "source": HIST_SOURCE,
                   "replaces": "otto_tpu/models/gbdt.py:109 (_mm_hist) and :233-266 (the "
                               "scatter branch); XLA, not Pallas",
                   "launches": 0, "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        rec["max_abs_err"] = max(rec["max_abs_err"], max_err)
    print(f"one tree's {len(launches)} launches: kernel {totals[0]:.3f} ms, twin "
          f"{totals[1]:.3f} ms, index_add_ {totals[2]:.3f} ms, bound {totals[3]:.4f} ms "
          f"({100 * totals[3] / totals[0]:.1f}%); the list's {len(splits)} splits "
          f"{totals[4]:.3f} ms", flush=True)
    rec["tree_ms"], rec["tree_bound_ms"] = float(totals[0]), float(totals[3])
    return rec


def bin_rows_vs_twin(torch, dev, typed) -> dict:
    """Phase 11a: the binning kernel on the refit's clicks features (the
    float32 rows of every candidate of 20,000 sessions) against its edges:
    bit-equal to its twin, and to numpy ``bin_features`` on the first
    200,000 rows; times (CUDA graph) of the kernel, the twin and
    ``torch.searchsorted`` over the transposed rows (the one PyTorch call
    near the function: it leaves out NaN -> 0, the + 1 and the transposes;
    timed, used nowhere), and the bound."""
    from otto_tpu_torch.models import gbdt
    from otto_tpu_torch.ops import forest

    data, edges = typed
    S, C, F = data.features.shape
    x = torch.as_tensor(data.features.reshape(S * C, F), device=dev)
    packed = forest.pack_edges(edges, device=dev)
    got = forest.bin_rows(x, packed)
    want = forest._bin_rows_reference(x, packed)
    sync(torch, dev)
    check(torch.equal(got, want), "bin_rows differs from its twin on the refit's features")
    head = data.features.reshape(S * C, F)[:200_000]
    check(np.array_equal(got[:200_000].cpu().numpy(), gbdt.bin_features(head, edges)),
          "bin_rows differs from numpy bin_features on the refit's features")
    xt = x.T.contiguous()
    if dev.type == "cuda":
        ms = graph_ms(torch, [lambda: forest.bin_rows(x, packed)])
        plain = cuda_ms(torch, lambda: forest._bin_rows_reference(x, packed), 3)
        lib = cuda_ms(torch, lambda: torch.searchsorted(packed, xt), 3)
    else:  # a rehearsal on the CPU
        ms = plain = _host_ms(lambda: forest.bin_rows(x, packed), 1)
        lib = _host_ms(lambda: torch.searchsorted(packed, xt), 1)
    b_ms, b_by = bound(5.0 * x.numel() + packed.numel() * 4, 9.0 * x.numel(), F32_OPS_PER_S)
    print(f"bin_rows on the refit's clicks features [{S * C} x {F}]: bit-equal to its twin "
          f"and to numpy bin_features; kernel {ms:.4f} ms (CUDA graph), twin {plain:.3f} ms, "
          f"torch.searchsorted {lib:.3f} ms; bound {b_ms:.4f} ms ({b_by}: 4 bytes in and 1 "
          f"out a value; 8 compares and a NaN test a value at 67e12/s): "
          f"{100 * b_ms / ms:.1f}% of it", flush=True)
    return {"name": "bin_rows", "route": "cuda", "source": FOREST_SOURCE,
            "replaces": "otto_tpu/models/gbdt.py:80 (bin_features, host numpy; not Pallas)",
            "launches": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib}


def fits_card_vs_cpu(torch, dev, fold: dict) -> None:
    """Phase 11b: on the first clicks fold's rows, one tree on dyadic
    grad/hess (k/1024, |k| <= 7: every histogram cell and cumulative sum is
    exact in float32, so the card and the CPU sum the same numbers):
    ``_grow_tree`` on the card equals the CPU twin's in features,
    thresholds, leaf ids and leaves, bit for bit; a 10-tree bce fit run
    twice on the card gives the same forest; a 5-tree lambdarank fit
    (``configs/gbdt_lambdarank.yaml``, ``n_trees`` cut) at the fold's full
    width, and ``_lambdarank_gh`` on its scores on the card within 1e-5
    relative of the CPU twin."""
    from otto_tpu_torch.config import GBDTConfig
    from otto_tpu_torch.models import gbdt

    rows, labels, mask, weight, cfg = fold["args"][:5]  # the fold's bins, on the card
    binned = rows.cpu().numpy()
    S, C, F = binned.shape
    rng = np.random.default_rng(SEED + 12)
    n = S * C
    host = [binned.reshape(n, F), (rng.integers(-7, 8, n) / 1024).astype(np.float32),
            (rng.integers(1, 8, n) / 1024).astype(np.float32), weight.reshape(n),
            np.ones(n, np.float32), np.ones(F, bool)]
    scalars = (cfg.reg_lambda, cfg.min_split_gain, cfg.min_data_in_leaf, cfg.min_child_weight,
               cfg.learning_rate)
    kw = dict(depth=cfg.max_depth, n_bins=cfg.n_bins)
    t0 = time.perf_counter()
    card = gbdt._grow_tree(*(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                             for a in host), *scalars, **kw)
    sync(torch, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = gbdt._grow_tree(*(torch.as_tensor(np.ascontiguousarray(a)) for a in host), *scalars,
                          **kw)
    cpu_s = time.perf_counter() - t0
    for name, a, b in zip(("feat", "thr", "leaf", "gain", "leaf id"), card, cpu):
        check(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)),
              f"_grow_tree on dyadic grad/hess: {name} differs between the card and the CPU")
    splits = int((card[1] < cfg.n_bins).sum())
    print(f"_grow_tree on dyadic grad/hess, [{n} x {F}]: card {card_s:.2f} s, CPU twin "
          f"{cpu_s:.2f} s; features, thresholds, leaves, gains and leaf ids bit-equal "
          f"({splits} of {len(card[1])} nodes split)", flush=True)

    val = fold["val"]
    short = GBDTConfig(**{**vars(cfg), "n_trees": 10})
    t0 = time.perf_counter()
    fits = [gbdt.fit_gbdt(rows, labels, mask, weight, short, val=val, device=dev)
            for _ in range(2)]
    fit_s = (time.perf_counter() - t0) / 2
    for name in ("feat", "thr", "leaf", "gain_importance", "split_importance"):
        a, b = getattr(fits[0], name), getattr(fits[1], name)
        check(a.shape == b.shape and a.tobytes() == b.tobytes(),
              f"two 10-tree bce fits on the card differ in {name}")
    print(f"two 10-tree bce fits on the card ({fit_s:.2f} s each): the same forest, bit for "
          f"bit (best iteration {fits[0].best_iteration})", flush=True)

    lcfg = GBDTConfig.from_yaml(REPO / "configs" / "gbdt_lambdarank.yaml")
    lcfg = GBDTConfig(**{**vars(lcfg), "n_trees": 5})
    t0 = time.perf_counter()
    lam = gbdt.fit_gbdt(rows, labels, mask, weight, lcfg, val=val, device=dev)
    lam_s = time.perf_counter() - t0
    scores = lam.predict_binned(rows.reshape(n, F), device=dev).reshape(S, C)
    keep = weight > 0
    on = [torch.as_tensor(a, device=dev) for a in (scores, labels, keep)]
    t0 = time.perf_counter()
    g_card, h_card = gbdt._lambdarank_gh(*on, k=lcfg.lambdarank_k, chunk=lcfg.chunk_sessions)
    sync(torch, dev)
    lr_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_cpu, h_cpu = gbdt._lambdarank_gh(*(torch.as_tensor(a) for a in (scores, labels, keep)),
                                       k=lcfg.lambdarank_k, chunk=lcfg.chunk_sessions)
    lr_cpu_s = time.perf_counter() - t0
    worst = 0.0
    for a, b in ((g_card.cpu(), g_cpu), (h_card.cpu(), h_cpu)):
        scale = float(b.abs().max())
        check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5 * scale)),
              "_lambdarank_gh on the card is not within 1e-5 relative of the CPU twin")
        worst = max(worst, float((a - b).abs().max()) / scale)
    print(f"5-tree lambdarank fit at [{S} sessions x {C} x {F}]: {lam_s:.2f} s; "
          f"_lambdarank_gh on its scores: card {lr_card_s:.2f} s, CPU {lr_cpu_s:.2f} s, "
          f"largest difference {worst:.2e} of the largest |value|", flush=True)


def cli_train(torch, dev, bench_store, workdir: Path, zero_counters, read_counters) -> dict:
    """Phase 11d: ``two_stage validation --ranker gbdt --config <20 trees, 3
    folds, min_data_in_leaf 200, bce>`` on phase 6's store cut to 40,000
    sessions into an empty ``--artifact-dir``: three rankers written, the
    histogram kernel launched.  The same command again resumes: no
    histogram launch, and its lists equal ``predict_two_stage`` with the
    saved artifacts on the same split (the training run's own lists rank
    out-of-fold scores, the resumed run's the fold average, in both
    packages: the sessions where they differ are counted).  Then
    ``two_stage_streamed validation --train-sessions 5000`` on the store's
    first 20,000 sessions (the streamed count cut to 5,000): exit 0, a lift
    printed.  Returns the launches."""
    import io

    from otto_tpu_torch import pipelines, twostage
    from otto_tpu_torch.data.splits import split_by_fraction

    store = head_sessions(bench_store, 40_000)
    events, adir, cfg = (workdir / "bench_40k.parquet", workdir / "trained",
                         workdir / "gbdt_20.yaml")
    store.to_parquet(events)
    cfg.write_text("n_trees: 20\nn_folds: 3\nmin_data_in_leaf: 200\nloss: bce\n")
    common = ["--ranker", "gbdt", "--config", str(cfg), "--n-aids", "20000", "--val-fraction",
              "0.5", "--seed", "0", "--device", dev.type]
    argv = ["two_stage", "validation", "--artifact-dir", str(adir), "--events", str(events),
            *common]
    zero_counters()
    t0 = time.perf_counter()
    first = pipelines.main(argv)
    sync(torch, dev)
    train_s = time.perf_counter() - t0
    trained = read_counters("CLI two_stage validation, training", ("node_histograms",
                                                                    "bin_rows"))
    saved = sorted(p.name for p in adir.glob("ranker_*.npz"))
    check(saved == [f"ranker_{t}.npz" for t in sorted(TYPE_NAMES)],
          f"the training run saved {saved}")
    zero_counters()
    t0 = time.perf_counter()
    second = pipelines.main(argv)
    sync(torch, dev)
    resume_s = time.perf_counter() - t0
    resumed = read_counters("CLI two_stage validation, resumed", ("predict_forest_rows",))
    check(resumed["node_histograms"] == resumed["bin_rows"] == 0,
          "the resumed run launched the histogram or the binning kernel")
    sp = split_by_fraction(store, val_fraction=0.5, seed=0)
    want = twostage.predict_two_stage(twostage.TwoStageArtifacts.load(adir, device=dev),
                                      sp.train, sp.val_input, 20_000, device=dev)
    for t in TYPE_NAMES:
        check(np.array_equal(second.predictions[t], want[t]), f"the resumed CLI run's {t} "
              "lists differ from predict_two_stage's with the saved artifacts")
    differ = {t: int((first.predictions[t] != second.predictions[t]).any(axis=1).sum())
              for t in TYPE_NAMES}
    print(f"CLI two_stage validation, {sp.val_input.n_sessions} target sessions: training run "
          f"{train_s:.2f} s (weighted {first.report.weighted:.6f}), resumed {resume_s:.2f} s "
          f"(weighted {second.report.weighted:.6f}); the resumed lists equal predict_two_stage "
          f"with the saved artifacts; sessions whose lists differ between the training run "
          f"(out-of-fold scores) and the resumed one (fold average): {differ}", flush=True)
    # the streamed run on the store's first 20,000 sessions: 5,000 of its
    # 10,000 target sessions train, 5,000 stream
    small = workdir / "bench_20k.parquet"
    head_sessions(store, 20_000).to_parquet(small)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        streamed = pipelines.main(["two_stage_streamed", "validation", "--train-sessions",
                                   "5000", "--events", str(small), *common])
    streamed_s = time.perf_counter() - t0
    lift = [line for line in out.getvalue().splitlines() if line.startswith("lift vs heuristic")]
    check(len(lift) == 1 and 0 < streamed.report.weighted <= 1,
          "two_stage_streamed validation printed no lift")
    print(f"CLI two_stage_streamed validation --train-sessions 5000 on 20,000 sessions "
          f"(5,000 stream): {streamed_s:.2f} s; "
          f"{lift[0]}; weighted {streamed.report.weighted:.6f}", flush=True)
    return {"launches": trained, "resumed": resumed}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    from otto_tpu_torch.ops import _kernels, forest, fused_retrieval, fused_sessions, hist, row_topk

    # each kernel's launch counter: (the wrapper, its attribute)
    counters = {"fused_stage1": (fused_retrieval.fused_stage1, "launches"),
                "fused_stage1_fma": (fused_retrieval.fused_stage1, "fma_launches"),
                "peel_rows": (row_topk.peel_rows, "launches"),
                "aid_vote": (fused_sessions.aid_vote_aggregate, "launches"),
                "predict_forest": (forest.predict_forest, "launches"),
                "predict_forest_rows": (forest.predict_forest_rows, "launches"),
                "bin_rows": (forest.bin_rows, "launches"),
                "node_histograms": (hist.node_histograms, "launches")}

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
        built = covisit_build(torch, dev)
    bench_split, bench_store = built["split"], built["store"]
    del built

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
    with phase("9 pre-binned scoring (the forest kernel's uint8 entry)"):
        prebinned = prebinned_path(torch, dev, replay, zero_counters, read_counters)
    with phase("9 forest kernel vs its twins on the path's rows"):
        records.extend(forest_vs_twin(torch, dev, replay))
    check(replay["replay"] == REPLAY_EXPECTED, f"two-stage replay {replay['replay']} differs "
          f"from BENCH_r05.json's {REPLAY_EXPECTED}")
    del replay
    with phase("9 two-stage with an SGNS model on the full catalog (the kNN candidate route)"):
        two_stage_sgns = two_stage_knn(torch, dev, model, path, 2000, zero_counters,
                                       read_counters)
    phase7_store, phase7_report = path["store"], path["covisitation_report"]
    del model, path

    workdir = REPO / "tmp" / "chip_smoke_cli"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        with phase("10a the file CLI: raw .jsonl and parquet of phase 7's store"):
            files = cli_files(torch, dev, phase7_store, workdir)
        with phase("10b CLI covisitation validation on the .jsonl"):
            cli_covisitation(torch, dev, files, phase7_report)
        with phase("10c CLI aid_weight submission on the parquet"):
            cli_aid_weight_run = cli_aid_weight(torch, dev, files, phase7_store, workdir,
                                                zero_counters, read_counters)
        del phase7_store
        with phase("10d CLI two_stage validation from a copy of artifacts/bench_e2e"):
            cli_two_stage_run = cli_two_stage(torch, dev, bench_store, workdir, zero_counters,
                                              read_counters)
        with phase("10e CLI two_stage validation: card vs CPU at 500 sessions"):
            cli_card_vs_cpu(torch, dev, bench_store, workdir)
        with phase("10f python -m otto_tpu_torch.pipelines in a process of its own"):
            cli_subprocess(torch, dev, bench_store, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("phase 10 metrics: " + json.dumps({
        "parse_events_per_s": files["events_per_s"],
        "submission_rows_per_s": cli_aid_weight_run["rows_per_s"],
        "two_stage_sessions_per_s": cli_two_stage_run["sessions_per_s"],
        "aid_vote_launches": cli_aid_weight_run["launches"]["aid_vote"],
        "predict_forest_rows_launches": cli_two_stage_run["launches"]["predict_forest_rows"]}),
        flush=True)

    with phase("11c the bench refit: run_two_stage_streamed in training mode"):
        refit_run = refit(torch, dev, bench_split, zero_counters, read_counters)
    with phase("11c the committed rankers resumed on the refit's training sessions"):
        resumed_train_report(torch, dev, bench_split)
    del bench_split
    with phase("11a the histogram kernel vs its twin on the refit's first fold"):
        records.append(hist_vs_twin(torch, dev, refit_run["fold"]))
    with phase("11a the binning kernel vs its twin on the refit's clicks features"):
        records.append(bin_rows_vs_twin(torch, dev, refit_run.pop("typed")))
    with phase("11b one tree and short fits, card against the CPU twin"):
        fits_card_vs_cpu(torch, dev, refit_run["fold"])
    del refit_run["fold"]
    workdir = REPO / "tmp" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        with phase("11d the CLI trains, then resumes"):
            cli_train_run = cli_train(torch, dev, bench_store, workdir, zero_counters,
                                      read_counters)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("phase 11 metrics: " + json.dumps({
        "refit_train_s": refit_run["train_s"], "refit_stream_s": refit_run["stream_s"],
        "refit_trees": refit_run["trees"], "refit_lift": refit_run["lift"]["lift"],
        "refit_ci95": refit_run["lift"]["ci95"],
        "fits_s": refit_run["spent"]["train_gbdt_ranker"],
        "node_histograms_launches": refit_run["launches"]["node_histograms"],
        "bin_rows_launches": refit_run["launches"]["bin_rows"]}), flush=True)

    # launches: each kernel's count on the path it serves (the FMA route on
    # the wide table, the vote on the baselines' path, whose shape is timed;
    # the forest kernel's float-row entry on the two-stage path, its uint8
    # entry on the pre-binned scoring path, the histogram and binning kernels
    # on the bench refit); launches_by_path adds the file CLI's aid_weight and
    # two_stage runs, and its training and resumed two_stage runs
    paths = {"embedding_knn": knn, "wide_table_retrieval": wide, "baselines": heur,
             "two_stage": two_stage, "prebinned_scoring": prebinned,
             "two_stage_sgns": two_stage_sgns, "cli_aid_weight": cli_aid_weight_run["launches"],
             "cli_two_stage": cli_two_stage_run["launches"], "refit": refit_run["launches"],
             "cli_two_stage_train": cli_train_run["launches"],
             "cli_two_stage_resumed": cli_train_run["resumed"]}
    home = {"fused_stage1": knn, "fused_stage1_fma": wide, "peel_rows": knn, "aid_vote": heur,
            "predict_forest": prebinned, "predict_forest_rows": two_stage,
            "node_histograms": refit_run["launches"], "bin_rows": refit_run["launches"]}
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
