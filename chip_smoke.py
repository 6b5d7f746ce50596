"""Drive the PyTorch port's serving paths once on one NVIDIA card: the
embedding-kNN path, and the baselines with the covisitation heuristic.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure ends the run with a non-zero
exit code):

1. device and build: require CUDA, print the card's name and power limit,
   build the hand-written kernels from ``otto_tpu_torch/csrc`` and print
   each kernel's ptxas report (registers, spills);
2. each kernel against its plain-torch twin at the full-width shapes
   (1,855,603 items x 32 dims: stage 1 over 1,867,776 padded items, the
   peel over [B, 14,592] window maxima), with the times of both;
3. full-width retrieval: a seeded 1,855,603 x 32 SGNS table round-tripped
   through ``SGNSModel.save``/``load``, ``FusedRetriever`` queries/s and its
   recall against the exact scan;
4. the serving path in the order of ``otto_tpu.pipelines.run_embedding_knn``:
   ``neighbor_table(k=21)`` over every aid, ``embedding_knn_predictions`` on
   20,000 synthetic sessions, ``evaluate_predictions``; the kernels' launch
   counters are zeroed just before and read just after (its recency route
   launches the session vote);
5. the session vote against its twin at [4096, 256] (duplicates common, -1
   tails): ``first``/``firstpos`` bit-equal, ``agg`` bit-equal on integer
   weights and within 2^-16 * sum_j |w_j| of its row on normal weights,
   ``per_aid_weight_top_fused`` against ``per_aid_weight_top`` and the CPU
   twin path; the times of both;
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
   whole packed target, [20,000, L] with L the longest session, rarely a
   multiple of 32): on the runner's own inputs against the twin, the
   runner's lists against the twin's ranking (equal up to near-ties), the
   checks of phase 5 on synthetic rows at [1,024, L], and the times of both
   at that shape.

The line before the last is a JSON object describing each kernel; the last
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
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
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


def compare_kernels(torch, dev, n_items: int, b_cmp: int, peel_rows_cmp: int,
                    b_time: int) -> list[dict]:
    """Phase 2: each kernel against its twin at the shapes a table of
    ``n_items`` gives them; returns the kernels' records.

    Stage 1 on integer-valued inputs is exact, so bit-equal.  On normal data
    the kernel and cuBLAS sum in other orders: a packed maximum may move by
    one truncation step (2^7 ulps) and change its 7-bit position code, so
    the bound is 2^8 ulps = 2^-15 relative.
    """
    from otto_tpu_torch.ops import fused_retrieval as fr
    from otto_tpu_torch.ops import row_topk as rt

    n_pad = -(-n_items // fr.CHUNK) * fr.CHUNK
    g = torch.Generator(device=dev).manual_seed(SEED)
    k1_err = 0.0
    for da in (34, 102):
        q = torch.randint(-8, 9, (b_cmp, da), generator=g, device=dev).to(torch.bfloat16)
        t = torch.randint(-8, 9, (da, n_pad), generator=g, device=dev).to(torch.bfloat16)
        t[:, n_items:] = 0  # pad columns
        k = fr.fused_stage1(q, t)
        r = fr._stage1_reference(q, t)
        sync(torch, dev)
        check(torch.equal(k.view(torch.int32), r.view(torch.int32)),
              f"stage 1 DA={da}: kernel and twin differ on integer-valued inputs")
        # normal data, with a positivity shift in the last dimension as the
        # retriever folds one in
        qn = torch.randn((b_cmp, da), generator=g, device=dev)
        qn[:, -1] = 128.0
        tn = torch.randn((da, n_pad), generator=g, device=dev)
        tn[-1] = 1.0
        qn, tn = qn.to(torch.bfloat16), tn.to(torch.bfloat16)
        k = fr.fused_stage1(qn, tn)
        r = fr._stage1_reference(qn, tn)
        rel = ((k - r).abs() / r.abs()).max().item()
        same = ((k.view(torch.int32) & 127) == (r.view(torch.int32) & 127)).float().mean().item()
        k1_err = max(k1_err, (k - r).abs().max().item())
        print(f"stage 1 DA={da} B={b_cmp} N_pad={n_pad}: integer inputs bit-equal; "
              f"normal inputs max rel err {rel:.3e} (limit 2^-15), same window position "
              f"{same:.6f} (limit 0.999)", flush=True)
        check(rel <= 2.0**-15, f"stage 1 DA={da}: relative error {rel}")
        check(same >= 0.999, f"stage 1 DA={da}: window positions agree on {same}")

    m = n_pad // 128
    x = torch.randn((peel_rows_cmp, m), generator=g, device=dev)
    x[:, 5] = x[:, 7] = x[:, 100] = 9.0  # ties inside a window
    x[:, 128:256] = 3.0
    kv, kc = rt.peel_rows(x, 6)
    rv, rc = rt.peel_rows_reference(x, 6)
    check(torch.equal(kv.view(torch.int32), rv.view(torch.int32)) and torch.equal(kc, rc),
          "peel: kernel and twin differ")
    k2_err = torch.where(kv == rv, 0.0, (kv - rv).abs()).max().item()
    print(f"peel [{peel_rows_cmp}, {m}] R=6: kernel and twin bit-equal", flush=True)

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

    # times at the main path's shapes: a 4096-query batch, compensated table
    qt = torch.randn((b_time, 102), generator=g, device=dev).to(torch.bfloat16)
    tt = torch.randn((102, n_pad), generator=g, device=dev).to(torch.bfloat16)
    xt = torch.randn((b_time, m), generator=g, device=dev)
    reps = 3 if dev.type == "cuda" else 1
    timer = (lambda fn, n: cuda_ms(torch, fn, n)) if dev.type == "cuda" else _host_ms
    k1_ms = timer(lambda: fr.fused_stage1(qt, tt), reps)
    k1_plain = timer(lambda: fr._stage1_reference(qt, tt), reps)
    k1_ms2 = timer(lambda: fr.fused_stage1(qt, tt), reps)
    k2_ms = timer(lambda: rt.peel_rows(xt, 6), 10 * reps)
    k2_plain = timer(lambda: rt.peel_rows_reference(xt, 6), reps)
    k2_ms2 = timer(lambda: rt.peel_rows(xt, 6), 10 * reps)
    print(f"stage 1 [{b_time} x 102] x [102 x {n_pad}] bf16: kernel {k1_ms:.3f} / "
          f"{k1_ms2:.3f} ms, twin {k1_plain:.3f} ms", flush=True)
    print(f"peel [{b_time}, {m}] R=6: kernel {k2_ms:.3f} / {k2_ms2:.3f} ms, "
          f"twin {k2_plain:.3f} ms", flush=True)
    src = "otto_tpu_torch/csrc/retrieval_kernels.cu"
    return [
        {"name": "fused_stage1", "route": "cuda", "source": src,
         "replaces": "otto_tpu/ops/pallas_retrieval.py:68", "launches": 0,
         "max_abs_err": k1_err, "ms": min(k1_ms, k1_ms2), "plain_ms": k1_plain},
        {"name": "peel_rows", "route": "cuda", "source": src,
         "replaces": "otto_tpu/ops/row_topk.py:38", "launches": 0,
         "max_abs_err": k2_err, "ms": min(k2_ms, k2_ms2), "plain_ms": k2_plain},
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
    return {"err": err, **time_vote(torch, aids, w_norm, reps)}


def time_vote(torch, aids, w, reps: int) -> dict:
    """Kernel and twin ms on the same inputs, by CUDA events: kernel, twin,
    kernel."""
    from otto_tpu_torch.ops import fused_sessions as fs

    k_ms = cuda_ms(torch, lambda: fs.aid_vote_aggregate(aids, w), reps)
    plain_ms = cuda_ms(torch, lambda: fs._vote_reference(aids, w), reps)
    k_ms2 = cuda_ms(torch, lambda: fs.aid_vote_aggregate(aids, w), reps)
    print(f"vote {list(aids.shape)}: kernel {k_ms:.4f} / {k_ms2:.4f} ms, twin "
          f"{plain_ms:.4f} ms", flush=True)
    return {"ms": min(k_ms, k_ms2), "plain_ms": plain_ms}


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
    print(f"aid-weight path's vote input [{S}, {L}], {int(mask.sum())} events: the kernel "
          f"pads each row to {-(-L // 32) * 32} slots", flush=True)
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
    return {"err": err, **time_vote(torch, aids, w, 10)}


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
    return {"build_s": build_s, "events": n_ev}


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
    return {"serve_s": serve_s, "target": target,
            "aid_weight": runs["aid_weight"][0].predictions["clicks"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    from otto_tpu_torch.ops import _kernels, fused_retrieval, fused_sessions, row_topk

    counters = {"fused_stage1": fused_retrieval.fused_stage1,
                "peel_rows": row_topk.peel_rows,
                "aid_vote": fused_sessions.aid_vote_aggregate}

    def zero_counters():
        for fn in counters.values():
            fn.launches = 0

    def read_counters(path: str, expected) -> dict:
        launches = {name: fn.launches for name, fn in counters.items()}
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
        records = compare_kernels(torch, dev, N_AIDS, 256, 2048, QUERY_BATCH)

    workdir = REPO / "tmp" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        with phase("3 full-width retrieval"):
            model = retrieval(torch, dev, N_AIDS, QUERY_BATCH, 256, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    zero_counters()
    with phase("4 serving path"):
        serve(torch, dev, model, 20_000, 256)
    knn = read_counters("embedding-kNN serving path", ("fused_stage1", "peel_rows", "aid_vote"))
    del model
    torch.cuda.empty_cache()

    with phase("5 session vote vs plain twin"):
        vote = compare_vote(torch, dev, 4096, 256, 512)

    with phase("6 covisitation build vs committed tables"):
        covisit_build(torch, dev)

    zero_counters()
    with phase("7 baselines and covisitation heuristic"):
        path = baselines(torch, dev, 200_000)
    heur = read_counters("baseline and heuristic path", ("aid_vote",))

    with phase("8 session vote at the aid-weight path's shape"):
        on_path = vote_on_path(torch, dev, path["target"], path["aid_weight"])
    records.append({"name": "aid_vote", "route": "cuda",
                    "source": "otto_tpu_torch/csrc/session_kernels.cu",
                    "replaces": "otto_tpu/ops/pallas_sessions.py:30", "launches": 0,
                    "max_abs_err": max(vote["err"], on_path["err"]), "ms": on_path["ms"],
                    "plain_ms": on_path["plain_ms"]})

    for rec in records:
        rec["launches"] = (heur if rec["name"] == "aid_vote" else knn)[rec["name"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
