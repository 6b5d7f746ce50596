"""Drive the PyTorch port's embedding-kNN serving path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure ends the run with a non-zero
exit code):

1. device and build: require CUDA, print the card's name and power limit,
   build the hand-written kernels from ``otto_tpu_torch/csrc``;
2. each kernel against its plain-torch twin at the full-width shapes
   (1,855,603 items x 32 dims: stage 1 over 1,867,776 padded items, the
   peel over [B, 14,592] window maxima), with the times of both;
3. full-width retrieval: a seeded 1,855,603 x 32 SGNS table round-tripped
   through ``SGNSModel.save``/``load``, ``FusedRetriever`` queries/s and its
   recall against the exact scan;
4. the serving path in the order of ``otto_tpu.pipelines.run_embedding_knn``:
   ``neighbor_table(k=21)`` over every aid, ``embedding_knn_predictions`` on
   20,000 synthetic sessions, ``evaluate_predictions``; the kernels' launch
   counters are zeroed just before and read just after.

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    from otto_tpu_torch.ops import _kernels, fused_retrieval, row_topk

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
                if "registers" in line or "spill" in line:
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

    fused_retrieval.fused_stage1.launches = 0
    row_topk.peel_rows.launches = 0
    with phase("4 serving path"):
        serve(torch, dev, model, 20_000, 256)
    launches = {"fused_stage1": fused_retrieval.fused_stage1.launches,
                "peel_rows": row_topk.peel_rows.launches}
    print(f"kernel launches in the serving path: {launches}", flush=True)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        check(rec["launches"] > 0, f"{rec['name']} was not launched by the serving path")

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
