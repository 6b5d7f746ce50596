"""Time a parent commit's CUDA kernels against this tree's, in turns, on one card.

    git archive <parent> otto_tpu_torch/csrc | tar -x -C tmp/parent
    python3 tools/compare_parent_kernels.py tmp/parent/otto_tpu_torch/csrc [k1 k2 k3 k4 k5]

Builds both sides with ``otto_tpu_torch.ops._kernels`` (its nvcc, flags and
build), and first (when every kernel is asked for) times this tree's build
two ways, in turns: one nvcc over all sources into the library, and the
package's build (one nvcc a source, all started together, then a link).
Then it calls each kernel through the C entry point of that name in each
library, checks that both sides give the same outputs, and times each pair
by CUDA graphs (device time alone, no host launch cost) in turns: parent,
this tree, this tree, parent.

- K1 (``fused_stage1_bf16``) at [4096 x 102] x [102 x 1,867,776], the
  neighbor table's batch, seeded normal bf16 operands;
- K2 (``peel_rows_f32``) at [4096, 14,592], R = 6, on K1's packed maxima of
  that batch (the path's own input);
- K3 (``aid_vote_f32``) on the aid-weight runner's own input (200,000
  synthetic sessions over 1,855,603 aids, the packed target) warm and cold
  (over rotating input copies of more than 50 MB), and at [4096, 256] on rows
  with uniform -1 tails;
- K4 with the committed clicks model (three folds, 280 trees of depth 7) at
  the two-stage replay's 1,472,000 rows a type, each feature's values drawn
  from its own edges (uniform over the bins, as the quantile edges spread
  the rows they were fit on): the parent's ``predict_forest`` (uint8 bins,
  nodes ``(thr << 16) | feat`` and leaves apart) against this tree's
  ``predict_forest_binned`` on the same bins, with this tree's
  ``predict_forest_rows`` (the float rows, binned in the kernel) timed in
  the same turns;
- K5 when the parent has the earlier ``build_histogram_f32`` entry (rows
  sorted by key) and this tree ``build_histogram_rows`` (a row list kept by
  node): the launches of one depth-7 tree of a bce fit at the refit's first
  clicks fold's shape, [1,857,664 x 55] at 256 bins, on synthetic
  session-like rows (184 candidates a session sharing 12 session-level
  features, 8 count-like features of 3 bins, a quarter of the values
  missing; 30% of the rows kept, as negative sampling keeps them, and 90%
  bagged).  The parent's side is its wrapper's work on the card (the sort by
  key, the gathers, its two kernels), this tree's the kernel on the list
  (the list is split between levels by ``_split_rows``, timed apart).  Both
  give the same bits (the same fixed-point scale).

An entry point that either library lacks is skipped, and so is a kernel left
out of the names after the path (all five when none is named).  Prints the card's
name and power limit and one JSON line: seconds for the builds, milliseconds
for the kernels.  Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N_PAD = 114 * 16384
N_ITEMS = 1_855_603


def agree(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"the parent's and this tree's {what} differ")


def timed_builds(_kernels, work: Path) -> dict:
    """Seconds of this tree's build as one nvcc call and as the package
    builds it, in turns, each into a fresh library."""
    srcs = list(map(str, _kernels.SOURCES))
    res: dict[str, list] = {}
    for n, how in enumerate(("one_nvcc", "nvcc_per_source", "nvcc_per_source", "one_nvcc")):
        out = work / f"build_{n}.so"
        t0 = time.perf_counter()
        if how == "one_nvcc":
            subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(out),
                            *srcs], check=True, capture_output=True)
        else:
            _kernels.build(_kernels.SOURCES, out)
        res.setdefault(f"build_s_{how}", []).append(time.perf_counter() - t0)
    return res


def k5_tree(torch, dev):
    """One depth-7 bce tree's histogram launches on synthetic session-like
    rows at the refit's first fold's shape: each launch's arguments (this
    tree's ``node_histograms``) and each level's ``_split_rows`` arguments."""
    from otto_tpu_torch.models import gbdt

    rng = np.random.default_rng(7)
    n, f, c = 1_857_664, 55, 184
    b = rng.integers(1, 256, (n, f)).astype(np.uint8)
    b[:, :12] = np.repeat(rng.integers(1, 256, (n // c + 1, 12)), c, axis=0)[:n]
    b[:, 12:20] = rng.integers(1, 4, (n, 8))
    b[rng.random((n, f)) < 0.25] = 0
    y = rng.random(n) < 0.05
    w = ((rng.random(n) < 0.3) | y).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    grad = t(((0.05 - y) * w).astype(np.float32))
    hess = t(np.full(n, 0.05 * 0.95, np.float32) * w)
    bag = t((rng.random(n) < 0.9).astype(np.float32))
    x = t(b)
    launches, splits = [], []
    real_h, real_s = gbdt.node_histograms, gbdt._split_rows
    gbdt.node_histograms = lambda *a: (launches.append(a), real_h(*a))[1]
    gbdt._split_rows = lambda *a: (splits.append(a), real_s(*a))[1]
    try:
        gbdt._grow_tree(x, grad, hess, t(w), bag, torch.ones(f, dtype=torch.bool, device=dev),
                        0.01, 1e-5, 200.0, 1e-3, 0.05, depth=7, n_bins=256)
    finally:
        gbdt.node_histograms, gbdt._split_rows = real_h, real_s
    return x, launches, splits


def k5_turns(torch, dev, libs, stream, res: dict) -> None:
    """Each level of one tree: the parent's wrapper work (sort by key,
    gathers, its kernels) and this tree's kernel on the row list, same bits,
    timed in turns by CUDA graphs; the list's split after each level apart."""
    import chip_smoke as cs
    from otto_tpu_torch.models import gbdt
    from otto_tpu_torch.ops import _kernels, hist

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs["parent"].build_histogram_f32.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, p]
    libs["parent"].build_histogram_f32.restype = i
    _kernels._lib = libs["tree"]  # the package's wrappers launch from this tree's build
    x, launches, splits = k5_tree(torch, dev)
    n, F = x.shape
    for level, (rows, n_feat, vals, vmax, order, start, pre, n_bins) in enumerate(launches):
        n_keys = start.shape[0]
        key = hist.list_keys(order, start, pre, n)
        cells = (n_keys, F, n_bins, 3)
        o = {s: torch.empty(cells, device=dev) for s in libs}
        acc = {s: torch.empty(cells, dtype=torch.int64, device=dev) for s in libs}
        ar = torch.arange(n_keys + 1, dtype=torch.int32, device=dev)

        starts = start.contiguous()

        def parent():  # the tensors stay referenced until the launch is queued
            ks, idx = torch.sort(key)
            seg = torch.searchsorted(ks, ar)
            xs, vs, vm = x.index_select(0, idx), vals.index_select(0, idx), vals.abs().amax(0)
            agree(libs["parent"].build_histogram_f32(
                xs.data_ptr(), vs.data_ptr(), seg.data_ptr(), vm.data_ptr(),
                acc["parent"].data_ptr(), o["parent"].data_ptr(), n, F, n_keys, n_bins, 0,
                stream()) == 0, "launches")

        def tree():
            agree(libs["tree"].build_histogram_rows(
                rows.data_ptr(), vals.data_ptr(), vmax.data_ptr(), order.data_ptr(),
                starts.data_ptr(), pre.data_ptr(), acc["tree"].data_ptr(),
                o["tree"].data_ptr(), n, rows.shape[1], n_feat, n_keys, n_bins, 0,
                stream()) == 0, "launches")

        parent()
        tree()
        torch.cuda.synchronize()
        agree(torch.equal(o["parent"].view(torch.int32), o["tree"].view(torch.int32)),
              f"level-{level} histograms")
        calls = {"parent": parent, "tree": tree}
        for side in ("parent", "tree", "tree", "parent"):
            res.setdefault(f"k5_level{level}_{side}", []).append(cs.graph_ms(torch,
                                                                             [calls[side]]))
        if level < len(splits):
            res[f"k5_level{level}_split"] = [cs.graph_ms(torch, [lambda: gbdt._split_rows(
                *splits[level])])]
        res[f"k5_level{level}_keys_listed"] = [n_keys, int(pre[-1])]
    for side in ("parent", "tree"):
        res[f"k5_tree_{side}"] = [sum(min(res[f"k5_level{lv}_{side}"])
                                      for lv in range(len(launches)))]


def main() -> int:
    import torch

    names = set(sys.argv[2:]) or {"k1", "k2", "k3", "k4", "k5"}
    if len(sys.argv) < 2 or not names <= {"k1", "k2", "k3", "k4", "k5"} \
            or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs
    from otto_tpu_torch import pipelines
    from otto_tpu_torch.data.splits import split_by_fraction
    from otto_tpu_torch.data.synthetic import synthetic_events_v2
    from otto_tpu_torch.models.recency import VALIDATION_COEFFICIENTS
    from otto_tpu_torch.ops import _kernels
    from otto_tpu_torch.ops import sessions as ses

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    (REPO / "tmp").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="parent_kernels_", dir=REPO / "tmp"))
    if len(names) == 5:
        res = timed_builds(_kernels, work)
    else:  # a subset: this tree's library built once
        res = {}
        _kernels.build(_kernels.SOURCES, work / "build_1.so")
    libs = {"parent": _kernels.load(_kernels.build(sorted(Path(sys.argv[1]).glob("*.cu")),
                                                   work / "parent.so")),
            "tree": _kernels.load(work / "build_1.so")}
    both = {name for name in _kernels.ENTRY_POINTS
            if all(hasattr(lib, name) for lib in libs.values())}
    print(f"entry points of both sides: {sorted(both)}", flush=True)

    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def turns(key, fns: dict) -> None:
        """fns: side -> list of calls, each timed as one graph."""
        for side in ("parent", "tree", "tree", "parent"):
            res.setdefault(f"{key}_{side}", []).append(cs.graph_ms(torch, fns[side]))

    # K1 at the neighbor table's batch
    q = torch.randn((4096, 102), generator=g, device=dev)
    q[:, -1] = 128.0
    t = torch.randn((102, N_PAD), generator=g, device=dev)
    t[-1] = 1.0
    t[:, N_ITEMS:] = 0
    q, t = q.to(torch.bfloat16), t.to(torch.bfloat16)
    x = torch.empty((4096, N_PAD // 128), device=dev)
    if "fused_stage1_bf16" in both and names & {"k1", "k2"}:
        packed = {s: torch.empty_like(x) for s in libs}
        k1 = {s: [lambda s=s: libs[s].fused_stage1_bf16(q.data_ptr(), t.data_ptr(),
                                                        packed[s].data_ptr(), 4096, 102, N_PAD,
                                                        0, stream())] for s in libs}
        for fns in k1.values():
            fns[0]()
        torch.cuda.synchronize()
        agree(torch.equal(packed["parent"].view(torch.int32), packed["tree"].view(torch.int32)),
              "stage-1 maxima")
        turns("k1", k1)
        x = packed["tree"]
    else:
        libs["tree"].fused_stage1_bf16(q.data_ptr(), t.data_ptr(), x.data_ptr(), 4096, 102,
                                       N_PAD, 0, stream())
    del t

    # K2 on K1's packed maxima
    m, rounds = N_PAD // 128, 6
    if "peel_rows_f32" in both and "k2" in names:
        outs = {s: (torch.empty((4096, rounds, m // 128), device=dev),
                    torch.empty((4096, rounds, m // 128), device=dev, dtype=torch.int32))
                for s in libs}
        k2 = {s: [lambda s=s: libs[s].peel_rows_f32(x.data_ptr(), outs[s][0].data_ptr(),
                                                    outs[s][1].data_ptr(), 4096, m, rounds, 0,
                                                    stream())] for s in libs}
        for fns in k2.values():
            fns[0]()
        torch.cuda.synchronize()
        agree(torch.equal(outs["parent"][0].view(torch.int32), outs["tree"][0].view(torch.int32))
              and torch.equal(outs["parent"][1], outs["tree"][1]), "peels")
        turns("k2", k2)

    # K3 on the aid-weight runner's own input and on [4096, 256], warm and cold
    if "aid_vote_f32" in both and "k3" in names:
        sp = split_by_fraction(synthetic_events_v2(n_sessions=200_000, n_aids=N_ITEMS,
                                                   seed=cs.SEED))
        pk = pipelines._packed(sp.val_input)
        to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        mask = to(pk.mask)
        coef = torch.tensor(VALIDATION_COEFFICIENTS, dtype=torch.float32, device=dev)
        w = ses.recency_event_weights(to(pk.aids), to(pk.types), mask, to(pk.lengths), coef)
        runner = (torch.where(mask, to(pk.aids), -1).to(torch.int32).contiguous(),
                  torch.where(mask, w, 0.0).contiguous())
        gt = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
        aids = torch.randint(0, 48, (4096, 256), generator=gt, device=dev, dtype=torch.int32)
        tail = torch.randint(0, 257, (4096, 1), generator=gt, device=dev)
        aids[torch.arange(256, device=dev)[None, :] >= 256 - tail] = -1
        tails = (aids, torch.where(aids >= 0, torch.randn((4096, 256), generator=gt, device=dev),
                                   0.0))
        for key, (a, wt) in (("k3_runner", runner), ("k3_4096x256", tails)):
            S, L = a.shape
            o = {s: (torch.empty((S, L), device=dev),
                     torch.empty((S, L), device=dev, dtype=torch.int32),
                     torch.empty((S, L), device=dev, dtype=torch.int32)) for s in libs}

            def vote(s, a_, w_):
                libs[s].aid_vote_f32(a_.data_ptr(), w_.data_ptr(), *(y.data_ptr() for y in o[s]),
                                     S, L, 0, stream())

            for s in libs:
                vote(s, a, wt)
            torch.cuda.synchronize()
            agree(all(torch.equal(u, v) for u, v in zip(o["parent"], o["tree"])),
                  f"votes ({key})")
            copies = [(a, wt)] + [(a.clone(), wt.clone())
                                  for _ in range(int(64e6 // (a.numel() * 8)))]
            turns(f"{key}_warm", {s: [lambda s=s: vote(s, a, wt)] for s in libs})
            turns(f"{key}_cold", {s: [lambda s=s, c=c: vote(s, *c) for c in copies]
                                  for s in libs})
            res[f"{key}_shape"] = [S, L]
            res[f"{key}_mean_live"] = [float(np.mean((a >= 0).sum(1).cpu().numpy()))]

    # K4: the parent's uint8 kernel against this tree's two entries
    if hasattr(libs["parent"], "predict_forest") and hasattr(libs["tree"], "predict_forest_rows") \
            and "k4" in names:
        from otto_tpu_torch.models.gbdt import load_ranker_model
        from otto_tpu_torch.ops import forest

        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        libs["parent"].predict_forest.argtypes = [p, p, p, p, p, p, ll, i, i, i, f, i, p]
        libs["parent"].predict_forest.restype = i
        model = load_ranker_model(REPO / "artifacts" / "bench_e2e" / "ranker_clicks.npz")
        pack, edges = model.packed(dev), model.packed_edges(dev)
        rng = np.random.default_rng(cs.SEED)
        n, F = 1_472_000, model.edges.shape[0]
        cols = rng.integers(0, model.edges.shape[1], (n, F))
        x = torch.as_tensor(model.edges[np.arange(F)[None, :], cols], device=dev)
        binned = forest._bin_rows_reference(x, edges)
        nodes = ((pack.thr << 16) | pack.feat).contiguous()
        inv = float(np.float32(1.0 / pack.n_folds))
        o = {s: torch.empty(n, device=dev) for s in ("parent", "tree", "rows")}
        tail = (pack.fold_end.data_ptr(), pack.base.data_ptr())
        calls = {
            "parent": lambda: libs["parent"].predict_forest(
                binned.data_ptr(), nodes.data_ptr(), pack.leaf.data_ptr(), *tail,
                o["parent"].data_ptr(), n, F, pack.n_folds, pack.depth, inv, 0, stream()),
            "tree": lambda: libs["tree"].predict_forest_binned(
                binned.data_ptr(), pack.model.data_ptr(), *tail, o["tree"].data_ptr(), n, F,
                pack.n_trees, pack.n_folds, pack.depth, inv, 0, stream()),
            "rows": lambda: libs["tree"].predict_forest_rows(
                x.data_ptr(), edges.data_ptr(), pack.model.data_ptr(), *tail,
                o["rows"].data_ptr(), n, F, pack.n_trees, pack.n_folds, pack.depth, inv, 0,
                stream())}
        for call in calls.values():
            agree(call() == 0, "forest launches")
        torch.cuda.synchronize()
        agree(torch.equal(o["parent"].view(torch.int32), o["tree"].view(torch.int32))
              and torch.equal(o["parent"].view(torch.int32), o["rows"].view(torch.int32)),
              "forest scores")
        for side in ("parent", "tree", "tree", "parent"):
            res.setdefault(f"k4_{side}", []).append(cs.graph_ms(torch, [calls[side]]))
            if side == "tree":
                res.setdefault("k4_tree_rows", []).append(cs.graph_ms(torch, [calls["rows"]]))
        res["k4_shape"] = [n, F, pack.n_trees, pack.depth]

    # K5: the parent's sorted-rows entry against this tree's row lists
    if hasattr(libs["parent"], "build_histogram_f32") and hasattr(libs["tree"],
                                                                  "build_histogram_rows") \
            and "k5" in names:
        k5_turns(torch, dev, libs, stream, res)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
