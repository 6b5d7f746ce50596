"""Driver ``serve``: a closed loop of one client scoring shards of sessions
through the port's ``sequence_serving_predictions``.

Set-up generates the pool of sessions from the seed, cuts it into shards,
makes the model's parameters on the card from the seed and serves every
shard once, which builds and warms every shape the window uses.  The window
then sends the shards in turn, the next when the last has returned its
lists to the host, until ``--seconds`` have passed and every shard has been
served at least once.

The check takes a sample of the sessions served in the window, drawn from
the seed (the longest session of the pool among them), and judges each
served list by the reference's scores: the model route by the reference
encoder and the full-catalog scan, the long sessions by the aid-weight sums
(:mod:`reference.compare`).  The routing is the port's stated rule,
worked out again here: sessions of at least 20 distinct aids go to the
recency route, the others to the model (``trained_aid_mask=None``: every
aid is known).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchkit.params import flatten, make_params
from benchkit.program import distinct_counts, event_store, sequence_config
from benchkit.trace import DeviceTrace, warm_profiler
from reference import compare, recency_ref
from reference import sequence_ref as ref

TOPK_RANGE = "bench::topk"
# recbole/inference.py:137-148, as sequence_serving_predictions states it
RECENCY_MIN_DISTINCT = 20
FAULTS = ("altered_token", "reversed", "shuffled", "half_catalog")


class _TopkRanges:
    """While in a ``with`` block, every ``FusedRetriever.topk`` call runs in a
    ``record_function`` range and its query rows are counted."""

    def __init__(self):
        from otto_tpu_torch.ops import fused_retrieval

        self.cls = fused_retrieval.FusedRetriever
        self.orig = self.cls.topk
        self.rows: list[int] = []

    def __enter__(self):
        orig, rows = self.orig, self.rows

        def topk(retriever, queries, *args, **kw):
            rows.append(int(queries.shape[0]))
            with torch.profiler.record_function(TOPK_RANGE):
                return orig(retriever, queries, *args, **kw)

        self.cls.topk = topk
        return self

    def __exit__(self, *exc):
        self.cls.topk = self.orig


class _Fault:
    """The control tests' faults, planted in the program's model route:

    - ``altered_token``: the id at the middle rank of every list replaced by
      another catalog id;
    - ``reversed``: every list returned in reverse order;
    - ``shuffled``: every list returned in one fixed shuffled order;
    - ``half_catalog``: the catalog scan sees only the first half of the
      item table (the fused retriever's table and the exact scan's alike).
    """

    def __init__(self, fault: str, n_aids: int):
        import otto_tpu_torch.models.sequence as seq_module
        from otto_tpu_torch.ops.fused_retrieval import FusedRetriever

        if fault == "half_catalog":
            init, scan = FusedRetriever.__init__, seq_module.topk_scan

            def half_init(retriever, items, *args, **kw):
                init(retriever, items[:items.shape[0] // 2], *args, **kw)

            def half_scan(q, items, *args, **kw):
                return scan(q, items[:items.shape[0] // 2], *args, **kw)

            self.patches = [(FusedRetriever, "__init__", init, half_init),
                            (seq_module, "topk_scan", scan, half_scan)]
        else:
            cls = seq_module.SequenceModel
            orig = cls.full_sort_topk

            def full_sort_topk(model, store, k=20, batch=4096):
                out = orig(model, store, k=k, batch=batch)
                if fault == "altered_token":
                    out[:, k // 2] = (out[:, k // 2].astype(np.int64) * 7919 + 12345) % n_aids
                elif fault == "reversed":
                    out = np.ascontiguousarray(out[:, ::-1])
                else:
                    out = out[:, np.random.default_rng(0).permutation(k)]
                return out

            self.patches = [(cls, "full_sort_topk", orig, full_sort_topk)]

    def __enter__(self):
        for owner, name, _, new in self.patches:
            setattr(owner, name, new)
        return self

    def __exit__(self, *exc):
        for owner, name, old, _ in self.patches:
            setattr(owner, name, old)


def shard_store(pool, lo: int, hi: int):
    """The port's ``EventStore`` of the pool's sessions ``lo:hi``."""
    from otto_tpu_torch.data.events import EventStore

    a, b = pool.offsets[lo], pool.offsets[hi]
    return EventStore.from_flat(pool.session_ids[pool.session_idx[a:b]], pool.aid[a:b],
                                pool.ts[a:b], pool.type[a:b], assume_sorted=True)


def sample_sessions(lengths: np.ndarray, recency: np.ndarray, n_model: int, n_recency: int,
                    seed: int) -> np.ndarray:
    """Pool indices to check: ``n_model`` model-route and ``n_recency``
    recency-route sessions drawn from the seed, and the longest session."""
    rng = np.random.default_rng([seed, 2])
    m, r = np.flatnonzero(~recency), np.flatnonzero(recency)
    pick = [rng.choice(m, min(n_model, len(m)), replace=False),
            rng.choice(r, min(n_recency, len(r)), replace=False), [int(np.argmax(lengths))]]
    return np.unique(np.concatenate(pick).astype(np.int64))


def _model_inputs(rows, pool, L: int, device):
    seq = np.zeros((len(rows), L), np.int64)
    mask = np.zeros((len(rows), L), bool)
    for j, i in enumerate(rows):
        a = pool.aid[pool.offsets[i]:pool.offsets[i + 1]][-L:]
        seq[j, :len(a)], mask[j, :len(a)] = a, True
    return torch.as_tensor(seq, device=device), torch.as_tensor(mask, device=device)


def check_lists(served: dict, pool, cfg: dict, params: dict, recency: np.ndarray,
                block: int = 64) -> dict:
    """The numbers of the served lists ``served`` {pool index: [lists]}."""
    P = dict(flatten(params))
    items = P["item_emb"][:cfg["n_aids"]]
    model_gap = recency_gap = 0.0
    misranked = pairs = 0
    m_idx = [i for i in sorted(served) if not recency[i]]
    for b0 in range(0, len(m_idx), block):
        rows = m_idx[b0:b0 + block]
        seq, mask = _model_inputs(rows, pool, cfg["max_len"], items.device)
        with torch.no_grad():
            truth = ref.catalog_scores(ref.encode(P, cfg["architecture"], seq, mask), items)
        for j, i in enumerate(rows):
            model_gap = max(model_gap, compare.model_gap(served[i], truth[j]))
            c, n = compare.misranked(served[i], truth[j])
            misranked, pairs = misranked + c, pairs + n
    for i in (i for i in sorted(served) if recency[i]):
        a = pool.aid[pool.offsets[i]:pool.offsets[i + 1]]
        ids, sums = recency_ref.aid_scores(a, pool.type[pool.offsets[i]:pool.offsets[i + 1]])
        recency_gap = max(recency_gap, compare.recency_gap(served[i], ids, sums))
    return {"model_gap": model_gap, "model_misrank": misranked / pairs if pairs else 0.0,
            "recency_gap": recency_gap}


def control_lists(idx, pool, cfg: dict, params: dict, recency: np.ndarray, k: int,
                  block: int = 64) -> dict:
    """The control: the reference put in the program's place one precision
    lower, TF32 products for the model route and bfloat16 weights and sums
    for the recency route; lists in ``served``'s format."""
    P = dict(flatten(params))
    items = P["item_emb"][:cfg["n_aids"]]
    out = {}
    m_idx = [i for i in idx if not recency[i]]
    for b0 in range(0, len(m_idx), block):
        rows = m_idx[b0:b0 + block]
        seq, mask = _model_inputs(rows, pool, cfg["max_len"], items.device)
        with torch.no_grad():
            q = ref.encode(P, cfg["architecture"], seq, mask, "tf32")
            top = torch.topk(ref.catalog_scores(q, items, "tf32"), k, dim=1).indices.cpu().numpy()
        out.update({i: [top[j]] for j, i in enumerate(rows)})
    for i in (i for i in idx if recency[i]):
        sl = slice(pool.offsets[i], pool.offsets[i + 1])
        out[i] = [recency_ref.top_aids(pool.aid[sl], pool.type[sl], k, "bf16")]
    return out


def control(state: dict, cfg: dict) -> dict:
    """The control's numbers: its own lists for the sessions the run
    checked, judged as the program's are."""
    lists = control_lists(state["picked"], state["pool"], cfg, state["params"], state["recency"],
                          len(next(iter(state["served"].values()))[0]))
    return check_lists(lists, state["pool"], cfg, state["params"], state["recency"])


def readings(cfg: dict, traffic: dict, seed: int, device: str = "cuda",
             fault: str | None = None) -> dict:
    """The check on a window of one pass over the shards."""
    res = run({}, cfg, traffic, seed, 0.0, False, 0.0, device=device, fault=fault,
              keep_state=True)
    return {"checks": res["checks"], "notes": res["notes"], "state": res["state"]}


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", fault: str | None = None,
        keep_state: bool = False) -> dict:
    from otto_tpu_torch import EVENT_TYPES
    from otto_tpu_torch.models.sequence import SequenceModel, sequence_serving_predictions

    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    seed = seed % (1 << 63)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S, n_shards = traffic["shard_sessions"], traffic["pool_sessions"] // traffic["shard_sessions"]
    t_gen = time.perf_counter()
    pool = event_store(traffic, cfg["n_aids"], n_shards * S, seed)
    t_gen = time.perf_counter() - t_gen
    recency = distinct_counts(pool.aid, pool.offsets) >= RECENCY_MIN_DISTINCT
    shards = [shard_store(pool, i * S, (i + 1) * S) for i in range(n_shards)]
    model_rows = [int((~recency[i * S:(i + 1) * S]).sum()) for i in range(n_shards)]
    model = SequenceModel(make_params(cfg, seed, device), sequence_config(cfg, seed))
    on_card = torch.device(device).type == "cuda"
    planted = _Fault(fault, cfg["n_aids"]) if fault else None
    if planted:
        planted.__enter__()

    def serve(shard):
        return sequence_serving_predictions(shard, model, trained_aid_mask=None,
                                            k=traffic["k"])

    try:
        t_warm = time.perf_counter()
        for shard in shards:
            serve(shard)
        t_warm = time.perf_counter() - t_warm
        tracer, ranges = None, None
        if trace:
            warm_profiler()
            tracer, ranges = DeviceTrace(), _TopkRanges()
        # the sessions the check takes; each call keeps only their rows
        picked = sample_sessions(pool.lengths, recency, traffic["check_model_sessions"],
                                 traffic["check_recency_sessions"], seed)
        rows = [picked[picked // S == sh] % S for sh in range(n_shards)]
        gc.collect()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        lat, kept, failed, traced = [], [], 0, []
        t0 = time.perf_counter()
        while True:
            i = len(lat)
            if tracer is not None and i == traffic["trace_first"]:
                ranges.__enter__()
                tracer.start()
            if tracer is not None and tracer.running and i == traffic["trace_first"] + traffic["trace_calls"]:
                tracer.stop()
                ranges.__exit__()
            s = time.perf_counter()
            try:
                out = serve(shards[i % n_shards])
            except Exception as exc:  # counted as failed; the run goes on
                out = None
                failed += 1
                error = repr(exc)
            e = time.perf_counter()
            lat.append(e - s)
            kept.append(None if out is None else
                        [out[t][rows[i % n_shards]] for t in EVENT_TYPES])
            del out
            if tracer is not None and tracer.running:
                traced.append(i % n_shards)
            if e - t0 >= seconds and len(lat) >= n_shards:
                break
        if tracer is not None and tracer.running:
            tracer.stop()
            ranges.__exit__()
    finally:
        if planted:
            planted.__exit__()
    window_s = e - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    n_calls = len(lat)
    ok_calls = [c for c in range(n_calls) if kept[c] is not None]
    sessions = len(ok_calls) * S

    # the check: every sampled session, from a call of the window that served it
    rng = np.random.default_rng([seed, 3])
    served = {}
    for i in picked:
        sh = int(i // S)
        calls = [c for c in ok_calls if c % n_shards == sh]
        if not calls:
            served[int(i)] = [np.full(traffic["k"], -1)]
            continue
        lists = kept[int(rng.choice(calls))]
        j = int(np.flatnonzero(rows[sh] == i % S)[0])
        served[int(i)] = [x[j] for x in lists]
    del kept
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check_lists(served, pool, cfg, model.params, recency)
    notes = [f"pool generated in {t_gen:.3f} s, warm-up pass {t_warm:.3f} s, set-up "
             f"{setup_s:.3f} s",
             f"pool {pool.n_sessions} sessions in {n_shards} shards of {S}; recency route "
             f"{recency.mean():.6f} of sessions; {n_calls} calls in {window_s:.3f} s, "
             f"{failed} failed; checked {len(picked)} sessions "
             f"({int(recency[picked].sum())} on the recency route, the longest "
             f"{int(pool.lengths.max())} events)"]
    if failed:
        notes.append(f"a call raised {error}")
    lat_ms = np.asarray(lat) * 1e3
    layer = {"config": cfg, "trace": tracer.summary if tracer else None,
             "model_sessions_traced": sum(model_rows[s] for s in traced),
             "topk_rows": ranges.rows if ranges else []}
    res = {
        "end_to_end": {"serve_sessions_per_s": sessions / window_s,
                       "serve_shard_p95_ms": float(np.percentile(lat_ms, 95)),
                       "setup_s": setup_s},
        "attempted": n_calls, "failed": failed, "checks": checks, "notes": notes,
        "memory_peak_bytes": peak, "layer": layer,
    }
    if keep_state:
        res["state"] = {"pool": pool, "picked": picked, "served": served,
                        "params": model.params, "recency": recency}
    return res
