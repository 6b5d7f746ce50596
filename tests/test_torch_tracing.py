"""The port's profiler spans and route counters, on the CPU.

- ``utils.profiling.span`` is one shared no-op context with no profiler, and
  a ``record_function`` range under ``profile().start()`` / ``stop()`` and
  under a ``with profile()`` block, nested as the ``with`` blocks are;
- one ``sequence_serving_predictions`` call opens the serving spans, each
  under its parent and all under the call's ``otto::serve``: over a catalog
  below ``FUSED_MIN_AIDS`` (the exact ``topk_scan``, no retrieval span) and
  over 65,536 aids (the fused retriever's CPU twins under
  ``otto::retrieval.build`` and ``otto::retrieval.topk``);
- ``sequence_serving_predictions.sessions`` counts each route's sessions,
  ``sessions_with_distinct_at_least.sessions`` the sessions its route test
  decided by length (fewer than 20 events) and those it counted, and
  ``run_sequence`` logs its call's counts of both.
"""

import contextlib
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from otto_tpu_torch import pipelines
from otto_tpu_torch.config import SequenceModelConfig
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.models import sequence as tseq
from otto_tpu_torch.models.covisitation import sessions_with_distinct_at_least
from otto_tpu_torch.utils.profiling import span

torch.set_num_threads(1)

# each span of a serving call, and the span it opens under
PARENT = {
    "otto::serve.route": {"otto::serve"},
    "otto::serve.recency": {"otto::serve"},
    "otto::serve.model": {"otto::serve"},
    "otto::serve.fallback": {"otto::serve"},
    "otto::sessions.select": {"otto::serve.recency", "otto::serve.model"},
    "otto::sessions.pack": {"otto::serve.recency", "otto::serve.model"},
    "otto::serve.readback": {"otto::serve.recency", "otto::serve.model"},
    "otto::encode": {"otto::serve.model"},
    "otto::retrieval.build": {"otto::serve.model"},
    "otto::retrieval.topk": {"otto::serve.model"},
}
RETRIEVAL = {"otto::retrieval.build", "otto::retrieval.topk"}


def _record(how: str, fn):
    """``fn()`` under a CPU profiler started by ``start()`` or by a ``with``
    block; the profiler's events."""
    prof = profile(activities=[ProfilerActivity.CPU])
    if how == "start_stop":
        prof.start()
        try:
            fn()
        finally:
            prof.stop()
    else:
        with prof:
            fn()
    return prof.events()


def _spans(events) -> list:
    return [e for e in events if e.name.startswith("otto::")]


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a = span("otto::a")
    assert a is span("otto::b") and isinstance(a, contextlib.nullcontext)
    with a, span("otto::c"):
        pass


@pytest.mark.parametrize("how", ["start_stop", "with_block"])
def test_span_is_recorded_under_a_profiler(how):
    def body():
        with span("otto::outer"):
            with span("otto::inner"):
                torch.ones(4).add_(1)

    spans = {e.name: e for e in _spans(_record(how, body))}
    assert set(spans) == {"otto::outer", "otto::inner"}
    assert spans["otto::inner"].cpu_parent is spans["otto::outer"]
    assert spans["otto::outer"].time_range.start <= spans["otto::inner"].time_range.start
    assert isinstance(span("otto::after"), contextlib.nullcontext)


def _serving_case(n_aids: int):
    """A GRU model over ``n_aids`` aids (weights from a seed, dim 8) and a
    store with sessions on all three routes: 20+ distinct aids (recency),
    a trained last aid (model) and an untrained one (fallback); the
    trained-aid mask and a kNN table."""
    cfg = SequenceModelConfig(n_aids=n_aids, dim=8, hidden=16, max_len=8, architecture="gru")
    model = tseq.SequenceModel(tseq._config_params(cfg, torch.Generator().manual_seed(2)), cfg)
    rng = np.random.default_rng(5)
    sessions = [rng.permutation(n_aids)[:int(rng.integers(20, 40))] for _ in range(6)]
    sessions += [rng.integers(0, n_aids, int(rng.integers(1, 12))) for _ in range(30)]
    trained = np.ones(n_aids, bool)
    trained[:n_aids // 4] = False
    for s in sessions[6:10]:
        s[-1] = 1  # untrained: the fallback route
    for s in sessions[10:]:
        s[-1] = n_aids - 1  # trained: the model route
    sess = np.concatenate([np.full(len(s), i) for i, s in enumerate(sessions)])
    aid = np.concatenate(sessions)
    store = EventStore.from_flat(sess, aid, np.arange(len(aid)),
                                 rng.integers(0, 3, len(aid)).astype(np.int8))
    ft = np.tile(np.arange(5, dtype=np.int32), (n_aids, 1))
    return model, store, trained, ft


@pytest.mark.parametrize("n_aids", [150, tseq.FUSED_MIN_AIDS], ids=["topk_scan", "fused"])
def test_serving_call_opens_its_spans_under_serve(n_aids):
    model, store, trained, ft = _serving_case(n_aids)
    events = _record("start_stop", lambda: tseq.sequence_serving_predictions(
        store, model, trained, ft, k=5))
    spans = _spans(events)
    serve = [e for e in spans if e.name == "otto::serve"]
    assert len(serve) == 1 and serve[0].cpu_parent is None
    names = {e.name for e in spans}
    want = set(PARENT) | {"otto::serve"}
    assert names == (want if n_aids >= tseq.FUSED_MIN_AIDS else want - RETRIEVAL)
    for e in spans:
        if e is serve[0]:
            continue
        assert e.cpu_parent is not None and e.cpu_parent.name in PARENT[e.name], e.name
        top = e
        while top.cpu_parent is not None:
            top = top.cpu_parent
        assert top is serve[0]
    count = {n: sum(e.name == n for e in spans) for n in names}
    # a pack and its upload on each route; a select each; a readback each
    # (one model batch)
    assert count["otto::sessions.pack"] == 4 and count["otto::sessions.select"] == 2
    assert count["otto::serve.readback"] == 2


def test_route_counters_equal_the_routes(monkeypatch, caplog):
    model, store, trained, ft = _serving_case(150)
    distinct = np.array([len(np.unique(store.aid[a:b]))
                         for a, b in zip(store.offsets[:-1], store.offsets[1:])])
    recency = distinct >= 20
    known = trained[store.last_aid()]
    want = {"recency": int(recency.sum()), "model": int((~recency & known).sum()),
            "fallback": int((~recency & ~known).sum())}
    short = int((store.lengths < 20).sum())
    decided = {"by_length": short, "counted": store.n_sessions - short}
    assert all(want.values()) and all(decided.values())
    before = dict(tseq.sequence_serving_predictions.sessions)
    before_decided = dict(sessions_with_distinct_at_least.sessions)
    preds = tseq.sequence_serving_predictions(store, model, trained, None, k=5)
    after = tseq.sequence_serving_predictions.sessions
    assert {r: after[r] - before[r] for r in want} == want
    after_decided = sessions_with_distinct_at_least.sessions
    assert {d: after_decided[d] - before_decided[d] for d in decided} == decided
    assert (preds["clicks"][~recency & ~known] == -1).all()

    # run_sequence logs its own call's counts (the training replaced by the
    # seeded model; its mask marks the aids of the training store)
    monkeypatch.setattr(tseq, "train_sequence_model", lambda train, cfg, device: model)
    train = EventStore.from_flat(np.zeros(1, np.int64), np.array([3]), np.zeros(1, np.int64),
                                 np.zeros(1, np.int8))
    tseq.sequence_serving_predictions(store, model, trained, None, k=5)  # not this call's
    # the package's logger stops propagating once configure_logging has run
    monkeypatch.setattr(logging.getLogger("otto_tpu_torch"), "propagate", True)
    with caplog.at_level(logging.INFO, logger="otto_tpu_torch"):
        pipelines.run_sequence(train, store, 150, device="cpu")
    line = [r.getMessage() for r in caplog.records if "routes" in r.getMessage()]
    known = store.last_aid() == 3
    assert line == [f"sequence (gru) routes: {int(recency.sum())} sessions recency, "
                    f"{int((~recency & known).sum())} model, "
                    f"{int((~recency & ~known).sum())} fallback (no list); "
                    f"{decided['by_length']} decided by length, {decided['counted']} counted"]
