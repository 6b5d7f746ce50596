"""The port's distinct-aid counts and its ">= n distinct aids" route test
against ``otto_tpu``'s ``session_unique_counts``, on the CPU.

Every serving router sends a session with 20 or more distinct aids to the
recency route.  ``sessions_with_distinct_at_least(store, n)`` decides a
session of fewer than ``n`` events by its length and counts the others'
distinct aids by one key sort; ``session_unique_counts`` counts every
session's by the same sort.  Both must equal the reference's lexsort count,
element for element (exact integers, no tolerance), on:

- a ``synthetic_events_v2`` store (3,000 sessions, mean length 11, up to
  200 events);
- sessions of exactly 19, 20 and 21 events, all distinct or with one aid
  repeated, and a 200-event session of a single aid, among short ones;
- aids up to 2**31 - 1 (the key packs the session above the aid's 32 bits);
- a one-session store and an empty one (the reference cannot index an
  empty store; there the port must return empty arrays);

at ``n`` of 1, 20 and 200.
"""

import numpy as np
import pytest

from otto_tpu.data.events import EventStore as JEventStore
from otto_tpu.models import covisitation as jcov
from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.data.synthetic import synthetic_events_v2
from otto_tpu_torch.models import covisitation as tcov


def _from_sessions(sessions: list) -> EventStore:
    none = [np.zeros(0, np.int64)]
    sess = np.concatenate([np.full(len(s), i) for i, s in enumerate(sessions)] + none)
    aid = np.concatenate([np.asarray(s, np.int64) for s in sessions] + none)
    return EventStore.from_flat(sess, aid, np.arange(len(aid)), np.zeros(len(aid), np.int8))


def _synthetic():
    return synthetic_events_v2(n_sessions=3000, n_aids=5000, mean_length=11.0, max_length=200,
                               weeks=1.0, seed=7)


def _boundaries():
    rng = np.random.default_rng(3)
    sessions = []
    for length in (19, 20, 21):
        distinct = rng.permutation(1000)[:length]
        repeated = distinct.copy()
        repeated[-1] = repeated[0]
        sessions += [distinct, repeated]
    sessions.append(np.full(200, 42))
    sessions += [rng.integers(0, 15, int(rng.integers(1, 25))) for _ in range(40)]
    return _from_sessions(list(rng.permutation(np.array(sessions, dtype=object))))


def _wide_aids():
    rng = np.random.default_rng(4)
    top = 2**31 - 1
    sessions = [top - rng.integers(0, 30, int(rng.integers(15, 40))) for _ in range(20)]
    sessions.append(np.concatenate([[0, top], np.arange(1, 24)]))
    return _from_sessions(sessions)


def _one_session():
    return _from_sessions([np.array([5, 7, 5, 9] * 6 + [1, 2, 3])])


def _empty():
    return _from_sessions([])


STORES = {"synthetic": _synthetic, "boundaries": _boundaries, "wide_aids": _wide_aids,
          "one_session": _one_session, "empty": _empty}


def _reference_counts(store: EventStore) -> np.ndarray:
    if store.n_sessions == 0:
        return np.zeros(0, np.int32)
    j = JEventStore.from_flat(store.session_ids[store.session_idx], store.aid, store.ts,
                              store.type, assume_sorted=True)
    return jcov.session_unique_counts(j)


@pytest.mark.parametrize("name", STORES)
def test_session_unique_counts_equal_the_reference(name):
    store = STORES[name]()
    got = tcov.session_unique_counts(store)
    want = _reference_counts(store)
    assert got.dtype == np.int32 and got.shape == (store.n_sessions,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 20, 200])
@pytest.mark.parametrize("name", STORES)
def test_distinct_at_least_equals_the_reference(name, n):
    store = STORES[name]()
    before = dict(tcov.sessions_with_distinct_at_least.sessions)
    got = tcov.sessions_with_distinct_at_least(store, n)
    after = tcov.sessions_with_distinct_at_least.sessions
    assert got.dtype == bool and got.shape == (store.n_sessions,)
    np.testing.assert_array_equal(got, _reference_counts(store) >= n)
    short = int((store.lengths < n).sum())
    assert after["by_length"] - before["by_length"] == short
    assert after["counted"] - before["counted"] == store.n_sessions - short
    if name == "boundaries" and n == 20:  # 20, 21 and 21 with a repeat; the short ones not
        assert got.sum() == 3
