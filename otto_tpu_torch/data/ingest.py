"""JSONL ingest: raw OTTO ``train.jsonl``/``test.jsonl`` -> EventStore.

Copied from ``otto_tpu/data/ingest.py`` (numpy, ctypes).  It replaces
src/utilities/dataset_writer_pickle.py (streamed pandas read_json +
pure-Python per-event explode).  The hot path is a native C++ scanner
(``otto_tpu_torch/native/jsonl_parser.cc``), built with ``g++`` at first use
into ``otto_tpu_torch/_build/`` (:mod:`otto_tpu_torch.utils.native`).

One change from the JAX package: a failed build or a failed parse raises.
The pure-Python parser runs only when asked for with ``force_python=True``.
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path

import numpy as np

from otto_tpu_torch.data.events import EventStore
from otto_tpu_torch.logging_utils import get_logger
from otto_tpu_torch.utils.native import load_library

log = get_logger(__name__)

_TYPE_DICT = {"clicks": 0, "carts": 1, "orders": 2}


def _load_native() -> ctypes.CDLL:
    lib = load_library("jsonl_parser.cc", "otto_jsonl",
                       python_route="read_jsonl(..., force_python=True)")
    lib.otto_parse_file.restype = ctypes.c_void_p
    lib.otto_parse_file.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.otto_fill.restype = None
    lib.otto_fill.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int8),
    ]
    lib.otto_free.restype = None
    lib.otto_free.argtypes = [ctypes.c_void_p]
    return lib


def _parse_native(path: str | Path) -> tuple[np.ndarray, ...]:
    lib = _load_native()
    n = ctypes.c_int64()
    handle = lib.otto_parse_file(str(path).encode(), ctypes.byref(n))
    if not handle:
        raise OSError(f"native jsonl parser could not read {path} (code {n.value})")
    try:
        session = np.empty(n.value, np.int64)
        aid = np.empty(n.value, np.int32)
        ts = np.empty(n.value, np.int64)
        typ = np.empty(n.value, np.int8)
        lib.otto_fill(
            handle,
            session.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            aid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            typ.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        )
    finally:
        lib.otto_free(handle)
    return session, aid, ts, typ


def _parse_python(path: str | Path) -> tuple[np.ndarray, ...]:
    sessions, aids, tss, types = [], [], [], []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            s = row["session"]
            for ev in row["events"]:
                sessions.append(s)
                aids.append(ev["aid"])
                tss.append(ev["ts"])
                types.append(_TYPE_DICT[ev["type"]])
    return (
        np.asarray(sessions, np.int64),
        np.asarray(aids, np.int32),
        np.asarray(tss, np.int64),
        np.asarray(types, np.int8),
    )


def read_jsonl(path: str | Path, ts_unit: str = "ms", force_python: bool = False) -> EventStore:
    """Parse an OTTO JSONL file into an EventStore.

    ``ts_unit='ms'`` divides millisecond timestamps down to seconds (the
    reference later does ``ts / 1000`` in several places,
    e.g. interaction_feature_engineering.py:46).  ``force_python=True``
    parses in Python instead of the native scanner."""
    session, aid, ts, typ = _parse_python(path) if force_python else _parse_native(path)
    if ts_unit == "ms":
        ts = ts // 1000
    log.info("ingested %s: %d events, %d sessions", path, len(aid), len(np.unique(session)))
    return EventStore.from_flat(session, aid, ts, typ)
