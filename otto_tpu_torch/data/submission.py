"""Kaggle submission writer.

Copied from ``otto_tpu/data/submission.py`` (numpy, ctypes).  Format
(reference: src/baseline/aid_frequency.py:108-115): rows
``"{session}_{clicks|carts|orders}", "aid1 aid2 ... aid20"`` in a gzip CSV
with header ``session_type,labels``.

The hot path is a native C++ formatter + zlib stream
(``otto_tpu_torch/native/submission_writer.cc``, built with ``g++ ... -lz``
at first use into ``otto_tpu_torch/_build/``): the Python loop formats ~44M
rows at full OTTO scale; the native writer is ~2 orders of magnitude
faster.  One change from the JAX package: a failed build or write raises.
The Python writer runs only when asked for with ``force_python=True``.
"""

from __future__ import annotations

import ctypes
import gzip
from pathlib import Path

import numpy as np

from otto_tpu_torch import EVENT_TYPES
from otto_tpu_torch.utils.native import load_library

GZIP_LEVEL = 6  # the native writer's deflate level


def _load_native() -> ctypes.CDLL:
    lib = load_library("submission_writer.cc", "otto_submission", ("-lz",),
                       python_route="write_submission(..., force_python=True)")
    lib.otto_write_submission.restype = ctypes.c_int64
    lib.otto_write_submission.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int,
    ]
    return lib


def _write_native(path: Path, session_ids: np.ndarray,
                  predictions: dict[str, np.ndarray]) -> None:
    lib = _load_native()
    S = len(session_ids)
    K = max(predictions[t].shape[1] for t in EVENT_TYPES)
    stacked = np.full((3, S, K), -1, np.int32)
    for i, etype in enumerate(EVENT_TYPES):
        p = predictions[etype]
        stacked[i, :, : p.shape[1]] = p
    sids = np.ascontiguousarray(session_ids, dtype=np.int64)
    rows = lib.otto_write_submission(
        str(path).encode(),
        sids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), S,
        stacked.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), K,
        GZIP_LEVEL,
    )
    if rows != S * 3:
        raise OSError(f"native submission writer failed on {path} (returned {rows}, "
                      f"expected {S * 3} rows)")


def _write_python(path: Path, session_ids: np.ndarray,
                  predictions: dict[str, np.ndarray]) -> None:
    with gzip.open(path, "wt", newline="") as f:
        f.write("session_type,labels\n")
        per_type_rows = {}
        for etype in EVENT_TYPES:
            preds = predictions[etype]
            rows = []
            for s in range(preds.shape[0]):
                row = preds[s]
                rows.append(" ".join(str(int(a)) for a in row[row >= 0]))
            per_type_rows[etype] = rows
        for s, sid in enumerate(session_ids):
            for etype in EVENT_TYPES:
                f.write(f"{int(sid)}_{etype},{per_type_rows[etype][s]}\n")


def write_submission(
    path: str | Path,
    session_ids: np.ndarray,
    predictions: dict[str, np.ndarray],
    force_python: bool = False,
) -> None:
    """``predictions`` maps event type name ('clicks'/'carts'/'orders') to an
    ``[S, <=20]`` int array padded with -1.  ``force_python=True`` writes
    through Python's ``gzip`` instead of the native writer (the same text)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    write = _write_python if force_python else _write_native
    write(path, np.asarray(session_ids), predictions)


def read_submission(path: str | Path) -> dict[str, dict[int, list[int]]]:
    """Inverse of :func:`write_submission`."""
    out: dict[str, dict[int, list[int]]] = {t: {} for t in EVENT_TYPES}
    with gzip.open(path, "rt") as f:
        header = f.readline()
        if header.strip() != "session_type,labels":
            raise ValueError(f"{path}: not a submission file (header {header.strip()!r})")
        for line in f:
            session_type, labels = line.rstrip("\n").split(",", 1)
            sid, etype = session_type.rsplit("_", 1)
            out[etype][int(sid)] = [int(a) for a in labels.split()] if labels else []
    return out
