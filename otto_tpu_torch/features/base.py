"""Shared feature-engineering primitives: grouped aggregations over flat id
columns, calendar decomposition, and percentile ranks.

Copied from ``otto_tpu/features/base.py`` (numpy).  The reference's FE
stages are pandas/polars groupby-agg chains
(src/ranker/aid_feature_engineering.py, session_feature_engineering.py,
interaction_feature_engineering.py); here the same statistics come from
vectorized segment reductions over id columns on the host.

One change from the JAX package: the fused block-statistics engine
(``otto_tpu_torch/native/segment_stats.cc``, built with ``g++`` at first use
into ``otto_tpu_torch/_build/``) is required.  A failed build raises; the
numpy path of :func:`block_stats` runs only when the caller asks for it with
``force_numpy=True``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from otto_tpu_torch.utils.native import load_library

SECONDS_PER_DAY = 86400
TZ_OFFSET = 2 * 60 * 60  # the reference shifts timestamps by +2h (CET)


def calendar(ts: np.ndarray) -> dict[str, np.ndarray]:
    """hour / day_of_week / day_of_year / week_of_year from epoch seconds
    (aid_feature_engineering.py:43-47 semantics, pandas-compatible)."""
    t = ts.astype("int64") + TZ_OFFSET
    days = t // SECONDS_PER_DAY
    hour = ((t % SECONDS_PER_DAY) // 3600).astype(np.int32)
    # 1970-01-01 was a Thursday; pandas dayofweek: Monday=0
    day_of_week = ((days + 3) % 7).astype(np.int32)
    dt = days.astype("datetime64[D]")
    years = dt.astype("datetime64[Y]")
    day_of_year = (dt - years).astype(np.int64).astype(np.int32) + 1
    # ISO week of year (pandas isocalendar().week)
    dt_days = dt.astype(np.int64)
    thursday = dt_days - ((dt_days + 3) % 7) + 3  # Thursday of this ISO week
    iso_year_start = (thursday.astype("datetime64[D]").astype("datetime64[Y]")).astype("datetime64[D]").astype(np.int64)
    week = ((thursday - iso_year_start) // 7 + 1).astype(np.int32)
    return {
        "hour": hour,
        "day_of_week": day_of_week,
        "day_of_year": day_of_year,
        "week_of_year": week,
    }


def seg_sum(ids, values, n) -> np.ndarray:
    return np.bincount(ids, weights=values, minlength=n)[:n]


def seg_count(ids, n) -> np.ndarray:
    return np.bincount(ids, minlength=n)[:n].astype(np.float64)


def seg_mean(ids, values, n) -> np.ndarray:
    c = seg_count(ids, n)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(c > 0, seg_sum(ids, values, n) / c, np.nan)


def seg_std(ids, values, n) -> np.ndarray:
    """Sample std (ddof=1, pandas default); NaN for groups of size < 2."""
    c = seg_count(ids, n)
    m = seg_mean(ids, values, n)
    ss = seg_sum(ids, np.asarray(values, np.float64) ** 2, n)
    with np.errstate(invalid="ignore", divide="ignore"):
        var = (ss - c * m**2) / (c - 1)
    return np.where(c > 1, np.sqrt(np.maximum(var, 0)), np.nan)


def seg_min(ids, values, n, fill=np.nan) -> np.ndarray:
    out = np.full(n, np.inf)
    np.minimum.at(out, ids, values)
    return np.where(np.isfinite(out), out, fill)


def seg_max(ids, values, n, fill=np.nan) -> np.ndarray:
    out = np.full(n, -np.inf)
    np.maximum.at(out, ids, values)
    return np.where(np.isfinite(out), out, fill)


def seg_last(ids, values, n, fill=np.nan) -> np.ndarray:
    """Last value per group, given rows in chronological order."""
    out = np.full(n, fill, dtype=np.float64)
    out[ids] = values  # later rows overwrite earlier ones
    return out


def seg_nanmean(ids, values, n) -> np.ndarray:
    """NaN-skipping mean per group (pandas/polars null-skipping ``mean``);
    NaN where the group has no finite value."""
    v = np.asarray(values, np.float64)
    ok = ~np.isnan(v)
    c = seg_count(ids[ok], n)
    s = seg_sum(ids[ok], v[ok], n)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(c > 0, s / c, np.nan)


def seg_nanlast(ids, values, n, fill=np.nan) -> np.ndarray:
    """Last NON-NULL value per group (pandas ``GroupBy.last`` skipna
    semantics), given rows in chronological order."""
    v = np.asarray(values, np.float64)
    ok = ~np.isnan(v)
    out = np.full(n, fill, dtype=np.float64)
    out[ids[ok]] = v[ok]
    return out


def seg_nanmax(ids, values, n) -> np.ndarray:
    """NaN-skipping max per group; NaN where the group has no finite value."""
    v = np.asarray(values, np.float64)
    ok = ~np.isnan(v)
    out = np.full(n, -np.inf)
    np.maximum.at(out, ids[ok], v[ok])
    return np.where(np.isfinite(out), out, np.nan)


def seg_nunique(ids, values, n) -> np.ndarray:
    """Distinct-value count per group."""
    if len(ids) == 0:
        return np.zeros(n)
    pairs = ids.astype(np.int64) * (np.int64(values.max()) + 1 if len(values) else 1) + values.astype(np.int64)
    order = np.argsort(pairs, kind="stable")
    sp = pairs[order]
    head = np.concatenate([[True], sp[1:] != sp[:-1]])
    return np.bincount(ids[order][head], minlength=n)[:n].astype(np.float64)


def rank_pct(values: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
    """pandas ``rank(pct=True)``: average rank of each value divided by the
    count of non-NaN entries."""
    v = np.asarray(values, np.float64)
    valid = ~np.isnan(v) if mask is None else (mask & ~np.isnan(v))
    n = valid.sum()
    out = np.full(len(v), np.nan)
    if n == 0:
        return out
    vv = v[valid]
    order = np.argsort(vv, kind="stable")
    sorted_v = vv[order]
    idx = np.arange(1, n + 1, dtype=np.float64)
    head = np.concatenate([[True], sorted_v[1:] != sorted_v[:-1]])
    group = np.cumsum(head) - 1
    gsum = np.bincount(group, weights=idx)
    gcnt = np.bincount(group)
    ranks = np.empty(n)
    ranks[order] = (gsum / gcnt)[group]
    out[valid] = ranks / n
    return out


# ---------------------------------------------------------------------------
# Fused block statistics (native engine; numpy on request)
# ---------------------------------------------------------------------------

def _load_segstats() -> ctypes.CDLL:
    """Build (``g++``, first use) and load the fused segment-stats engine.
    Raises with the compiler's output if the build fails."""
    lib = load_library("segment_stats.cc", "otto_segstats",
                       python_route="block_stats(..., force_numpy=True)")
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p8 = ctypes.POINTER(ctypes.c_uint8)
    pd = ctypes.POINTER(ctypes.c_double)
    lib.otto_block_stats.restype = None
    lib.otto_block_stats.argtypes = [
        p64, p8, p64, p32, pd, pd,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        pd, pd, pd, pd, pd, pd, pd,
    ]
    return lib


def block_stats(ids, sess, day, ts, cols, n, mask=None, force_numpy=False):
    """One fused pass over the event arrays: per-group ``count``,
    ``sess_nunique`` (events must be session-sorted), ``day_nunique``,
    ``ts_min``/``ts_max`` (NaN where the group is absent), and
    ``sums``/``sumsqs`` [n_cols, n] for the value columns.

    ``cols`` is a C-contiguous [n_cols, n_events] float64 matrix; ``mask``
    selects the participating events without slicing any column.  Native
    engine: otto_tpu_torch/native/segment_stats.cc (single streaming pass,
    group-range threaded); ``force_numpy=True`` computes the same outputs in
    numpy, one pass per statistic.
    """
    ids = np.ascontiguousarray(ids, np.int64)
    n_events = len(ids)
    cols = np.ascontiguousarray(cols, np.float64)
    n_cols = cols.shape[0] if cols.size else 0
    if not force_numpy:
        lib = _load_segstats()
        sess_c = np.ascontiguousarray(sess, np.int64)
        day_c = np.ascontiguousarray(day, np.int32)
        ts_c = np.ascontiguousarray(ts, np.float64)
        mask_c = None
        if mask is not None:
            mask_c = np.ascontiguousarray(mask, np.uint8)
        count = np.empty(n, np.float64)
        sess_nu = np.empty(n, np.float64)
        day_nu = np.empty(n, np.float64)
        ts_min = np.empty(n, np.float64)
        ts_max = np.empty(n, np.float64)
        sums = np.empty((max(n_cols, 1), n), np.float64)
        sumsqs = np.empty((max(n_cols, 1), n), np.float64)
        pd = ctypes.POINTER(ctypes.c_double)
        p8 = ctypes.POINTER(ctypes.c_uint8)
        lib.otto_block_stats(
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            mask_c.ctypes.data_as(p8) if mask_c is not None else None,
            sess_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            day_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ts_c.ctypes.data_as(pd),
            cols.ctypes.data_as(pd),
            np.int32(n_cols), np.int64(n_events), np.int64(n),
            np.int32(min(os.cpu_count() or 1, 8)),
            count.ctypes.data_as(pd), sess_nu.ctypes.data_as(pd),
            day_nu.ctypes.data_as(pd), ts_min.ctypes.data_as(pd),
            ts_max.ctypes.data_as(pd), sums.ctypes.data_as(pd),
            sumsqs.ctypes.data_as(pd),
        )
        absent = count == 0
        ts_min[absent] = np.nan
        ts_max[absent] = np.nan
        return count, sess_nu, day_nu, ts_min, ts_max, sums[:n_cols], sumsqs[:n_cols]

    # ---- numpy: same outputs, one pass per statistic ----------------------
    if mask is not None:
        sel = np.asarray(mask, bool)
        ids_m = ids[sel]
        sess_m = np.asarray(sess)[sel]
        day_m = np.asarray(day)[sel]
        ts_m = np.asarray(ts)[sel]
        cols_m = cols[:, sel]
    else:
        ids_m, sess_m, day_m, ts_m, cols_m = ids, np.asarray(sess), np.asarray(day), np.asarray(ts), cols
    count = seg_count(ids_m, n)
    sess_nu = seg_nunique(ids_m, sess_m, n)
    day_nu = seg_nunique(ids_m, day_m, n)
    ts_min = seg_min(ids_m, ts_m, n)
    ts_max = seg_max(ids_m, ts_m, n)
    sums = np.stack([seg_sum(ids_m, c, n) for c in cols_m]) if n_cols else np.zeros((0, n))
    sumsqs = np.stack([seg_sum(ids_m, c.astype(np.float64) ** 2, n) for c in cols_m]) if n_cols else np.zeros((0, n))
    return count, sess_nu, day_nu, ts_min, ts_max, sums, sumsqs


def mean_from_sums(s, c):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(c > 0, s / c, np.nan)


def std_from_sums(s, ss, c):
    """Sample std (ddof=1) from sum / sum-of-squares / count; NaN below 2."""
    with np.errstate(invalid="ignore", divide="ignore"):
        m = s / c
        var = (ss - c * m * m) / (c - 1)
        return np.where(c > 1, np.sqrt(np.maximum(var, 0)), np.nan)
