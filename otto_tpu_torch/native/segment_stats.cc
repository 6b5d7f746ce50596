// Native fused segment statistics for the feature-engineering plane.
//
// The reference computes its ~240 per-aid features as pandas/polars
// groupby-agg chains (src/ranker/aid_feature_engineering.py:57-139), each
// statistic a separate pass over the event table; the numpy path in
// otto_tpu_torch/features/base.py mirrors that (one bincount-style pass per
// statistic, ~15 passes per aggregate block, ~12 blocks).  This engine fuses
// one whole block — count, session-nunique, day-of-year-nunique, ts min/max,
// and sum/sum-of-squares for V value columns — into a SINGLE pass over the
// event arrays, masked sub-blocks included (no host-side column slicing).
//
// Concurrency: the group-id space is split into T disjoint ranges; every
// thread streams the full event arrays chunk-by-chunk and accumulates only
// the ids in its range, so all writes (including the shared nunique scratch)
// are race-free without atomics.  Reads are shared and sequential.
//
// Semantics notes (must match features/base.py):
//   * session_nunique relies on events being session-sorted (EventStore
//     invariant): "last seen session per group != current" counts exactly the
//     distinct (group, session) pairs.
//   * day_of_year in [1, 366] -> exact 384-bit bitmap per group.
//   * accumulation in double, matching numpy's bincount(weights=f64).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {
constexpr int kDayWords = 6;  // 384 bits >= 366 possible day_of_year values
constexpr int64_t kChunk = 8192;
}  // namespace

extern "C" void otto_block_stats(
    const int64_t* ids,      // [n_events] group id per event
    const uint8_t* mask,     // [n_events] 0/1 include flag, or nullptr
    const int64_t* sess,     // [n_events] session idx (sorted), or nullptr
    const int32_t* day,      // [n_events] day_of_year, or nullptr
    const double* ts,        // [n_events] timestamps, or nullptr
    const double* cols,      // [n_cols][n_events] column-major value columns
    int32_t n_cols, int64_t n_events, int64_t n_groups, int32_t n_threads,
    double* count,           // [n_groups]
    double* sess_nu,         // [n_groups] (if sess)
    double* day_nu,          // [n_groups] (if day)
    double* ts_min,          // [n_groups] (if ts) — +inf where absent
    double* ts_max,          // [n_groups] (if ts) — -inf where absent
    double* sums,            // [n_cols][n_groups]
    double* sumsqs) {        // [n_cols][n_groups]
  std::fill(count, count + n_groups, 0.0);
  if (sess) std::fill(sess_nu, sess_nu + n_groups, 0.0);
  if (day) std::fill(day_nu, day_nu + n_groups, 0.0);
  if (ts) {
    std::fill(ts_min, ts_min + n_groups, 1e300);
    std::fill(ts_max, ts_max + n_groups, -1e300);
  }
  std::fill(sums, sums + (int64_t)n_cols * n_groups, 0.0);
  std::fill(sumsqs, sumsqs + (int64_t)n_cols * n_groups, 0.0);

  std::vector<int64_t> last_sess;
  std::vector<uint64_t> day_bits;
  if (sess) last_sess.assign(n_groups, -1);
  if (day) day_bits.assign((size_t)n_groups * kDayWords, 0);

  if (n_threads < 1) n_threads = 1;
  if (n_threads > 64) n_threads = 64;

  auto worker = [&](int64_t g_lo, int64_t g_hi) {
    uint8_t take[kChunk];
    for (int64_t base = 0; base < n_events; base += kChunk) {
      const int64_t m = std::min(kChunk, n_events - base);
      // pass 1: membership + the scalar statistics
      for (int64_t i = 0; i < m; ++i) {
        const int64_t e = base + i;
        const int64_t g = ids[e];
        const bool in = (g >= g_lo) & (g < g_hi) & (!mask || mask[e]);
        take[i] = (uint8_t)in;
        if (!in) continue;
        count[g] += 1.0;
        if (sess) {
          if (last_sess[g] != sess[e]) {
            sess_nu[g] += 1.0;
            last_sess[g] = sess[e];
          }
        }
        if (day) {
          const uint32_t d = (uint32_t)day[e] % (kDayWords * 64);
          uint64_t& w = day_bits[(size_t)g * kDayWords + (d >> 6)];
          const uint64_t b = 1ull << (d & 63);
          if (!(w & b)) {
            day_nu[g] += 1.0;
            w |= b;
          }
        }
        if (ts) {
          const double t = ts[e];
          if (t < ts_min[g]) ts_min[g] = t;
          if (t > ts_max[g]) ts_max[g] = t;
        }
      }
      // pass 2: per column, streaming reads stay chunk-local
      for (int32_t c = 0; c < n_cols; ++c) {
        const double* col = cols + (int64_t)c * n_events + base;
        double* s = sums + (int64_t)c * n_groups;
        double* q = sumsqs + (int64_t)c * n_groups;
        for (int64_t i = 0; i < m; ++i) {
          if (!take[i]) continue;
          const int64_t g = ids[base + i];
          const double v = col[i];
          s[g] += v;
          q[g] += v * v;
        }
      }
    }
  };

  if (n_threads == 1 || n_groups < 2 * n_threads) {
    worker(0, n_groups);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t per = (n_groups + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = (int64_t)t * per;
    const int64_t hi = std::min(lo + per, n_groups);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}
