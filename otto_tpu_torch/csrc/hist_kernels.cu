// Histogram kernel for Hopper (sm_90a): node x feature x bin sums of
// (grad, hess, weight), the heart of the GBDT fit.  Plain C entry point,
// loaded with ctypes by otto_tpu_torch/ops/_kernels.py.  It selects the
// tensors' device, launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a refused launch
// is reported to the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K5: the GBDT histogram.
//
// Replaces otto_tpu/models/gbdt.py::_mm_hist (:109) and the scatter branch of
// _grow_tree_impl (:233-266); both are XLA programs in the JAX package, not
// Pallas kernels (the first a one-hot matmul on the MXU through a bf16 hi/lo
// pair).  It computes
//     hist[k, f, b, c] = sum over the rows r of key k of [bin_rf = b] vals_rc
// into float32 [n_keys, F, n_bins, 3], where key k's rows are those a row
// list names: order[start[k] + j] for j < pre[k + 1] - pre[k].  The GBDT keeps
// that list grouped by tree node across the levels of a tree (split stably
// after each level's routing), so a level's left children are stretches of
// it: no sort, no gather of the rows.  A bin of n_bins or more adds nothing.
//
// Deterministic: the sums are integer.  Each column c gets a power-of-two
// scale 2^s_c, the largest with n_rows * max_r |v_rc| * 2^s_c <= 2^61 over all
// n_rows rows of vals (those of every key and of none), so that every value
// rounds to an int64 q = rn(v * 2^s_c) and the sum of n_rows of them stays
// below 2^62 in magnitude.  Integer additions commute, so the order of the
// atomics does not matter, and the launch gives the same bits every time (as
// XGBoost's GPU `hist` does with its quantised gradients).  The result is
// float32(sum q) * 2^-s_c: the sum of the quantised values, rounded once.  A
// value loses at most 2^-(s_c + 1) to the quantisation, a cell at most
// N 2^-(s_c + 1) <= N max|v| 2^-61; where every value is a multiple of 2^-s_c
// (dyadic values) the result is the exact sum, rounded once to float32.  The
// GBDT passes the same vals, n_rows and max |v| at every level of a tree, so
// the scale is the tree's.
//
// What bounds it: bytes on paper (a listed row's 4-byte id, 12 bytes of vals
// and F bytes of bins, against 3 adds a feature), but in practice the 64-bit
// shared-memory atomics and the instructions around them.  The design (the
// first kernel sorted and gathered the rows at every level, walked one
// feature a thread down a stride of single-byte loads, and flushed 8,192-row
// items into device memory; 1.4% of its bound):
// - The rows go to the kernel as a 32-byte aligned copy, uint8 [N, P] with
//   P = F rounded up to 32, made once per fit: a feature group of 32 is one
//   aligned 32-byte sector of a row, read by two lanes with one 16-byte load
//   each, so a listed row, wherever it lies, costs whole sectors (a
//   feature-major copy would read every feature's column at the listed rows,
//   a sector for one byte).
// - A lane owns one feature of the group.  A warp stages 16 listed rows at a
//   time (bins into a 512-byte warp-private tile, vals quantised there once a
//   row and group: three float loads and conversions, cheaper than reading a
//   24-byte int64 copy), then each lane walks its feature down the 16 rows
//   and adds a run of rows in one bin in registers, with shared atomics only
//   where its bin changes.  In one atomic instruction the lanes add into 32
//   different features' cells, so they never meet on a cell, and the
//   features' rows are spaced by an odd number of words so that lanes on
//   equal bins fall in different banks.  The list keeps the rows' order, so a
//   session's candidates come together and its session-level features make
//   long runs.  The next 16 rows are loaded while these are added.
// - An int64 cell is two 32-bit words, added with the card's native 32-bit
//   shared atomics: the low word first, and the high word with the carry that
//   the low word's returned old value shows (each add sees the exact sum
//   before it, so every wrap of the low word is counted once).  A 64-bit
//   shared atomicAdd compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64
//   on sm_90a), which the warps that meet on a crowded cell (the
//   missing-value bin, a count feature's few bins) retry over and over.
// - A block holds [32 features, n_bins, 3] int64 (197 KB at 256 bins) and
//   owns one contiguous share of the launch's work, (group, listed row) pairs
//   ordered by group, key and row: it flushes its sums into the int64
//   histogram in device memory once per (key, group) that its share touches,
//   with 64-bit global atomics on the non-zero cells; one block an SM.  (To
//   combine a thread-block cluster's sums over distributed shared memory
//   before one flush was measured slower: its remote reads cost more than
//   the atomics they save, most at the deep levels' many stretches.)  Rows
//   whose vals are all zero are left off the list by the GBDT (the negatives
//   that negative sampling drops, the bag's left-out rows): they would add 0.
// - A second kernel converts the int64 histogram to float32 (a few MB at the
//   deepest level; it is counted in the launch's time).
// ---------------------------------------------------------------------------

constexpr int HIST_THREADS = 1024;
constexpr int HIST_WARPS = HIST_THREADS / 32;
constexpr int HIST_FG = 32;      // features of a group: one a lane
constexpr int HIST_BATCH = 16;   // rows a warp stages at a time: two lanes a row
constexpr int HIST_MAX_KEYS = 2048;
constexpr int HIST_MAX_BINS = 256;

// the largest s with n_rows * vmax * 2^s <= 2^61 (0 when vmax is 0 or not
// finite)
__device__ __forceinline__ int hist_scale_exp(long long n_rows, float vmax) {
  const double b = (double)n_rows * (double)vmax;
  if (!(b > 0.0) || isinf(b)) return 0;
  int e;
  frexp(b, &e);  // b < 2^e
  return 61 - e;
}

// a feature's row of cells in shared memory: n_bins x 3 int64 as 32-bit
// words (low, high) and one word more, an odd count, so that lanes on equal
// bins of different features fall in different banks
__host__ __device__ inline int hist_feat_words(int n_bins) { return n_bins * 6 + 1; }

__host__ __device__ inline int hist_smem_bytes(int n_bins) {
  return HIST_FG * hist_feat_words(n_bins) * 4 + HIST_WARPS * HIST_BATCH * 3 * 8 +
         HIST_WARPS * HIST_BATCH * HIST_FG;
}

// cell (low, high) += v, in two native 32-bit atomics
__device__ __forceinline__ void add64(uint32_t* cell, unsigned long long v) {
  const uint32_t lo = (uint32_t)v;
  const uint32_t old = atomicAdd(cell, lo);
  atomicAdd(cell + 1, (uint32_t)(v >> 32) + (old + lo < old ? 1u : 0u));
}

// rows uint8 [n_rows, row_bytes] (row_bytes a multiple of 32, 16-byte aligned);
// vals f32 [n_rows, 3]; vmax f32 [3], max |vals| of each column over all
// n_rows; order int32, the row list; start int64 [n_keys], each key's first
// position in it; pre int64 [n_keys + 1], the prefix sums of the keys' row
// counts (pre[0] = 0); acc int64 [n_keys, n_feat, n_bins, 3], zeroed.
__global__ void __launch_bounds__(HIST_THREADS, 1)
    hist_rows_kernel(const uint8_t* __restrict__ rows, const float* __restrict__ vals,
                     const float* __restrict__ vmax, const int* __restrict__ order,
                     const long long* __restrict__ start, const long long* __restrict__ pre,
                     unsigned long long* __restrict__ acc, long long n_rows, int row_bytes,
                     int n_feat, int n_keys, int n_bins) {
  extern __shared__ __align__(16) unsigned long long smem[];
  const int fw = hist_feat_words(n_bins);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long* q_s = reinterpret_cast<long long*>(smem) + warp * HIST_BATCH * 3;  // [16][3]
  uint8_t* bins_s = reinterpret_cast<uint8_t*>(smem + HIST_WARPS * HIST_BATCH * 3) +
                    warp * HIST_BATCH * HIST_FG;                                // [16][32]
  uint32_t* hist_s = reinterpret_cast<uint32_t*>(smem + HIST_WARPS * HIST_BATCH * 3) +
                     HIST_WARPS * HIST_BATCH * HIST_FG / 4;                     // [32][fw]
  const int s0 = hist_scale_exp(n_rows, vmax[0]);
  const int s1 = hist_scale_exp(n_rows, vmax[1]);
  const int s2 = hist_scale_exp(n_rows, vmax[2]);
  const int n_groups = row_bytes / HIST_FG;
  const long long total = pre[n_keys];  // listed rows of all keys
  if (total == 0) return;
  const long long work = total * n_groups;  // (group, listed row) pairs
  const long long u_end = work * (blockIdx.x + 1) / gridDim.x;
  const int cells = n_bins * 3;
  for (long long u = work * blockIdx.x / gridDim.x; u < u_end;) {
    // the (group, key) of pair u, and how far this block's share stays in it
    const int grp = (int)(u / total);
    const long long t = u - grp * total;
    int k = 0;  // the last key with pre[k] <= t
    for (int hi = n_keys - 1; k < hi;) {
      const int mid = (k + hi + 1) >> 1;
      if (pre[mid] <= t) k = mid; else hi = mid - 1;
    }
    const long long end = min(u_end, grp * total + pre[k + 1]);
    const long long a = start[k] + (t - pre[k]);  // list positions a .. a + len
    const long long len = end - u;
    const int f0 = grp * HIST_FG;
    const int fg = min(HIST_FG, n_feat - f0);
    for (int i = threadIdx.x; i < HIST_FG * fw; i += HIST_THREADS) hist_s[i] = 0u;
    __syncthreads();
    {
      // this warp's stretch of the item's rows, 16 at a time
      const long long w0 = a + len * warp / HIST_WARPS, w1 = a + len * (warp + 1) / HIST_WARPS;
      const bool mine = lane < fg;
      uint32_t* my_hist = hist_s + lane * fw;
      int cur = -1;
      unsigned long long sg = 0ull, sh = 0ull, sw = 0ull;
      // lane l loads half l & 1 of the group's sector of row l >> 1, and
      // lane l < 16 the vals of row l
      const int slot = lane >> 1;
      uint4 pend = make_uint4(0u, 0u, 0u, 0u);
      float pv0 = 0.f, pv1 = 0.f, pv2 = 0.f;
      auto fetch = [&](long long p, int n) {
        if (slot < n) {
          const int r = __ldg(order + p + slot);
          pend = __ldg(reinterpret_cast<const uint4*>(rows + (long long)r * row_bytes + f0) +
                       (lane & 1));
        }
        if (lane < n) {
          const int r = __ldg(order + p + lane);
          pv0 = __ldg(vals + (long long)r * 3);
          pv1 = __ldg(vals + (long long)r * 3 + 1);
          pv2 = __ldg(vals + (long long)r * 3 + 2);
        }
      };
      if (w0 < w1) fetch(w0, (int)min((long long)HIST_BATCH, w1 - w0));
      for (long long p = w0; p < w1; p += HIST_BATCH) {
        const int n = (int)min((long long)HIST_BATCH, w1 - p);
        if (slot < n) reinterpret_cast<uint4*>(bins_s)[lane] = pend;
        if (lane < n) {
          q_s[lane * 3] = __float2ll_rn(ldexpf(pv0, s0));
          q_s[lane * 3 + 1] = __float2ll_rn(ldexpf(pv1, s1));
          q_s[lane * 3 + 2] = __float2ll_rn(ldexpf(pv2, s2));
        }
        __syncwarp();
        if (p + HIST_BATCH < w1)  // the next rows' loads, in flight while these add
          fetch(p + HIST_BATCH, (int)min((long long)HIST_BATCH, w1 - p - HIST_BATCH));
        for (int i = 0; i < n; ++i) {
          const int b = bins_s[i * HIST_FG + lane];
          if (b != cur) {
            if (cur >= 0) {
              uint32_t* cell = my_hist + cur * 6;
              add64(cell, sg);
              add64(cell + 2, sh);
              add64(cell + 4, sw);
            }
            cur = (mine && b < n_bins) ? b : -1;
            sg = sh = sw = 0ull;
          }
          sg += (unsigned long long)q_s[i * 3];
          sh += (unsigned long long)q_s[i * 3 + 1];
          sw += (unsigned long long)q_s[i * 3 + 2];
        }
        __syncwarp();
      }
      if (cur >= 0) {
        uint32_t* cell = my_hist + cur * 6;
        add64(cell, sg);
        add64(cell + 2, sh);
        add64(cell + 4, sw);
      }
    }
    __syncthreads();
    // flush: a warp a feature, the non-zero cells into device memory
    for (int f = warp; f < fg; f += HIST_WARPS) {
      unsigned long long* out = acc + ((long long)k * n_feat + f0 + f) * cells;
      const uint32_t* src = hist_s + f * fw;
      for (int j = lane; j < cells; j += 32) {
        const unsigned long long v = ((unsigned long long)src[2 * j + 1] << 32) | src[2 * j];
        if (v != 0ull) atomicAdd(out + j, v);
      }
    }
    __syncthreads();
    u = end;
  }
}

// out f32 = float32(acc) * 2^-s_c, cell by cell
__global__ void hist_finish_kernel(const long long* __restrict__ acc,
                                   const float* __restrict__ vmax, float* __restrict__ out,
                                   long long n_cells, long long n_rows) {
  const int s0 = hist_scale_exp(n_rows, vmax[0]);
  const int s1 = hist_scale_exp(n_rows, vmax[1]);
  const int s2 = hist_scale_exp(n_rows, vmax[2]);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_cells;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % 3);
    out[i] = ldexpf((float)acc[i], -(c == 0 ? s0 : (c == 1 ? s1 : s2)));
  }
}

}  // namespace

extern "C" {

// rows uint8 [n_rows, row_bytes] (row_bytes a multiple of 32 and >= n_feat,
// 16-byte aligned, the features first and zeros after); vals f32 [n_rows, 3];
// vmax f32 [3]; order int32 (the row list); start int64 [n_keys]; pre int64
// [n_keys + 1]; acc int64 [n_keys, n_feat, n_bins, 3] scratch (zeroed here);
// out f32 of that shape.  All device memory.
int build_histogram_rows(const void* rows, const void* vals, const void* vmax,
                         const void* order, const void* start, const void* pre, void* acc,
                         void* out, long long n_rows, int row_bytes, int n_feat, int n_keys,
                         int n_bins, int device, void* stream) {
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES || n_rows < 1 || n_feat < 1 || n_keys < 1 ||
      n_keys > HIST_MAX_KEYS || n_bins < 1 || n_bins > HIST_MAX_BINS ||
      row_bytes % HIST_FG || row_bytes < n_feat || row_bytes - n_feat >= HIST_FG ||
      reinterpret_cast<uintptr_t>(rows) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (sms_of[device] == 0) {
    e = cudaFuncSetAttribute(hist_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             hist_smem_bytes(HIST_MAX_BINS));
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_cells = (long long)n_keys * n_feat * n_bins * 3;
  const cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(acc, 0, n_cells * 8, s);
  if (e != cudaSuccess) return (int)e;
  // one block an SM, each a share of the work (its size is on the device)
  hist_rows_kernel<<<sms_of[device], HIST_THREADS, hist_smem_bytes(n_bins), s>>>(
      static_cast<const uint8_t*>(rows), static_cast<const float*>(vals),
      static_cast<const float*>(vmax), static_cast<const int*>(order),
      static_cast<const long long*>(start), static_cast<const long long*>(pre),
      static_cast<unsigned long long*>(acc), n_rows, row_bytes, n_feat, n_keys, n_bins);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long fin_blocks = (n_cells + 255) / 256;
  hist_finish_kernel<<<(unsigned)(fin_blocks < 4096 ? fin_blocks : 4096), 256, 0, s>>>(
      static_cast<const long long*>(acc), static_cast<const float*>(vmax),
      static_cast<float*>(out), n_cells, n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
