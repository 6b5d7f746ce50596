// Histogram kernel for Hopper (sm_90a): node x feature x bin sums of
// (grad, hess, weight), the heart of the GBDT fit.  Plain C entry point,
// loaded with ctypes by otto_tpu_torch/ops/_kernels.py.  It selects the
// tensors' device, launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a refused launch
// is reported to the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

// ---------------------------------------------------------------------------
// K5: the GBDT histogram.
//
// Replaces otto_tpu/models/gbdt.py::_mm_hist (:109) and the scatter branch of
// _grow_tree_impl (:233-266); both are XLA programs in the JAX package, not
// Pallas kernels (the first a one-hot matmul on the MXU through a bf16 hi/lo
// pair).  It computes
//     hist[k, f, b, c] = sum_r [key_r = k] [bin_rf = b] vals_rc
// over uint8 bins [N, F], keys [N] (a row whose key is outside [0, n_keys)
// adds nothing; -1 marks a right-going row) and float32 vals [N, 3], into
// float32 [n_keys, F, n_bins, 3].
//
// Deterministic: the sums are integer.  Each column c gets a power-of-two
// scale 2^s_c for the launch, the largest with N * max_r |v_rc| * 2^s_c <=
// 2^61, so that every value rounds to an int64 q = rn(v * 2^s_c) and the sum of
// N of them stays below 2^62 in magnitude.  Integer additions commute, so the
// order of the atomics does not matter, and the launch gives the same bits
// every time (as XGBoost's GPU `hist` does with its quantised gradients).  The
// result is float32(sum q) * 2^-s_c: the sum of the quantised values,
// rounded once.  A value loses at most 2^-(s_c + 1) to the quantisation, a cell
// at most N 2^-(s_c + 1) <= N max|v| 2^-61 (far below float32's 2^-24 of the
// cell); where every value is a multiple of 2^-s_c (dyadic values) the result
// is the exact sum, rounded once to float32.
//
// Rows go to the kernel grouped by key (the wrapper sorts them), so a stretch
// of rows adds into one key's histogram.  A work item is one key, up to
// HIST_ITEM_ROWS of its rows, and a group of HIST_FG features; a persistent
// grid walks the items.  A block keeps the item's [HIST_FG, n_bins, 3] int64
// sums in shared memory (48 KB at 256 bins: the level-6 left-children
// histogram, 32 x 55 x 256 x 3 float32 = 5.4 MB, is far larger than shared
// memory, so a block holds one slice), stages HIST_SUB rows' quantised vals
// at a time, and adds them with 64-bit shared atomics; at the end of the item it adds its non-zero sums into the
// int64 histogram in device memory with 64-bit global atomics.  A second
// kernel converts that to float32.  A thread walks one feature down a stride
// of rows and sums a run of rows that fall in one bin in registers first, so
// a feature crowded into few bins costs fewer atomics.
//
// What bounds it: bytes on paper (the bins are read once, N F bytes, against
// 3 adds a byte), but the shared-memory atomics set the pace in this simple
// design: three 64-bit atomics a run of rows in one bin, issued one at a
// time where threads hit one cell.  wgmma, TMA and a faster layout are for a
// later change.
// ---------------------------------------------------------------------------

constexpr int HIST_THREADS = 256;
constexpr int HIST_FG = 8;             // features of a work item
constexpr int HIST_SUB = 512;          // rows staged at a time
constexpr int HIST_ITEM_ROWS = 8192;   // rows of a work item
constexpr int HIST_MAX_KEYS = 2048;
constexpr int HIST_MAX_BINS = 256;
constexpr int HIST_STRIDE = HIST_THREADS / HIST_FG;  // rows between a thread's rows

__device__ __forceinline__ void hist_add(unsigned long long* cell, unsigned long long g,
                                         unsigned long long h, unsigned long long w) {
  atomicAdd(cell, g);
  atomicAdd(cell + 1, h);
  atomicAdd(cell + 2, w);
}

// the largest s with n_rows * vmax * 2^s <= 2^61 (0 when vmax is 0 or not
// finite)
__device__ __forceinline__ int hist_scale_exp(long long n_rows, float vmax) {
  const double b = (double)n_rows * (double)vmax;
  if (!(b > 0.0) || isinf(b)) return 0;
  int e;
  frexp(b, &e);  // b < 2^e
  return 61 - e;
}

__host__ __device__ inline int hist_smem_bytes(int n_bins, int n_keys) {
  return (HIST_FG * n_bins * 3 + HIST_SUB * 3 + n_keys + 1) * 8;
}

// binned uint8 [n_rows, n_feat], vals f32 [n_rows, 3], both ordered by key;
// seg int64 [n_keys + 1], the first row of each key (rows seg[k] .. seg[k+1]
// have key k); vmax f32 [3], max |vals| of each column; acc int64 [n_keys,
// n_feat, n_bins, 3], zeroed.
__global__ void __launch_bounds__(HIST_THREADS, 3)
    hist_accumulate_kernel(const uint8_t* __restrict__ binned, const float* __restrict__ vals,
                           const long long* __restrict__ seg, const float* __restrict__ vmax,
                           unsigned long long* __restrict__ acc, long long n_rows, int n_feat,
                           int n_keys, int n_bins) {
  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned long long* acc_s = smem;                              // [HIST_FG, n_bins, 3]
  unsigned long long* q_s = acc_s + HIST_FG * n_bins * 3;       // [HIST_SUB, 3]
  long long* tile_off = reinterpret_cast<long long*>(q_s + HIST_SUB * 3);  // [n_keys + 1]
  const int tid = threadIdx.x;
  const int s0 = hist_scale_exp(n_rows, vmax[0]);
  const int s1 = hist_scale_exp(n_rows, vmax[1]);
  const int s2 = hist_scale_exp(n_rows, vmax[2]);
  if (tid == 0) {  // the first item of each key
    long long t = 0;
    for (int k = 0; k < n_keys; ++k) {
      tile_off[k] = t;
      t += (seg[k + 1] - seg[k] + HIST_ITEM_ROWS - 1) / HIST_ITEM_ROWS;
    }
    tile_off[n_keys] = t;
  }
  __syncthreads();
  const int n_groups = (n_feat + HIST_FG - 1) / HIST_FG;
  const long long n_items = tile_off[n_keys] * n_groups;
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int f0 = (int)(item % n_groups) * HIST_FG;
    const int fg = min(HIST_FG, n_feat - f0);
    const long long tile = item / n_groups;
    int k = 0;  // the last key whose first item is at or before this one
    for (int hi = n_keys - 1; k < hi;) {
      const int mid = (k + hi + 1) >> 1;
      if (tile_off[mid] <= tile) k = mid; else hi = mid - 1;
    }
    const long long r0 = seg[k] + (tile - tile_off[k]) * HIST_ITEM_ROWS;
    const long long r1 = min(seg[k + 1], r0 + HIST_ITEM_ROWS);
    const int cells = fg * n_bins * 3;
    for (int i = tid; i < cells; i += HIST_THREADS) acc_s[i] = 0ull;
    for (long long a = r0; a < r1; a += HIST_SUB) {
      const int n = (int)min((long long)HIST_SUB, r1 - a);
      for (int i = tid; i < n * 3; i += HIST_THREADS) {
        const int c = i % 3;
        const float v = vals[a * 3 + i];
        q_s[i] = (unsigned long long)__float2ll_rn(ldexpf(v, c == 0 ? s0 : (c == 1 ? s1 : s2)));
      }
      __syncthreads();
      // a thread walks one feature down every HIST_STRIDE-th row (a warp:
      // 32 / HIST_FG rows x HIST_FG features at a time) and sums a run of
      // rows in one bin in registers before its atomics: real features crowd
      // into few bins (missing values, counts), and lanes adding to one cell
      // serialise
      if (tid % HIST_FG < fg) {
        const int j = tid % HIST_FG;
        const uint8_t* col = binned + a * n_feat + f0 + j;
        int cur = -1;
        unsigned long long run_g = 0ull, run_h = 0ull, run_w = 0ull;
        for (int i = tid / HIST_FG; i < n; i += HIST_STRIDE) {
          const int b = col[(long long)i * n_feat];
          if (b != cur) {
            if (cur >= 0) hist_add(acc_s + (j * n_bins + cur) * 3, run_g, run_h, run_w);
            cur = b < n_bins ? b : -1;
            run_g = run_h = run_w = 0ull;
          }
          run_g += q_s[i * 3];
          run_h += q_s[i * 3 + 1];
          run_w += q_s[i * 3 + 2];
        }
        if (cur >= 0) hist_add(acc_s + (j * n_bins + cur) * 3, run_g, run_h, run_w);
      }
      __syncthreads();
    }
    unsigned long long* out = acc + ((long long)k * n_feat + f0) * n_bins * 3;
    for (int i = tid; i < cells; i += HIST_THREADS) {
      const unsigned long long v = acc_s[i];
      if (v != 0ull) atomicAdd(out + i, v);
    }
    __syncthreads();
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

// binned uint8 [n_rows, n_feat] and vals f32 [n_rows, 3], ordered by key; seg
// int64 [n_keys + 1] (rows seg[k] .. seg[k+1] have key k); vmax f32 [3];
// acc int64 [n_keys, n_feat, n_bins, 3] scratch (zeroed here); out f32 of
// that shape.  All device memory.
int build_histogram_f32(const void* binned, const void* vals, const void* seg, const void* vmax,
                        void* acc, void* out, long long n_rows, int n_feat, int n_keys,
                        int n_bins, int device, void* stream) {
  constexpr int MAX_DEVICES = 64;
  static int grid_for[MAX_DEVICES] = {};  // resident blocks on the card, per device
  if (device < 0 || device >= MAX_DEVICES || n_rows < 1 || n_feat < 1 || n_keys < 1 ||
      n_keys > HIST_MAX_KEYS || n_bins < 1 || n_bins > HIST_MAX_BINS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int max_smem = hist_smem_bytes(HIST_MAX_BINS, HIST_MAX_KEYS);
  if (grid_for[device] == 0) {
    e = cudaFuncSetAttribute(hist_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hist_accumulate_kernel, HIST_THREADS, hist_smem_bytes(HIST_MAX_BINS, 64));
    if (e != cudaSuccess) return (int)e;
    grid_for[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long n_cells = (long long)n_keys * n_feat * n_bins * 3;
  const cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(acc, 0, n_cells * 8, s);
  if (e != cudaSuccess) return (int)e;
  // no more items than rows allow: each key's last item may be short
  const long long n_groups = (n_feat + HIST_FG - 1) / HIST_FG;
  const long long items = ((n_rows + HIST_ITEM_ROWS - 1) / HIST_ITEM_ROWS + n_keys) * n_groups;
  const int grid = (int)(items < grid_for[device] ? items : grid_for[device]);
  hist_accumulate_kernel<<<grid, HIST_THREADS, hist_smem_bytes(n_bins, n_keys), s>>>(
      static_cast<const uint8_t*>(binned), static_cast<const float*>(vals),
      static_cast<const long long*>(seg), static_cast<const float*>(vmax),
      static_cast<unsigned long long*>(acc), n_rows, n_feat, n_keys, n_bins);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long fin_blocks = (n_cells + 255) / 256;
  hist_finish_kernel<<<(unsigned)(fin_blocks < 4096 ? fin_blocks : 4096), 256, 0, s>>>(
      static_cast<const long long*>(acc), static_cast<const float*>(vmax),
      static_cast<float*>(out), n_cells, n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
