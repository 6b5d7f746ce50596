// Forest kernels for Hopper (sm_90a): fold-averaged GBDT scores over binned
// rows.  Plain C entry point, loaded with ctypes by
// otto_tpu_torch/ops/_kernels.py.  It selects the tensors' device, launches
// on the caller's stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() so that a refused launch is reported to the
// wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

// ---------------------------------------------------------------------------
// K4: forest routing.
//
// Replaces otto_tpu/models/gbdt.py::_predict_forest (an XLA program in the
// JAX package, not a Pallas kernel: a lax.scan over trees, dispatched once
// per fold and per 1<<20-row batch) and the fold loop of
// GBDTRankerModel.predict_binned_folds.  One launch routes every fold of one
// model over all rows.  Per row of F uint8 bins and per fold f:
//     s_f = base[f] + leaf_0 + leaf_1 + ...   (tree order, float32)
// where a tree's leaf is found by `pos = 2 pos + (bin[feat[i]] > thr[i])`,
// i = 2^level - 1 + pos, for each of its DEPTH levels; then
//     out = (s_0 + s_1 + ...) * inv           (folds in order, inv = f32(1/n))
// That is the reference's order of float32 operations, so the result is
// bit-equal to the plain twin's and the JAX package's.
//
// Layout: a node is one uint32, (thr << 16) | feat.  thr reaches n_bins
// (256) at nodes that do not split (every bin goes left), so it needs more
// than 8 bits; feat < F.  Leaves are float32 [T, 2^DEPTH].  All folds' trees
// are concatenated in fold order; fold_end[f] is fold f's end.
//
// Design (the simple kernel): one thread a row, 128 rows a block.  The
// block's rows are one contiguous run of 128 F bytes (F = 55 on the main
// path, an unaligned stride), copied into shared memory by coalesced byte
// loads; each thread then reads its row's bins from there.  The trees are
// read through the read-only cache: every thread of the block walks the same
// tree at once, so a level touches at most 2^level nodes of one ~1 KB tree,
// and the model (~200-290 KB on the main path) stays in L1/L2.  A thread
// walks four trees side by side (four independent chains of dependent
// loads) and adds their leaves in tree order.
//
// What bounds it: operations.  A row costs T x DEPTH node steps (1,472,000
// rows x 280 trees x 7 levels = 2.9e9 at the main path's shape) against
// ~60 bytes of input and 4 of output, so the bytes' time (0.026 ms) is far
// below the steps' (~0.17 ms at one int32 operation a step); each step is a
// dependent load of a node, a shared-memory load of a bin, a compare and a
// shift-add.  Keeping a model resident in shared memory, and packing nodes
// in 2 bytes, are left for a later version.
// ---------------------------------------------------------------------------

constexpr int K4_ROWS = 128;      // threads (rows) a block
constexpr int K4_TREES = 4;       // trees a thread walks side by side
constexpr int K4_SMEM = 48 * 1024;

template <int DEPTH>
__device__ __forceinline__ int route(const uint8_t* row, const uint32_t* __restrict__ tree) {
  int pos = 0;
#pragma unroll
  for (int l = 0; l < DEPTH; ++l) {
    const uint32_t node = __ldg(tree + (1 << l) - 1 + pos);
    pos = 2 * pos + ((int)row[node & 0xFFFFu] > (int)(node >> 16) ? 1 : 0);
  }
  return pos;
}

template <int DEPTH>
__global__ void __launch_bounds__(K4_ROWS)
    predict_forest_kernel(const uint8_t* __restrict__ x, const uint32_t* __restrict__ nodes,
                          const float* __restrict__ leaves, const int* __restrict__ fold_end,
                          const float* __restrict__ base, float* __restrict__ out,
                          long long n_rows, int n_feat, int n_folds, float inv) {
  constexpr int NI = (1 << DEPTH) - 1;
  constexpr int NL = 1 << DEPTH;
  extern __shared__ uint8_t rows[];
  const long long r0 = (long long)blockIdx.x * K4_ROWS;
  const int nr = (int)(n_rows - r0 < K4_ROWS ? n_rows - r0 : K4_ROWS);
  const uint8_t* src = x + r0 * n_feat;
  const int nbytes = nr * n_feat;
  for (int i = threadIdx.x; i < nbytes; i += K4_ROWS) rows[i] = src[i];
  __syncthreads();
  if ((int)threadIdx.x >= nr) return;
  const uint8_t* row = rows + threadIdx.x * n_feat;

  float acc = 0.0f;
  int t = 0;
  for (int f = 0; f < n_folds; ++f) {
    const int end = __ldg(fold_end + f);
    float s = __ldg(base + f);
    for (; t + K4_TREES <= end; t += K4_TREES) {
      int pos[K4_TREES];
#pragma unroll
      for (int k = 0; k < K4_TREES; ++k) pos[k] = 0;
      const uint32_t* nd = nodes + (size_t)t * NI;
#pragma unroll
      for (int l = 0; l < DEPTH; ++l) {
#pragma unroll
        for (int k = 0; k < K4_TREES; ++k) {
          const uint32_t node = __ldg(nd + k * NI + (1 << l) - 1 + pos[k]);
          pos[k] = 2 * pos[k] + ((int)row[node & 0xFFFFu] > (int)(node >> 16) ? 1 : 0);
        }
      }
      const float* lv = leaves + (size_t)t * NL;
#pragma unroll
      for (int k = 0; k < K4_TREES; ++k) s = s + __ldg(lv + k * NL + pos[k]);
    }
    for (; t < end; ++t)
      s = s + __ldg(leaves + (size_t)t * NL + route<DEPTH>(row, nodes + (size_t)t * NI));
    acc = f == 0 ? s : acc + s;
  }
  out[r0 + threadIdx.x] = acc * inv;
}

typedef void (*ForestKernel)(const uint8_t*, const uint32_t*, const float*, const int*,
                             const float*, float*, long long, int, int, float);

ForestKernel forest_kernel(int depth) {
  switch (depth) {
    case 1: return predict_forest_kernel<1>;
    case 2: return predict_forest_kernel<2>;
    case 3: return predict_forest_kernel<3>;
    case 4: return predict_forest_kernel<4>;
    case 5: return predict_forest_kernel<5>;
    case 6: return predict_forest_kernel<6>;
    case 7: return predict_forest_kernel<7>;
    case 8: return predict_forest_kernel<8>;
    case 9: return predict_forest_kernel<9>;
    case 10: return predict_forest_kernel<10>;
    case 11: return predict_forest_kernel<11>;
    case 12: return predict_forest_kernel<12>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// x uint8 [n_rows, n_feat]; nodes uint32 [T, 2^depth - 1]; leaves f32
// [T, 2^depth]; fold_end int32 and base f32 [n_folds] (device memory);
// out f32 [n_rows].  One launch, ceil(n_rows / 128) blocks.
int predict_forest(const void* x, const void* nodes, const void* leaves, const void* fold_end,
                   const void* base, void* out, long long n_rows, int n_feat, int n_folds,
                   int depth, float inv, int device, void* stream) {
  const ForestKernel kernel = forest_kernel(depth);
  const long long blocks = (n_rows + K4_ROWS - 1) / K4_ROWS;
  if (kernel == nullptr || n_rows < 1 || blocks > INT_MAX || n_feat < 1 ||
      n_feat * K4_ROWS > K4_SMEM || n_folds < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, K4_ROWS, (size_t)n_feat * K4_ROWS, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint32_t*>(nodes),
      static_cast<const float*>(leaves), static_cast<const int*>(fold_end),
      static_cast<const float*>(base), static_cast<float*>(out), n_rows, n_feat, n_folds, inv);
  return (int)cudaGetLastError();
}

}  // extern "C"
