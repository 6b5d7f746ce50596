// Forest kernels for Hopper (sm_90a): fold-averaged GBDT scores over binned
// rows, or over float32 feature rows binned in the kernel's staging.  Plain C
// entry points, loaded with ctypes by otto_tpu_torch/ops/_kernels.py.  Each
// selects the tensors' device, launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so that a
// refused launch is reported to the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// K4: forest routing.
//
// Replaces otto_tpu/models/gbdt.py::_predict_forest (:334; an XLA program in
// the JAX package, not a Pallas kernel: a lax.scan over trees, dispatched once
// per fold and per 1<<20-row batch), the fold loop of
// GBDTRankerModel.predict_binned_folds, and, for float32 rows, the numpy
// bin_features (:80) that builds its uint8 input.  One launch routes every
// fold of one model over all rows.  Per row and fold f:
//     s_f = base[f] + leaf_0 + leaf_1 + ...   (tree order, float32)
// where a tree's leaf is found by `pos = 2 pos + (bin[feat[i]] > thr[i])`,
// i = 2^level - 1 + pos, for each of its DEPTH levels; then
//     out = (s_0 + s_1 + ...) * inv           (folds in order, inv = f32(1/n))
// That is the reference's order of float32 operations, so the result is
// bit-equal to the plain twin's and the JAX package's.  Float rows are binned
// as bin_features bins them: NaN -> 0, otherwise 1 + #(edges[f] < v), by a
// branchless 8-step lower-bound search over the feature's edges padded to 255
// (+inf pads).  Float compares stay IEEE (no fast math, no flush to zero), so
// -0.0 == +0.0, denormals keep their order and a value equal to an edge falls
// in the lower bin, as in numpy.
//
// What bounds it: operations.  A row costs T x DEPTH node steps (1,472,000
// rows x 280 trees x 7 levels = 2.9e9 on the two-stage path) plus 8 compares
// a float value, against 220 bytes of float input a row.  A node step is a
// chain of two dependent shared-memory loads (the node, then the bin it
// names) and three or four integer instructions; the integer pipe (64 lanes
// a clock an SM, the rate the bound counts one operation a step at) and the
// instruction issue set the pace, not HBM.
//
// Design (the previous kernel read the ~290 KB model through L1 from device
// memory, a thread a row, and ran at 9% of the bound):
// - A block owns 256 rows, a warp 32 of them.  The staging loads the rows
//   (float32 coalesced, 16 values a thread in flight; or uint8) and writes
//   each row's bins into its own 64- or 128-byte slot of shared memory,
//   binning float values on the way against the model's edges, staged once
//   a block at an odd stride (257 floats a feature) so that a warp's 32
//   searches, on 32 consecutive features, fall in distinct banks.
// - The model goes through in slices of 32 trees, one tree a lane: a slice
//   is one array M[j][lane] of 32-bit words, j the 1-based heap index of a
//   node (j < 2^DEPTH: `(thr << 7) | feat`) or of a leaf (j >= 2^DEPTH: its
//   float32 bits).  A warp walks the 32 trees of a slice side by side for one
//   row at a time (four rows interleaved), so every lane reads its own bank
//   for the node (M[j][lane]) and every lane reads the same row's bins (one
//   wavefront), with no bank conflicts.  A step is
//       n = M[j][lane]; b = bins[row_slot | (n & 127)];
//       j = 2 j + ((n - (b << 7)) >> 31)
//   since b > thr exactly when n - (b << 7) < 0 (feat < 128, b <= 255; a
//   threshold of 256 never sends a bin right), compiled to LEA, LDS, LOP3,
//   LDS.U8, IMAD and a funnel shift.  Nodes stay 32-bit: 2-byte nodes would
//   halve the slice but put two lanes in one bank, or cost address
//   arithmetic, and shared memory holds the 32-bit slices.  At depth <= 7 a
//   slice is 32 KB, streamed by cp.async.bulk into a double buffer behind an
//   mbarrier while the block routes the one before; deeper models are read
//   from device memory in the same layout.
// - The sum keeps the reference's order: a warp writes its 32 rows x 32 trees
//   of leaves into a tile padded to a stride of 33, then each lane adds its
//   row's 32 leaves in tree order (unrolled, where no fold ends inside the
//   slice), closing a fold where its trees end, and writes
//   (s_0 + s_1 + ...) * inv at the end.
// - 112 KB of shared memory a block at F <= 64: two blocks an SM, so one
//   block's staging overlaps the other's routing.
// ---------------------------------------------------------------------------

constexpr int K4_WARPS = 8;
constexpr int K4_THREADS = K4_WARPS * 32;
constexpr int K4_ROWS = K4_WARPS * 32;    // rows a block, 32 a warp
constexpr int K4_MAX_FEAT = 128;          // node = (thr << 7) | feat
constexpr int K4_EDGE_SLOTS = 256;        // a feature's edges in device memory, +inf pads
constexpr int K4_EDGE_STRIDE = 257;       // ... and in shared memory: an odd stride
constexpr int K4_ILP = 4;                 // rows a lane walks side by side
constexpr int K4_STAGE = 16;              // values a thread loads before it bins them
constexpr int K4_TILE_WORDS = 32 * 33 - 1;  // a warp's leaf tile: 32 rows at a stride of 33
constexpr int K4_TILE_BYTES = K4_WARPS * K4_TILE_WORDS * 4;
constexpr int K4_SMEM_DEPTH = 7;          // deepest model streamed through shared memory

__host__ __device__ constexpr int slice_words(int depth) { return (2 << depth) * 32; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one 32-tree slice of the model into a shared buffer, completing on `bar`
__device__ __forceinline__ void load_slice(uint32_t dst, const uint32_t* src, uint32_t bytes,
                                           uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// bin_features on one value: NaN -> 0, else 1 + #(e[k] < v) over a row of 255
// non-decreasing edges (+inf pads)
__device__ __forceinline__ uint32_t bin_value(float v, const float* e) {
  int pos = 0;
#pragma unroll
  for (int step = 128; step >= 1; step >>= 1) pos += e[pos + step - 1] < v ? step : 0;
  return v != v ? 0u : (uint32_t)pos + 1u;
}

// one node step: b > thr exactly when n - (b << 7) is negative
__device__ __forceinline__ uint32_t step(uint32_t j, uint32_t n, const uint8_t* bins,
                                         uint32_t slot) {
  const uint32_t b = bins[slot | (n & (K4_MAX_FEAT - 1))];
  return __funnelshift_l(n - (b << 7), j, 1);  // (j << 1) | sign bit
}

// The 32 trees of one slice (M[j][lane], shared or device memory) over the
// warp's 32 rows: leaf values into tile[row][lane].
template <int DEPTH, bool SMEM>
__device__ __forceinline__ void route_slice(const uint32_t* __restrict__ M,
                                            const uint8_t* bins, uint32_t row0, uint32_t slot,
                                            float* tile, int lane) {
  // a node's address is one shift-add of its heap index onto the lane's column
  const uint32_t* Ml = M + lane;
  const uint32_t col = SMEM ? smem_u32(Ml) : 0u;
  auto node = [&](uint32_t j) -> uint32_t {
    return SMEM ? lds_u32(col + (j << 7)) : __ldg(Ml + j * 32);
  };
  const uint32_t n1 = node(1);
#pragma unroll 1
  for (int r = 0; r < 32; r += K4_ILP) {
    uint32_t j[K4_ILP];
#pragma unroll
    for (int i = 0; i < K4_ILP; ++i) j[i] = step(1u, n1, bins, row0 + (r + i) * slot);
#pragma unroll
    for (int l = 1; l < DEPTH; ++l) {
#pragma unroll
      for (int i = 0; i < K4_ILP; ++i) j[i] = step(j[i], node(j[i]), bins, row0 + (r + i) * slot);
    }
#pragma unroll
    for (int i = 0; i < K4_ILP; ++i)
      tile[(r + i) * 33 + lane] = __uint_as_float(node(j[i]));
  }
}

// Shared memory: the rows' bins [256][slot], the first slice buffer, then a
// region that holds the edges [F][257] during the staging and, after it, the
// second slice buffer and the warps' leaf tiles; two mbarriers at the end.
// At F <= 64 and depth <= 7 that is 112 KB: two blocks an SM.
__host__ __device__ inline int forest_smem_bytes(int depth, int slot, int n_edge_feat) {
  const int slice = depth <= K4_SMEM_DEPTH ? slice_words(depth) * 4 : 0;
  const int after = slice + K4_TILE_BYTES;
  const int edge_bytes = (n_edge_feat * K4_EDGE_STRIDE * 4 + 15) / 16 * 16;
  return K4_ROWS * slot + slice + (edge_bytes > after ? edge_bytes : after) + 16;
}

template <int DEPTH, typename IN>
__global__ void __launch_bounds__(K4_THREADS, 2)
    forest_kernel(const IN* __restrict__ x, const float* __restrict__ edges,
                  const uint32_t* __restrict__ model, const int* __restrict__ fold_end,
                  const float* __restrict__ base, float* __restrict__ out, long long n_rows,
                  int n_feat, int n_trees, int n_folds, float inv) {
  constexpr bool SMEM = DEPTH <= K4_SMEM_DEPTH;
  constexpr bool FLOAT_ROWS = std::is_same<IN, float>::value;
  constexpr int SLICE_WORDS = slice_words(DEPTH);
  constexpr uint32_t SLICE_BYTES = SLICE_WORDS * 4;
  extern __shared__ __align__(128) uint8_t smem[];
  const int slot = n_feat <= 64 ? 64 : 128;
  uint8_t* bins = smem;
  uint32_t* buf0 = reinterpret_cast<uint32_t*>(smem + K4_ROWS * slot);
  uint8_t* region = smem + K4_ROWS * slot + (SMEM ? SLICE_BYTES : 0);
  float* edges_s = reinterpret_cast<float*>(region);
  uint32_t* buf1 = reinterpret_cast<uint32_t*>(region);
  float* tiles = reinterpret_cast<float*>(region + (SMEM ? SLICE_BYTES : 0));
  const uint32_t bar0 = smem_u32(smem + forest_smem_bytes(DEPTH, slot, FLOAT_ROWS ? n_feat : 0) -
                                 16);
  const uint32_t bar1 = bar0 + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_slices = (n_trees + 31) / 32;

  if (SMEM && tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    load_slice(smem_u32(buf0), model, SLICE_BYTES, bar0);
  }

  // staging: the block's rows, binned, into their slots
  const long long r0 = (long long)blockIdx.x * K4_ROWS;
  const int nr = n_rows - r0 < K4_ROWS ? (int)(n_rows - r0) : K4_ROWS;
  const int n_vals = nr * n_feat;
  const IN* src = x + r0 * n_feat;
  if (FLOAT_ROWS) {  // the edges, each feature's row at an odd stride
    for (int i = tid; i < n_feat * K4_EDGE_SLOTS; i += K4_THREADS)
      edges_s[(i >> 8) * K4_EDGE_STRIDE + (i & 255)] = __ldg(edges + i);
    __syncthreads();
  }
  {
    // value i of the tile is row i / F, feature i % F; a warp's lanes hold
    // consecutive values, so the searches of one step fall in distinct banks
    const int dr = K4_THREADS / n_feat, df = K4_THREADS - dr * n_feat;
    int r = tid / n_feat, f = tid - r * n_feat;
    for (int i0 = tid; i0 < n_vals; i0 += K4_STAGE * K4_THREADS) {
      IN v[K4_STAGE];
#pragma unroll
      for (int u = 0; u < K4_STAGE; ++u) {
        const int i = i0 + u * K4_THREADS;
        v[u] = i < n_vals ? src[i] : IN(0);
      }
#pragma unroll
      for (int u = 0; u < K4_STAGE; ++u) {
        if (i0 + u * K4_THREADS < n_vals) {
          uint32_t b;
          if constexpr (FLOAT_ROWS)
            b = bin_value(v[u], edges_s + f * K4_EDGE_STRIDE);
          else
            b = v[u];
          bins[r * slot + f] = (uint8_t)b;
        }
        r += dr;
        f += df;
        if (f >= n_feat) {
          f -= n_feat;
          ++r;
        }
      }
    }
  }
  __syncthreads();  // bins written, edges dead
  if (SMEM && tid == 0 && n_slices > 1)
    load_slice(smem_u32(buf1), model + SLICE_WORDS, SLICE_BYTES, bar1);

  float* tile = tiles + warp * K4_TILE_WORDS;
  const uint32_t row0 = (uint32_t)(warp * 32 * slot);
  int fold = 0;
  int next_end = __ldg(fold_end);
  float s = __ldg(base), acc = 0.0f;
  auto close_fold = [&]() {
    acc = fold == 0 ? s : acc + s;
    if (++fold < n_folds) {
      s = __ldg(base + fold);
      next_end = __ldg(fold_end + fold);
    }
  };
  for (int sl = 0; sl < n_slices; ++sl) {
    const uint32_t* M = model + (size_t)sl * SLICE_WORDS;
    if (SMEM) {
      M = (sl & 1) ? buf1 : buf0;
      mbar_wait((sl & 1) ? bar1 : bar0, (sl >> 1) & 1);
    }
    route_slice<DEPTH, SMEM>(M, bins, row0, (uint32_t)slot, tile, lane);
    __syncwarp();
    const int t_end = n_trees - sl * 32 < 32 ? n_trees - sl * 32 : 32;
    const float* trow = tile + lane * 33;
    if (t_end == 32 && next_end - sl * 32 >= 32) {  // no fold ends inside this slice
#pragma unroll
      for (int t = 0; t < 32; ++t) s = s + trow[t];
    } else {
      for (int t = 0; t < t_end; ++t) {
        while (fold < n_folds && sl * 32 + t == next_end) close_fold();
        s = s + trow[t];
      }
    }
    if (SMEM) {
      __syncthreads();  // every warp is done with this buffer
      if (tid == 0 && sl + 2 < n_slices)
        load_slice(smem_u32((sl & 1) ? buf1 : buf0), model + (size_t)(sl + 2) * SLICE_WORDS,
                   SLICE_BYTES, (sl & 1) ? bar1 : bar0);
    } else {
      __syncwarp();
    }
  }
  while (fold < n_folds) close_fold();
  const int row = warp * 32 + lane;
  if (row < nr) out[r0 + row] = acc * inv;
}

template <typename IN>
using ForestKernel = void (*)(const IN*, const float*, const uint32_t*, const int*, const float*,
                              float*, long long, int, int, int, float);

template <typename IN>
ForestKernel<IN> forest_kernel_for(int depth) {
  switch (depth) {
    case 1: return forest_kernel<1, IN>;
    case 2: return forest_kernel<2, IN>;
    case 3: return forest_kernel<3, IN>;
    case 4: return forest_kernel<4, IN>;
    case 5: return forest_kernel<5, IN>;
    case 6: return forest_kernel<6, IN>;
    case 7: return forest_kernel<7, IN>;
    case 8: return forest_kernel<8, IN>;
    case 9: return forest_kernel<9, IN>;
    case 10: return forest_kernel<10, IN>;
    case 11: return forest_kernel<11, IN>;
    case 12: return forest_kernel<12, IN>;
    default: return nullptr;
  }
}

// ceil(n_rows / 256) blocks of 256 threads, two an SM where shared memory
// allows; the shared-memory opt-in is raised per device and kernel as
// launches need it.
template <typename IN>
int launch_forest(const void* x, const void* edges, const void* model, const void* fold_end,
                  const void* base, void* out, long long n_rows, int n_feat, int n_trees,
                  int n_folds, int depth, float inv, int device, void* stream) {
  constexpr int MAX_DEVICES = 64;
  static int opted[MAX_DEVICES][12] = {};
  const ForestKernel<IN> kernel = forest_kernel_for<IN>(depth);
  const long long blocks = (n_rows + K4_ROWS - 1) / K4_ROWS;
  if (kernel == nullptr || device < 0 || device >= MAX_DEVICES || n_rows < 1 ||
      blocks > INT_MAX || n_feat < 1 || n_feat > K4_MAX_FEAT || n_trees < 1 || n_folds < 1 ||
      reinterpret_cast<uintptr_t>(edges) % 16 || reinterpret_cast<uintptr_t>(model) % 16)
    return (int)cudaErrorInvalidValue;
  const int slot = n_feat <= 64 ? 64 : 128;
  const int smem =
      forest_smem_bytes(depth, slot, std::is_same<IN, float>::value ? n_feat : 0);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (opted[device][depth - 1] < smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted[device][depth - 1] = smem;
  }
  kernel<<<(unsigned)blocks, K4_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const IN*>(x), static_cast<const float*>(edges),
      static_cast<const uint32_t*>(model), static_cast<const int*>(fold_end),
      static_cast<const float*>(base), static_cast<float*>(out), n_rows, n_feat, n_trees,
      n_folds, inv);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4 bin: float32 rows -> uint8 bins, alone.
//
// Replaces the host numpy bin_features (otto_tpu/models/gbdt.py:80) where the
// GBDT fit bins its training rows (train_gbdt_ranker, :824-880); not a Pallas
// kernel in the reference.  The same binning as forest_kernel's float-row
// staging, by the same bin_value over the same edges staged at the same odd
// stride: NaN -> 0, otherwise 1 + #(edges[f] < v).
//
// What bounds it: bytes.  A value is read once (4 bytes) and its bin written
// once (1 byte); the 8-step search costs 8 shared loads and compares, far
// below the card's rate for them.  Design: the rows are one flat stream of
// N F values; a thread takes four consecutive values a step (one 16-byte
// load, one 4-byte store of their bins), so a warp reads 512 contiguous bytes
// and writes 128; a persistent grid, each block holding every feature's edges
// (F x 257 floats) in shared memory.  Four consecutive values of the stream
// are four consecutive features (wrapping at F), and a warp's 32 lanes start
// at features 4 apart, so their searches spread over the banks.
// ---------------------------------------------------------------------------

constexpr int BIN_THREADS = 256;

__host__ __device__ inline int bin_smem_bytes(int n_feat) {
  return n_feat * K4_EDGE_STRIDE * 4;
}

__global__ void __launch_bounds__(BIN_THREADS)
    bin_rows_kernel(const float* __restrict__ x, const float* __restrict__ edges,
                    uint8_t* __restrict__ out, long long n_vals, int n_feat) {
  extern __shared__ __align__(16) float edges_s[];  // [n_feat][257]
  for (int i = threadIdx.x; i < n_feat * K4_EDGE_SLOTS; i += BIN_THREADS)
    edges_s[(i >> 8) * K4_EDGE_STRIDE + (i & 255)] = __ldg(edges + i);
  __syncthreads();
  const long long n4 = n_vals >> 2;
  const long long first = (long long)blockIdx.x * BIN_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * BIN_THREADS;
  const int f_step = (int)((4 * stride) % n_feat);
  int f = (int)((4 * first) % n_feat);  // the feature of the step's first value
  const float4* x4 = reinterpret_cast<const float4*>(x);
  uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
  for (long long v = first; v < n4; v += stride) {
    const float4 a = __ldcs(x4 + v);  // read once: keep it out of the caches
    const float vals[4] = {a.x, a.y, a.z, a.w};
    uint32_t word = 0;
    int g = f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      word |= bin_value(vals[u], edges_s + g * K4_EDGE_STRIDE) << (8 * u);
      if (++g == n_feat) g = 0;
    }
    out4[v] = word;
    f += f_step;
    if (f >= n_feat) f -= n_feat;
  }
  if (blockIdx.x == 0 && threadIdx.x < (int)(n_vals & 3)) {  // the last 1-3 values
    const long long i = (n4 << 2) + threadIdx.x;
    out[i] = (uint8_t)bin_value(x[i], edges_s + (int)(i % n_feat) * K4_EDGE_STRIDE);
  }
}

}  // namespace

extern "C" {

// model uint32 [ceil(T / 32), 2^(depth + 1), 32] (the slices; see K4 above);
// fold_end int32 and base f32 [n_folds]; out f32 [n_rows]; all device memory.

// x uint8 [n_rows, n_feat] bins.
int predict_forest_binned(const void* x, const void* model, const void* fold_end,
                          const void* base, void* out, long long n_rows, int n_feat,
                          int n_trees, int n_folds, int depth, float inv, int device,
                          void* stream) {
  return launch_forest<uint8_t>(x, nullptr, model, fold_end, base, out, n_rows, n_feat,
                                n_trees, n_folds, depth, inv, device, stream);
}

// x f32 [n_rows, n_feat] feature rows; edges f32 [n_feat, 256], each row
// non-decreasing and padded with +inf.
int predict_forest_rows(const void* x, const void* edges, const void* model,
                        const void* fold_end, const void* base, void* out, long long n_rows,
                        int n_feat, int n_trees, int n_folds, int depth, float inv, int device,
                        void* stream) {
  return launch_forest<float>(x, edges, model, fold_end, base, out, n_rows, n_feat, n_trees,
                              n_folds, depth, inv, device, stream);
}

// x f32 [n_rows, n_feat] feature rows, 16-byte aligned; edges f32 [n_feat,
// 256] as for predict_forest_rows; out uint8 [n_rows, n_feat], 4-byte
// aligned; all device memory.  A persistent grid: as many blocks as the
// card holds at this n_feat's shared memory.
int bin_rows(const void* x, const void* edges, void* out, long long n_rows, int n_feat,
             int device, void* stream) {
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES || n_rows < 1 || n_feat < 1 ||
      n_feat > K4_MAX_FEAT || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(edges) % 16 || reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (sms_of[device] == 0) {
    e = cudaFuncSetAttribute(bin_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bin_smem_bytes(K4_MAX_FEAT));
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
  }
  const int smem = bin_smem_bytes(n_feat);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bin_rows_kernel, BIN_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_vals = n_rows * n_feat;
  const long long want = (n_vals / 4 + BIN_THREADS - 1) / BIN_THREADS;
  const long long most = (long long)sms_of[device] * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(want < 1 ? 1 : (want < most ? want : most));
  bin_rows_kernel<<<grid, BIN_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(edges),
      static_cast<uint8_t*>(out), n_vals, n_feat);
  return (int)cudaGetLastError();
}

}  // extern "C"
