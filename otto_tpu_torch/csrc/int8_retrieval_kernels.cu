// Int8 stage 1 for Hopper (sm_90a): the packed strided-window maxima of an
// int8 item table, on the int8 tensor cores.  Plain C entry point, loaded
// with ctypes by otto_tpu_torch/ops/_kernels.py; it selects the tensors'
// device, launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() so that a refused launch is
// reported to the wrapper (ops/fused_retrieval.py::fused_stage1_int8).
//
// It replaces no Pallas kernel.  It replaces the XLA ops of the reference's
// int8 route, otto_tpu/ops/retrieval.py::topk_hybrid_int8 (:295-302): the
// int8 dot_general, the float rescale, the euclidean bias and the
// approx_max_k reduction, which there materialise [256, N] float32 scores
// a query tile ([4,096 x 1,867,776] would be 30.6 GB at the OTTO catalog).
// Here the scores stay in registers, reduced to K1's packed window maxima:
// item j = c*16384 + a*128 + l goes to window c*128 + l with its position a
// in the low 7 bits, so K2's peel, the decode and the live test run after
// it unchanged.
//
// Contract, for query row b and item j (j < n_items):
//     acc = q8[b, :] . t8[j, :]                      (exact int32)
//     s   = f32(acc) * (q_scale[b] * item_scale[j])
//     s   = 2 s - item_bias[j]                        (euclidean only)
//     key = s + shift
// each step one float32 rounding in this order (the __f*_rn intrinsics keep
// nvcc from contracting them into FMAs), which the twin
// (_stage1_int8_reference) repeats bit for bit.  The euclidean step is one
// __fmaf_rn(2, s, -bias): 2 s is exact, so it rounds as 2 s - bias does.
// Items j >= n_items key 0, so pad windows pack below 1.0 as K1's do; the
// caller's power-of-two shift puts every live key at >= 1.0.  Both operands
// are row-major int8, zero padded to D_pad (a multiple of 32, at most 256):
// K-major, as the s8 forms of mma.sync take them.
//
// Design (simple first): one block per (128 query rows, one 16,384-item
// chunk), eight warps of 16 rows each; the grid's x (the query tiles) runs
// fastest, so the blocks of a chunk run together and share its table slice
// (16,384 x D_pad bytes) in L2.  A warp keeps its rows' A fragments in
// registers for the whole block (D_pad/32 k steps x 4 registers).  For each
// position a, the 128 consecutive rows of the table (a's tile, 128 x D_pad
// bytes, contiguous) with their scales and norms arrive in shared memory by
// cp.async, three tiles in flight; rows are padded by 16 bytes so that a
// warp's B-fragment reads hit 32 distinct banks.  The warp then runs
// mma.sync.m16n8k32.s8 over its 16 rows x 128 lanes, 8 lanes at a time,
// and folds each score into a register-resident window max (64 a thread):
// in the accumulator layout a thread holds the same (row, lane) for every
// a.  The accumulators start at the bits of 2^23 + 2^22, so the float of
// an int sum |acc| < 2^22 (127^2 * 256 = 4,129,024 at most) is one
// exact FADD instead of a quarter-rate I2F.
//
// What bounds it.  At the neighbor table's [4,096 x 32] x [32 x 1,867,776]:
// the int8 tensor operations are 2 B D_pad N_pad = 4.90e11, 0.247 ms at
// 1,979e12/s; the bytes (the table read once, 60 MB, its scales and norms
// 15 MB, the packed output written once, 239 MB) 314 MB, 0.094 ms at
// 3.35 TB/s; the epilogue 7.65e9 scores x 6 CUDA-core instructions for
// "dot" (the conversion's FADD, two FMULs, the shift's FADD, one LOP3 that
// clears the lane bits, masks pads and ORs in a, one FMNMX) and x 7 for
// "euclidean" (the FFMA of 2 s - sq), 1.37 and 1.60 ms at 132 SMs x 128
// lanes x 1.98 GHz = 33.5e12 instructions a second.  So the epilogue, not
// the tensor cores or the bytes, sets the bound.  Later work: wgmma.m64nNk32
// fed by TMA, and an epilogue of fewer instructions a score.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WINDOW = 128;             // items per strided window
constexpr int CHUNK = WINDOW * WINDOW;  // windows live inside 16384-item chunks
constexpr unsigned LANE_MASK = WINDOW - 1;

constexpr int I8_ROWS = 128;            // query rows per block
constexpr int I8_WARPS = I8_ROWS / 16;  // a warp owns 16 rows x the window's 128 lanes
constexpr int I8_THREADS = 32 * I8_WARPS;
constexpr int I8_STAGES = 3;            // table tiles in flight
constexpr int I8_ROW_PAD = 16;          // bytes after each table row in shared memory
constexpr int I8_MAX_STEPS = 8;         // D_pad <= 256
// 2^23 + 2^22 as float bits: __int_as_float(MAGIC + acc) - 2^23 - 2^22 is
// exactly acc for -2^22 <= acc < 2^22
constexpr int I8_MAGIC = 0x4B400000;
constexpr float I8_MAGIC_F = 12582912.0f;

__host__ __device__ constexpr int i8_row_bytes(int d_pad) { return d_pad + I8_ROW_PAD; }
// a tile: 128 table rows, then their 128 scales and 128 norms
__host__ __device__ constexpr int i8_stage_bytes(int d_pad) {
  return WINDOW * i8_row_bytes(d_pad) + 2 * WINDOW * 4;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// d[4] += A[16 x 32] . B[32 x 8], int8 in, int32 sums.  A: register r of
// thread (g = lane/4, t = lane%4) holds row g + 8(r&1), k 16(r>>1) + 4t ..
// +3; B: register r holds k 16r + 4t .. +3 of column g; d: register r holds
// row g + 8(r>>1), column 2t + (r&1).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Position a's tile: 128 consecutive table rows (contiguous in device
// memory) into padded shared rows, and their scales and norms behind them,
// by all the block's threads in 16-byte pieces.
template <int D_PAD>
__device__ __forceinline__ void load_tile(uint8_t* dst, const int8_t* __restrict__ table,
                                          const float* __restrict__ item_scale,
                                          const float* __restrict__ item_bias,
                                          long long item0, int tid) {
  constexpr int parts = D_PAD / 16;
  const int8_t* src = table + item0 * D_PAD;
#pragma unroll
  for (int i = tid; i < WINDOW * parts; i += I8_THREADS) {
    const int r = i / parts;
    const int p = i - r * parts;
    cp_async16(dst + r * i8_row_bytes(D_PAD) + 16 * p, src + 16 * i);
  }
  if (tid < 64) {  // 32 pieces of scales, then 32 of norms
    const float* vec = tid < 32 ? item_scale : item_bias;
    cp_async16(dst + WINDOW * i8_row_bytes(D_PAD) + 16 * tid, vec + item0 + 4 * (tid & 31));
  }
}

// The contract's key (see the top of the file), from the biased sum.
__device__ __forceinline__ float int8_key(int biased_acc, float qs, float sc, float bias,
                                          float shift, int euclidean) {
  const float acc = __fsub_rn(__int_as_float(biased_acc), I8_MAGIC_F);
  float s = __fmul_rn(acc, __fmul_rn(qs, sc));
  if (euclidean) s = __fmaf_rn(2.0f, s, -bias);
  return __fadd_rn(s, shift);
}

// The key's bits with the low 7 replaced by a (mask ~LANE_MASK), or a alone
// for a pad item (mask 0).
__device__ __forceinline__ float pack(float key, unsigned mask, unsigned a) {
  return __uint_as_float((__float_as_uint(key) & mask) | a);
}

template <int K_STEPS>
__global__ void __launch_bounds__(I8_THREADS, 2)
fused_stage1_int8_kernel(const int8_t* __restrict__ q8, const float* __restrict__ q_scale,
                         const int8_t* __restrict__ table, const float* __restrict__ item_scale,
                         const float* __restrict__ item_bias, float* __restrict__ out, int B,
                         long long n_pad, long long n_items, float shift, int euclidean) {
  constexpr int D_PAD = 32 * K_STEPS;
  constexpr int ROW_BYTES = i8_row_bytes(D_PAD);
  constexpr int STAGE_BYTES = i8_stage_bytes(D_PAD);
  extern __shared__ __align__(16) uint8_t i8_smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long item_base = (long long)blockIdx.y * CHUNK;
  const int row0 = blockIdx.x * I8_ROWS + warp * 16 + g;  // this thread's rows: row0, row0 + 8

#pragma unroll
  for (int s = 0; s < I8_STAGES - 1; ++s) {
    load_tile<D_PAD>(i8_smem + s * STAGE_BYTES, table, item_scale, item_bias,
                     item_base + (long long)s * WINDOW, tid);
    cp_async_commit();
  }

  // the warp's 16 rows as A fragments, zeros past B
  uint32_t afrag[K_STEPS][4];
#pragma unroll
  for (int ks = 0; ks < K_STEPS; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 8 * (r & 1);
      const int col = 32 * ks + 16 * (r >> 1) + 4 * t;
      afrag[ks][r] =
          row < B ? *reinterpret_cast<const uint32_t*>(q8 + (long long)row * D_PAD + col) : 0u;
    }
  }
  const float qs0 = row0 < B ? q_scale[row0] : 0.0f;
  const float qs1 = row0 + 8 < B ? q_scale[row0 + 8] : 0.0f;

  float best[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) best[nt][r] = -CUDART_INF_F;
  }

  for (int a = 0; a < WINDOW; ++a) {
    cp_async_wait<I8_STAGES - 2>();
    __syncthreads();
    // every warp is past position a - 1, so its slot takes tile a + 2
    const int next = a + I8_STAGES - 1;
    if (next < WINDOW)
      load_tile<D_PAD>(i8_smem + (next % I8_STAGES) * STAGE_BYTES, table, item_scale, item_bias,
                       item_base + (long long)next * WINDOW, tid);
    cp_async_commit();

    const uint8_t* tile = i8_smem + (a % I8_STAGES) * STAGE_BYTES;
    const float* tscale = reinterpret_cast<const float*>(tile + WINDOW * ROW_BYTES);
    const float* tbias = tscale + WINDOW;
    const long long j0 = item_base + (long long)a * WINDOW;
    const unsigned code = (unsigned)a;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      int acc[4] = {I8_MAGIC, I8_MAGIC, I8_MAGIC, I8_MAGIC};
      const uint8_t* brow = tile + (nt * 8 + g) * ROW_BYTES + 4 * t;
#pragma unroll
      for (int ks = 0; ks < K_STEPS; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow + 32 * ks);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(brow + 32 * ks + 16);
        mma_s8(acc, afrag[ks], b0, b1);
      }
      const int l = nt * 8 + 2 * t;  // lanes l and l + 1
      const float2 sc = *reinterpret_cast<const float2*>(tscale + l);
      const float2 bi = *reinterpret_cast<const float2*>(tbias + l);
      const unsigned m0 = j0 + l < n_items ? ~LANE_MASK : 0u;
      const unsigned m1 = j0 + l + 1 < n_items ? ~LANE_MASK : 0u;
      best[nt][0] = fmaxf(best[nt][0],
                          pack(int8_key(acc[0], qs0, sc.x, bi.x, shift, euclidean), m0, code));
      best[nt][1] = fmaxf(best[nt][1],
                          pack(int8_key(acc[1], qs0, sc.y, bi.y, shift, euclidean), m1, code));
      best[nt][2] = fmaxf(best[nt][2],
                          pack(int8_key(acc[2], qs1, sc.x, bi.x, shift, euclidean), m0, code));
      best[nt][3] = fmaxf(best[nt][3],
                          pack(int8_key(acc[3], qs1, sc.y, bi.y, shift, euclidean), m1, code));
    }
  }

  const long long nw = n_pad / WINDOW;
  const long long col0 = (long long)blockIdx.y * WINDOW;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const long long col = col0 + nt * 8 + 2 * t;
    if (row0 < B)
      *reinterpret_cast<float2*>(out + (long long)row0 * nw + col) =
          make_float2(best[nt][0], best[nt][1]);
    if (row0 + 8 < B)
      *reinterpret_cast<float2*>(out + (long long)(row0 + 8) * nw + col) =
          make_float2(best[nt][2], best[nt][3]);
  }
}

// Launch shape: a block per (128 query rows, chunk), the query tiles
// fastest; three tiles of shared memory, 21.5 KB at D_pad 32 and 105 KB at
// 256.  Returns a cudaError_t: cudaErrorInvalidValue for D_pad outside
// 32..256 or not a multiple of 32, a ragged N_pad, n_items outside
// 0..N_pad, or an operand off a 16-byte boundary.
int launch_fused_stage1_int8(const void* q8, const void* q_scale, const void* table,
                             const void* item_scale, const void* item_bias, void* out, int B,
                             int d_pad, long long n_pad, long long n_items, float shift,
                             int euclidean, int device, void* stream) {
  const void* ptrs[] = {q8, q_scale, table, item_scale, item_bias, out};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
  if (B < 1 || d_pad < 32 || d_pad > 32 * I8_MAX_STEPS || d_pad % 32 || n_pad < CHUNK ||
      n_pad % CHUNK || n_pad / CHUNK > 65535 || n_items < 0 || n_items > n_pad)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  typedef void (*Kernel)(const int8_t*, const float*, const int8_t*, const float*, const float*,
                         float*, int, long long, long long, float, int);
  static const Kernel kernels[] = {
      fused_stage1_int8_kernel<1>, fused_stage1_int8_kernel<2>, fused_stage1_int8_kernel<3>,
      fused_stage1_int8_kernel<4>, fused_stage1_int8_kernel<5>, fused_stage1_int8_kernel<6>,
      fused_stage1_int8_kernel<7>, fused_stage1_int8_kernel<8>};
  const Kernel kernel = kernels[d_pad / 32 - 1];
  const int smem = I8_STAGES * i8_stage_bytes(d_pad);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((B + I8_ROWS - 1) / I8_ROWS), (unsigned)(n_pad / CHUNK));
  kernel<<<grid, I8_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(q_scale),
      static_cast<const int8_t*>(table), static_cast<const float*>(item_scale),
      static_cast<const float*>(item_bias), static_cast<float*>(out), B, n_pad, n_items, shift,
      euclidean);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_stage1_int8(const void* q8, const void* q_scale, const void* table,
                      const void* item_scale, const void* item_bias, void* out, int B,
                      int d_pad, long long n_pad, long long n_items, float shift, int euclidean,
                      int device, void* stream) {
  return launch_fused_stage1_int8(q8, q_scale, table, item_scale, item_bias, out, B, d_pad,
                                  n_pad, n_items, shift, euclidean, device, stream);
}

}  // extern "C"
