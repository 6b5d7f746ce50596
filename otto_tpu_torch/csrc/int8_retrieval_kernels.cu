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
// K-major, as the s8 forms of wgmma take both operands.
//
// Design: one block per (128 query rows, one 16,384-item chunk); the grid's
// x (the query tiles) runs fastest, so the blocks of a chunk run together
// and share its table slice (16,384 x D_pad bytes) in L2.  Three
// warpgroups, specialised:
// - a producer (warpgroup 2; one thread works, 40 registers) walks the 128
//   positions a and keeps a ring of up to 8 tiles in flight.  Position a's
//   tile is its 128 consecutive table rows (contiguous, 128 x D_pad bytes),
//   brought by TMA as D_pad/32 boxes of [128 rows, 32 bytes] in the 32-byte
//   swizzle that wgmma reads, plus the rows' 128 scales and (euclidean) 128
//   norms by 1-D cp.async.bulk, all under the slot's `full` mbarrier; the
//   slot's `empty` mbarrier takes one arrival per consumer warp.  The
//   consumers never meet at a block barrier and spend no instruction on a
//   copy.
// - two consumers (warpgroups 0 and 1, 232 registers) own 64 query rows
//   each, held for the whole block as wgmma A fragments in registers
//   (D_pad/32 k steps x 4).  For each position they run
//   wgmma.m64n128k32.s32.s8.s8 (B = the tile, K-major) into 64 int32
//   accumulators, the first k step overwriting them, and fold the 64 keys
//   into a register-resident window max: in wgmma's accumulator layout a
//   thread holds the same (row, lane) in the same register for every a.
//   An exact sum (|acc| <= 127^2 * 256 < 2^24) becomes float32 with one
//   cvt.rn.f32.s32 (I2FP on sm_90a); the kernel before this one started
//   its accumulators at the bits of 2^23 + 2^22 to convert with an FADD,
//   which cost a MOV a score to restart them, and timed in turns on the
//   card that form was the slower.  With D_pad <= 64 a second accumulator
//   set fits beside the A fragments (no spill), and position a + 1's
//   product is issued before position a's keys fold.  ptxas reports those
//   products as serialized (C7514): it waits for each one, but places ~100
//   of the other set's fold instructions between its issue and the wait
//   (cuobjdump), and timed in turns the loop ran faster than with one set.
// - Pads (items >= n_items) exist only in a chunk that ends past n_items:
//   the mask is applied there alone, under a branch uniform over the block.
//
// What bounds it.  At the neighbor table's [4,096 x 32] x [32 x 1,867,776]:
// the int8 tensor operations are 2 B D_pad N_pad = 4.90e11, 0.247 ms at
// 1,979e12/s; the bytes (the table read once, 60 MB, its scales and norms
// 15 MB, the packed output written once, 239 MB) 314 MB, 0.094 ms at
// 3.35 TB/s; the epilogue 7.65e9 scores x 6 CUDA-core instructions for
// "dot" (the conversion, two FMULs, the shift's FADD, one LOP3 that clears
// the lane bits and ORs in a, one FMNMX) and x 7 for "euclidean" (the FFMA
// of 2 s - sq), 1.37 and 1.60 ms at 132 SMs x 128 lanes x 1.98 GHz =
// 33.5e12 instructions a second.  So the epilogue, not the tensor cores or
// the bytes, sets the bound.  Issued a score here, outside a pad chunk
// (cuobjdump of the D_pad 32 loop over a pair of positions): 6.74 ("dot")
// and 7.99 ("euclidean"): the bound's 6 / 7, a 64-bit shared load of two
// scales (and of two norms) per 4 scores, and ~0.5 of waits, products,
// arrivals and addressing.  Measured on an H100 (700 W, the SM clock at
// 1,980 MHz; tools/compare_parent_kernels.py k1int8, in turns with the
// kernel before this one: mma.sync, cp.async by every thread, a block
// barrier a position, the magic bits' MOV and a pad mask in every chunk):
// 2.303 ms ("dot") and 2.63 ms ("euclidean"), 59.6% and 60.9% of the
// bound, against its 3.92 and 4.19 ms.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_sync.cuh"

namespace {

constexpr int WINDOW = 128;             // items per strided window
constexpr int CHUNK = WINDOW * WINDOW;  // windows live inside 16384-item chunks
constexpr unsigned LANE_MASK = WINDOW - 1;

constexpr int I8_ROWS = 128;                     // query rows per block
constexpr int I8_CONSUMERS = 2;                  // warpgroups of 64 rows
constexpr int I8_CTHREADS = 128 * I8_CONSUMERS;  // consumer threads
constexpr int I8_THREADS = I8_CTHREADS + 128;    // and the producer warpgroup
constexpr int I8_KBOX = 32;                      // K bytes a box: one k step, one swizzle row
constexpr int I8_BOX_BYTES = WINDOW * I8_KBOX;   // a box: 128 rows x 32 bytes
constexpr int I8_MAX_STAGES = 8;                 // ring slots
constexpr int I8_MAX_STEPS = 8;                  // D_pad <= 256
constexpr int I8_DOUBLE_MAX_STEPS = 2;           // two accumulator sets up to D_pad 64

// a slot: D_pad/32 boxes, then 128 scales and 128 norms
__host__ __device__ constexpr int i8_stage_bytes(int k_steps) {
  return k_steps * I8_BOX_BYTES + 2 * WINDOW * 4;
}

// wgmma's descriptor of a K-major box in the 32-byte swizzle: start
// address, the leading offset unused (1), the next 8 rows at +256 bytes.
__device__ __forceinline__ uint64_t box_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(256 >> 4) << 32) |
         ((uint64_t)3 << 62);
}

// d[64] (+)= A[64 x 32] . B[32 x 128] (d overwritten unless accumulate),
// int8 in, int32 sums; A from registers (register r of thread (warp w,
// lane) holds row 16w + lane/4 + 8(r&1), k 16(r>>1) + 4(lane%4) .. +3), B
// K-major in shared memory; d: register 4n + 2i + j holds row 16w + lane/4
// + 8i, column 8n + 2(lane%4) + j.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous product's issue and wait.
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The contract's key (see the top of the file) from the exact integer sum:
// |acc| <= 127^2 * 256 < 2^24, so its float32 is exact.
template <bool EUCLID>
__device__ __forceinline__ float int8_key(int sum, float qs, float sc, float bias, float shift) {
  const float acc = __int2float_rn(sum);
  float s = __fmul_rn(acc, __fmul_rn(qs, sc));
  if (EUCLID) s = __fmaf_rn(2.0f, s, -bias);
  return __fadd_rn(s, shift);
}

// The key's bits with the low 7 replaced by a (mask ~LANE_MASK), or a alone
// for a pad item (mask 0).
__device__ __forceinline__ float pack(float key, unsigned mask, unsigned a) {
  return __uint_as_float((__float_as_uint(key) & mask) | a);
}

// The product of one tile into acc, issued as one asynchronous group; its
// first k step overwrites acc (scale-d 0), so acc needs no reset.
template <int K_STEPS>
__device__ __forceinline__ void issue_product(int (&acc)[64], const uint32_t (&afrag)[K_STEPS][4],
                                              uint32_t tile) {
  fence_operands(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int k = 0; k < K_STEPS; ++k) wgmma_s8(acc, afrag[k], box_desc(tile + k * I8_BOX_BYTES), k);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_products() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Position a's keys from its finished product acc, folded into best; then
// the warp releases the slot.
// PADS: the chunk ends past n_items.
template <bool EUCLID, bool PADS>
__device__ __forceinline__ void fold_keys(int (&acc)[64], float (&best)[64], const float* tscale,
                                          float qs0, float qs1, float shift, long long j0,
                                          long long n_items, unsigned code, uint32_t empty) {
  fence_operands(acc);
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const float* tbias = tscale + WINDOW;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int l = 8 * n + 2 * t;  // lanes l and l + 1
    const float2 sc = *reinterpret_cast<const float2*>(tscale + l);
    const float2 bi = EUCLID ? *reinterpret_cast<const float2*>(tbias + l) : make_float2(0, 0);
    unsigned m0 = ~LANE_MASK, m1 = ~LANE_MASK;
    if (PADS) {
      m0 = j0 + l < n_items ? ~LANE_MASK : 0u;
      m1 = j0 + l + 1 < n_items ? ~LANE_MASK : 0u;
    }
    // register 4n + 2i + j: row i (qs0, qs1), lane l + j
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int x = 4 * n + r;
      const float key = int8_key<EUCLID>(acc[x], r < 2 ? qs0 : qs1, r & 1 ? sc.y : sc.x,
                                         r & 1 ? bi.y : bi.x, shift);
      best[x] = fmaxf(best[x], pack(key, r & 1 ? m1 : m0, code));
    }
  }
  __syncwarp();  // the warp's reads of the slot are done
  if (lane == 0) mbar_arrive(empty);
}

// The consumers' walk over the 128 positions of their chunk.  With two
// accumulator sets (DOUBLE), position a + 1's product is issued before
// position a's keys fold; with one, each fold waits for its product.
template <int K_STEPS, bool EUCLID, bool PADS, bool DOUBLE>
__device__ __forceinline__ void int8_positions(int (&acc)[64], int (&acc2)[64], float (&best)[64],
                                               const uint32_t (&afrag)[K_STEPS][4],
                                               const uint8_t* ring_ptr, uint32_t ring,
                                               uint32_t full0, uint32_t empty0, int stages,
                                               float qs0, float qs1, float shift,
                                               long long item_base, long long n_items) {
  constexpr uint32_t STAGE_BYTES = i8_stage_bytes(K_STEPS);
  int s = 0;  // the slot of the next position to arrive, and its phase
  uint32_t phase = 0;
  // waits for the next position's tile and returns its slot
  const auto next_slot = [&]() {
    const int slot = s;
    mbar_wait(full0 + 8u * slot, phase);
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
    return slot;
  };
  const auto tile = [&](int slot) { return ring + (uint32_t)slot * STAGE_BYTES; };
  const auto fold_at = [&](int(&sums)[64], int a, int slot) {
    fold_keys<EUCLID, PADS>(sums, best,
                            reinterpret_cast<const float*>(ring_ptr + (size_t)slot * STAGE_BYTES +
                                                           K_STEPS * I8_BOX_BYTES),
                            qs0, qs1, shift, item_base + (long long)a * WINDOW, n_items,
                            (unsigned)a, empty0 + 8u * slot);
  };
  if constexpr (DOUBLE) {  // positions in pairs; the last pair outside the loop
    int sa = next_slot();
    issue_product<K_STEPS>(acc, afrag, tile(sa));
    int sb;
    for (int a = 0; a < WINDOW - 2; a += 2) {
      sb = next_slot();
      issue_product<K_STEPS>(acc2, afrag, tile(sb));
      wait_products<1>();
      fold_at(acc, a, sa);
      sa = next_slot();
      issue_product<K_STEPS>(acc, afrag, tile(sa));
      wait_products<1>();
      fold_at(acc2, a + 1, sb);
    }
    sb = next_slot();
    issue_product<K_STEPS>(acc2, afrag, tile(sb));
    wait_products<1>();
    fold_at(acc, WINDOW - 2, sa);
    wait_products<0>();
    fold_at(acc2, WINDOW - 1, sb);
  } else {
    for (int a = 0; a < WINDOW; ++a) {
      const int sa = next_slot();
      issue_product<K_STEPS>(acc, afrag, tile(sa));
      wait_products<0>();
      fold_at(acc, a, sa);
    }
  }
}

template <int K_STEPS, bool EUCLID>
__global__ void __launch_bounds__(I8_THREADS, 1)
fused_stage1_int8_kernel(const __grid_constant__ CUtensorMap table, const int8_t* __restrict__ q8,
                         const float* __restrict__ q_scale, const float* __restrict__ item_scale,
                         const float* __restrict__ item_bias, float* __restrict__ out, int B,
                         int stages, long long n_pad, long long n_items, float shift) {
  constexpr int D_PAD = 32 * K_STEPS;
  constexpr uint32_t TABLE_BYTES = K_STEPS * I8_BOX_BYTES;
  constexpr uint32_t STAGE_BYTES = i8_stage_bytes(K_STEPS);
  extern __shared__ __align__(16) uint8_t i8_smem[];
  // [ring: stages x slot][full x stages][empty x stages], the ring
  // 1024-byte aligned for the swizzle
  const uint32_t base = smem_u32(i8_smem);
  const uint32_t ring = (base + 1023u) & ~1023u;
  const uint8_t* ring_ptr = i8_smem + (ring - base);
  const uint32_t full0 = ring + (uint32_t)stages * STAGE_BYTES;
  const uint32_t empty0 = full0 + 8u * stages;
  const long long item_base = (long long)blockIdx.y * CHUNK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8u * s, 1);
      mbar_init(empty0 + 8u * s, I8_CTHREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= I8_CTHREADS) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == I8_CTHREADS) {
      const uint32_t bytes = TABLE_BYTES + (EUCLID ? 2 : 1) * WINDOW * 4;
      int s = 0;
      uint32_t phase = 0;
      for (int a = 0; a < WINDOW; ++a) {
        if (a >= stages) mbar_wait(empty0 + 8u * s, phase ^ 1u);
        const uint32_t full = full0 + 8u * s;
        const uint32_t dst = ring + (uint32_t)s * STAGE_BYTES;
        const long long item0 = item_base + (long long)a * WINDOW;
        mbar_expect_tx(full, bytes);
#pragma unroll
        for (int k = 0; k < K_STEPS; ++k)
          tma_load_2d(dst + k * I8_BOX_BYTES, &table, full, k * I8_KBOX, (int)item0);
        bulk_load(dst + TABLE_BYTES, item_scale + item0, WINDOW * 4, full);
        if (EUCLID) bulk_load(dst + TABLE_BYTES + WINDOW * 4, item_bias + item0, WINDOW * 4, full);
        if (++s == stages) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  // this thread's rows: row0 and row0 + 8
  const int row0 = blockIdx.x * I8_ROWS + wg * 64 + warp * 16 + g;

  // the warpgroup's 64 rows as A fragments, zeros past B
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

  // a second accumulator set (unused, and so not kept, past 2 k steps)
  // fits beside the A fragments of up to 2 k steps
  constexpr bool DOUBLE = K_STEPS <= I8_DOUBLE_MAX_STEPS;
  int acc[64], acc2[64];  // written by each product's first k step
  float best[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) best[i] = -CUDART_INF_F;
  if (item_base + CHUNK > n_items)
    int8_positions<K_STEPS, EUCLID, true, DOUBLE>(acc, acc2, best, afrag, ring_ptr, ring,
                                                  full0, empty0, stages, qs0, qs1, shift,
                                                  item_base, n_items);
  else
    int8_positions<K_STEPS, EUCLID, false, DOUBLE>(acc, acc2, best, afrag, ring_ptr, ring,
                                                   full0, empty0, stages, qs0, qs1, shift,
                                                   item_base, n_items);

  const long long nw = n_pad / WINDOW;
  const long long col0 = (long long)blockIdx.y * WINDOW;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const long long col = col0 + 8 * n + 2 * t;
    if (row0 < B)
      *reinterpret_cast<float2*>(out + (long long)row0 * nw + col) =
          make_float2(best[4 * n], best[4 * n + 1]);
    if (row0 + 8 < B)
      *reinterpret_cast<float2*>(out + (long long)(row0 + 8) * nw + col) =
          make_float2(best[4 * n + 2], best[4 * n + 3]);
  }
}

// Launch shape: a block per (128 query rows, chunk), the query tiles
// fastest; as many ring slots (up to 8) as the card's per-block shared
// memory holds (5 KB a slot at D_pad 32, 33 KB at 256).  Returns a
// cudaError_t: cudaErrorInvalidValue for D_pad outside 32..256 or not a
// multiple of 32, a ragged N_pad, n_items outside 0..N_pad, or an operand
// off a 16-byte boundary; -1 when cuTensorMapEncodeTiled is not found, or
// -1000 - CUresult when the table's tensor map is refused.
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
  int smem_max = 0;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  const int k_steps = d_pad / 32;
  const int slot_bytes = i8_stage_bytes(k_steps) + 16;  // a slot and its two mbarriers
  const int stages = std::min((smem_max - 1024) / slot_bytes, I8_MAX_STAGES);
  if (stages < 2) return (int)cudaErrorInvalidConfiguration;
  const int smem = 1024 + stages * slot_bytes;

  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap map;  // the table [N_pad, D_pad] int8 in boxes of [128 rows, 32 bytes]
  const cuuint64_t dims[2] = {(cuuint64_t)d_pad, (cuuint64_t)n_pad};
  const cuuint64_t strides[1] = {(cuuint64_t)d_pad};
  const cuuint32_t box[2] = {(cuuint32_t)I8_KBOX, (cuuint32_t)WINDOW};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(table), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -1000 - (int)r;

  typedef void (*Kernel)(const CUtensorMap, const int8_t*, const float*, const float*,
                         const float*, float*, int, int, long long, long long, float);
  static const Kernel dot[] = {
      fused_stage1_int8_kernel<1, false>, fused_stage1_int8_kernel<2, false>,
      fused_stage1_int8_kernel<3, false>, fused_stage1_int8_kernel<4, false>,
      fused_stage1_int8_kernel<5, false>, fused_stage1_int8_kernel<6, false>,
      fused_stage1_int8_kernel<7, false>, fused_stage1_int8_kernel<8, false>};
  static const Kernel euclid[] = {
      fused_stage1_int8_kernel<1, true>, fused_stage1_int8_kernel<2, true>,
      fused_stage1_int8_kernel<3, true>, fused_stage1_int8_kernel<4, true>,
      fused_stage1_int8_kernel<5, true>, fused_stage1_int8_kernel<6, true>,
      fused_stage1_int8_kernel<7, true>, fused_stage1_int8_kernel<8, true>};
  const Kernel kernel = (euclidean ? euclid : dot)[k_steps - 1];
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((B + I8_ROWS - 1) / I8_ROWS), (unsigned)(n_pad / CHUNK));
  kernel<<<grid, I8_THREADS, smem, (cudaStream_t)stream>>>(
      map, static_cast<const int8_t*>(q8), static_cast<const float*>(q_scale),
      static_cast<const float*>(item_scale), static_cast<const float*>(item_bias),
      static_cast<float*>(out), B, stages, n_pad, n_items, shift);
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
