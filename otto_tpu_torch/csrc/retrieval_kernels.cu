// Retrieval kernels for Hopper (sm_90a): the fused stage-1 window max and the
// window peel.  Plain C entry points, loaded with ctypes by
// otto_tpu_torch/ops/_kernels.py.  Every entry point selects the tensors'
// device, launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() so that a refused launch is
// reported to the wrapper.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_sync.cuh"

namespace {

constexpr int WINDOW = 128;            // items per strided window
constexpr int CHUNK = WINDOW * WINDOW; // windows live inside 16384-item chunks
constexpr unsigned LANE_MASK = WINDOW - 1;

// ---------------------------------------------------------------------------
// K1: fused stage 1.
//
// Replaces otto_tpu/ops/pallas_retrieval.py::_stage1_kernel (launched by
// _stage1).  For every query b and every strided window (chunk c, lane l) it
// computes the scores of the 128 items j = c*16384 + a*128 + l, a = 0..127,
// against the augmented query row, replaces the low 7 bits of each score's
// float32 bits by a, and keeps the float maximum:
//     out[b, c*128 + l] = max_a bits_to_float((bits(q_b . t_j) & ~127) | a).
// The [B, N] score matrix is never stored.  The table is stored transposed,
// [DA, N_pad], so position a of chunk c is the 128 consecutive columns
// c*16384 + a*128 .. +127, and lane l is the l-th of them.
//
// Three routes, chosen by the wrapper from the dtype and DA
// (ops/fused_retrieval.py::stage1_route):
// - bf16 with DA <= 256 (the retriever's tables of dim <= 83):
//   fused_stage1_bf16_kernel, on the tensor cores; a table tile of DA rows
//   is one TMA box (at most 256 rows).
// - bf16 with 256 < DA <= 512 (compensated tables of dim 84-168):
//   fused_stage1_deep_kernel, on the tensor cores; a tile is two TMA boxes
//   and a block takes 64 of a window's 128 lanes.
// - float32, and bf16 with 512 < DA <= 2,048: fused_stage1_fma_kernel<T, MQ>,
//   float32 FMA on the CUDA cores in register tiles, the table staged by
//   TMA.  The tensor cores take float32 only as TF32, which would break the
//   float32 contract of table_dtype=float32; a bf16 table is converted to
//   float32 as it is read.
// ---------------------------------------------------------------------------

// --- bf16: wgmma fed by a TMA ring -----------------------------------------
//
// One block per (query tile of 128 rows, chunk); query tiles vary fastest,
// so the blocks of one chunk run together and share its table slice
// (DA * 16384 bf16, 3.3 MB at DA = 102) in L2.  Three warpgroups:
//
// - a producer (warpgroup 2; one thread works, the warpgroup keeps 40
//   registers) walks the 128 positions a and keeps a ring of `stages` table
//   tiles in flight.  A tile is [da_pad, 128] bf16, the columns of position
//   a, loaded by TMA as two boxes of [da_pad, 64] (64 bf16 = one 128-byte
//   swizzle row) into the 128-byte swizzled layout wgmma reads.  Rows DA ..
//   da_pad-1 lie outside the tensor and TMA fills them with zeros, which
//   pads the contraction to wgmma's depth of 16 and adds exactly 0.  Each
//   slot has a `full` mbarrier (TMA bytes) and an `empty` one (one arrival
//   per consumer warpgroup).
// - two consumers (warpgroups 0 and 1, 232 registers each) own 64 query
//   rows each.  They load their rows once, from device memory straight into
//   wgmma's A-fragment registers (zeros past DA and past B: a 204-byte
//   query row does not suit TMA, and A from registers spares the shared
//   memory bandwidth that two warpgroups re-reading A would take).  For
//   each position they run da_pad/16 wgmma.m64n128k16 (f32 += bf16 x bf16;
//   B = the tile, MN-major, "transpose-B") into 64 accumulator registers,
//   release the slot, and fold the tile into a register-resident best[64]:
//   in wgmma's accumulator layout a thread holds the same (row, column n)
//   in the same register for every tile, and column n of position a's tile
//   is lane n of the window, so the window max is one LOP3 (clear the low
//   7 bits, OR in a) and one FMNMX per element, with no shuffle and no
//   shared memory.  While one warpgroup runs that epilogue, the other's
//   wgmma keeps the tensor cores busy.  After a = 127, best goes to
//   out[b, c*128 + n] (rows >= B masked).
//
// What bounds it: tensor-core operations, 2*B*DA*N_pad (1.56e12 at the
// path's shape, 1.58 ms at 989 TFLOP/s), with the table read once from
// device memory.  What holds it above that bound: the contraction is padded
// from 102 to 112, and each warpgroup waits for its product before it folds
// it, so the tensor cores idle where the two warpgroups' epilogues meet.
// Measured on an H100, a deeper ring (7 slots) and a 2-CTA cluster that
// multicasts each tile (half the L2 reads) moved it by a few percent at
// most.  A second accumulator set, which would overlap each fold with the
// next product, does not fit in the registers: ptxas spills it.

constexpr int K1B_ROWS = 128;          // queries per block
constexpr int K1B_WG_ROWS = 64;        // queries per consumer warpgroup (wgmma M)
constexpr int K1B_CONSUMERS = 2;
constexpr int K1B_THREADS = 128 * (K1B_CONSUMERS + 1);
constexpr int K1B_BOX = 64;            // TMA box width: one 128-byte swizzle row

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all in 16-byte units) and the layout (1: 128-byte swizzle).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// d[64] (+)= A[64 x 16] . B[16 x 128]; A from registers (a thread's four
// bf16 pairs), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// Keeps the compiler from moving reads of the accumulators across the
// asynchronous product's issue and wait.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K_STEPS = da_pad / 16 is a template parameter so that the product's k
// loop unrolls: ptxas serializes wgmma issued from a loop it cannot unroll.
template <int K_STEPS>
__global__ void __launch_bounds__(K1B_THREADS, 1)
fused_stage1_bf16_kernel(const __grid_constant__ CUtensorMap table,
                         const __nv_bfloat16* __restrict__ q, float* __restrict__ out, int B,
                         int DA, int stages, long long n_pad) {
  constexpr int da_pad = 16 * K_STEPS;
  extern __shared__ uint8_t k1_smem[];
  // [ring: stages x tile][full x stages][empty x stages], the ring
  // 1024-byte aligned for the 128-byte swizzle
  const uint32_t ring = (smem_u32(k1_smem) + 1023u) & ~1023u;
  const uint32_t tile_bytes = (uint32_t)da_pad * WINDOW * 2;
  const uint32_t full0 = ring + (uint32_t)stages * tile_bytes;
  const uint32_t empty0 = full0 + 8u * stages;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const long long chunk = blockIdx.y;
  const int b0 = blockIdx.x * K1B_ROWS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8u * s, 1);
      mbar_init(empty0 + 8u * s, K1B_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == K1B_CONSUMERS) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      const int col0 = (int)(chunk * CHUNK);
      int s = 0;
      uint32_t phase = 0;
      for (int a = 0; a < WINDOW; ++a) {
        if (a >= stages) mbar_wait(empty0 + 8u * s, phase ^ 1u);
        const uint32_t full = full0 + 8u * s;
        const uint32_t dst = ring + (uint32_t)s * tile_bytes;
        mbar_expect_tx(full, tile_bytes);
        tma_load_2d(dst, &table, full, col0 + a * WINDOW, 0);
        tma_load_2d(dst + tile_bytes / 2, &table, full, col0 + a * WINDOW + K1B_BOX, 0);
        if (++s == stages) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    // this warpgroup's 64 query rows as wgmma A fragments, loaded once: in
    // k step ks, register r of thread (warp w, lane) holds row
    // 16w + lane/4 + 8(r&1), columns 16ks + 8(r>>1) + 2(lane%4) + {0, 1};
    // zeros past DA (the padded contraction) and past B
    uint32_t afrag[K_STEPS][4];
    {
      const int warp = tid / 32;
      const int lane = tid % 32;
      const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
      for (int ks = 0; ks < K_STEPS; ++ks) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int b = b0 + wg * K1B_WG_ROWS + 16 * warp + (lane >> 2) + 8 * (r & 1);
          const int k = 16 * ks + 8 * (r >> 1) + 2 * (lane & 3);
          const __nv_bfloat16* row = q + (long long)b * DA;
          const __nv_bfloat16 lo = (b < B && k < DA) ? row[k] : zero;
          const __nv_bfloat16 hi = (b < B && k + 1 < DA) ? row[k + 1] : zero;
          afrag[ks][r] = (uint32_t)__bfloat16_as_ushort(lo) |
                         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
        }
      }
    }
    float acc[64], best[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.0f;
      best[i] = -CUDART_INF_F;
    }
    int s = 0;
    uint32_t phase = 0;
    for (int a = 0; a < WINDOW; ++a) {
      const uint32_t tile = ring + (uint32_t)s * tile_bytes;
      mbar_wait(full0 + 8u * s, phase);
      // B: 128-byte swizzle, MN-major: the leading offset is the next 64
      // columns (the second TMA box), the stride offset the next 8 k rows
      // (1024 B); one k step of 16 rows is +2048 B
      const uint64_t desc_b = gmma_desc(tile, tile_bytes / 2, 1024, 1);
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < K_STEPS; ++k)
        wgmma_m64n128k16(acc, afrag[k], desc_b + (uint64_t)(128 * k), k);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_operands(acc);
      if (tid == 0) mbar_arrive(empty0 + 8u * s);
      const unsigned code = (unsigned)a;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        best[i] = fmaxf(best[i], __uint_as_float((__float_as_uint(acc[i]) & ~LANE_MASK) | code));
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }

    // accumulator layout of m64nNk16: register 4n + 2i + j of thread
    // (warp w, lane) holds row 16w + lane/4 + 8i, column 8n + 2(lane%4) + j
    const int warp = tid / 32;
    const int lane = tid % 32;
    const long long nw = n_pad / WINDOW;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = b0 + wg * K1B_WG_ROWS + warp * 16 + (lane >> 2) + 8 * i;
        if (b < B) {
          const long long col = chunk * WINDOW + 8 * n + 2 * (lane & 3);
          *reinterpret_cast<float2*>(out + (long long)b * nw + col) =
              make_float2(best[4 * n + 2 * i], best[4 * n + 2 * i + 1]);
        }
      }
    }
  }
}

// --- bf16 deeper than one TMA box: wgmma on 64-lane tiles --------------------
//
// fused_stage1_deep_kernel<K_STEPS> takes bf16 tables with 256 < DA <= 512
// (K_STEPS = da_pad/16 = 17..32): the compensated tables of dims 84-168,
// whose contraction 3(dim + 2) passes one TMA box.  Its layout and roles
// follow the kernel above, with three changes that the depth forces.
//
// - A block owns 128 query rows, one chunk and one half of the window's
//   lanes: 64 columns of each position a.  A warpgroup's output tile is then
//   64 rows x 64 lanes, so wgmma.m64n64k16 keeps 32 accumulators and the
//   window max 32 more.  Beside them the consumers still hold their 64 query
//   rows as A fragments in registers, K_STEPS x 4 of them (128 at DA 512):
//   192 in all at the deepest, under setmaxnreg's 232.  A 128-lane tile
//   would need 128 for the accumulators and the maxima, and spill.  Holding
//   A in shared memory instead ([128, da_pad] bf16, 75-128 KB) would leave
//   room for one or two table slots.  The query rows stay at 128 a block:
//   the table slice of a chunk is read from L2 once per query tile.
// - A table tile is [da_pad, 64] bf16 (one 128-byte swizzle row wide), loaded
//   as two TMA boxes of da_pad/2 rows under one `full` barrier; the second
//   lands at +da_pad*64 bytes, a multiple of 1024, so the 128-byte swizzle
//   runs on unbroken and a k step that straddles the boxes reads as any
//   other (+2048 bytes a step).  Rows DA .. da_pad-1 lie outside the tensor:
//   TMA fills them with zeros, which add exactly 0.  A slot is da_pad x 128
//   bytes (38,912 at DA 294), so the ring holds 3-5 slots.
// - The grid is (2 x query tiles, chunks), the lane half fastest: the
//   blocks of a chunk run together, both halves' reads of a table row (two
//   adjacent 128-byte runs) meet in L2 (L2 promotion of 256 bytes), and at a
//   small batch (B 256: 4 x 62 blocks at DA 294 over 1,015,808 items) twice
//   as many blocks keep the card's 132 SMs and its memory busy.
//
// What bounds it: at B = 256 the table's bytes (597 MB at DA 294, 0.181 ms;
// the operations need 0.155 ms), at B = 4,096 the tensor-core operations
// (2 B DA N_pad: 4.50e12 at [4096 x 294] x [294 x 1,867,776], 4.55 ms).
// What holds it above them: the contraction padded to a multiple of 16
// (294 -> 304, 3.4%), each warpgroup's wait for its product before it
// folds it (the other warpgroup's product fills the gap), the query rows'
// load at each block's start, and the table slice read from L2 once per
// 128 query rows (1/128 byte an operation).  Measured on an H100 (700 W):
// 0.237-0.250 ms at [256 x 294] x [294 x 1,015,808] (75-76% of the bytes
// bound; the FMA kernel takes 9.58-9.62 ms there), 6.69-6.85 ms at [4096 x
// 294] x [294 x 1,867,776] (67-68% of the operations bound, like the DA <=
// 256 kernel's 67-69% at DA 198), 65-67% at DA 390 and 510.  ptxas: no
// spill at any K_STEPS.

constexpr int K1D_MIN_STEPS = 17;  // DA 257-272
constexpr int K1D_MAX_DA = 512;    // two TMA boxes of at most 256 rows
constexpr int K1D_LANES = K1B_BOX;  // lanes per block: a 128-byte swizzle row of bf16
constexpr int K1D_MAX_STAGES = 8;

// d[32] (+)= A[64 x 16] . B[16 x 64]; A from registers, B MN-major in
// shared memory (as wgmma_m64n128k16).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int K_STEPS>
__global__ void __launch_bounds__(K1B_THREADS, 1)
fused_stage1_deep_kernel(const __grid_constant__ CUtensorMap table,
                         const __nv_bfloat16* __restrict__ q, float* __restrict__ out, int B,
                         int DA, int stages, long long n_pad) {
  constexpr int da_pad = 16 * K_STEPS;
  constexpr uint32_t tile_bytes = (uint32_t)da_pad * K1D_LANES * 2;
  constexpr uint32_t box_bytes = tile_bytes / 2;  // da_pad/2 rows of 128 bytes
  extern __shared__ uint8_t k1_smem[];
  // [ring: stages x tile][full x stages][empty x stages], the ring
  // 1024-byte aligned for the 128-byte swizzle
  const uint32_t ring = (smem_u32(k1_smem) + 1023u) & ~1023u;
  const uint32_t full0 = ring + (uint32_t)stages * tile_bytes;
  const uint32_t empty0 = full0 + 8u * stages;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int half = blockIdx.x & 1;
  const int b0 = (blockIdx.x >> 1) * K1B_ROWS;
  const long long chunk = blockIdx.y;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8u * s, 1);
      mbar_init(empty0 + 8u * s, K1B_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == K1B_CONSUMERS) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      const int col0 = (int)(chunk * CHUNK) + half * K1D_LANES;
      int s = 0;
      uint32_t phase = 0;
      for (int a = 0; a < WINDOW; ++a) {
        if (a >= stages) mbar_wait(empty0 + 8u * s, phase ^ 1u);
        const uint32_t full = full0 + 8u * s;
        const uint32_t dst = ring + (uint32_t)s * tile_bytes;
        mbar_expect_tx(full, tile_bytes);
        tma_load_2d(dst, &table, full, col0 + a * WINDOW, 0);
        tma_load_2d(dst + box_bytes, &table, full, col0 + a * WINDOW, da_pad / 2);
        if (++s == stages) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    // A fragments as in fused_stage1_bf16_kernel: in k step ks, register r
    // of thread (warp w, lane) holds row 16w + lane/4 + 8(r&1), columns
    // 16ks + 8(r>>1) + 2(lane%4) + {0, 1}; zeros past DA and past B
    uint32_t afrag[K_STEPS][4];
    {
      const int warp = tid / 32;
      const int lane = tid % 32;
      const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
      for (int ks = 0; ks < K_STEPS; ++ks) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int b = b0 + wg * K1B_WG_ROWS + 16 * warp + (lane >> 2) + 8 * (r & 1);
          const int k = 16 * ks + 8 * (r >> 1) + 2 * (lane & 3);
          const __nv_bfloat16* row = q + (long long)b * DA;
          const __nv_bfloat16 lo = (b < B && k < DA) ? row[k] : zero;
          const __nv_bfloat16 hi = (b < B && k + 1 < DA) ? row[k + 1] : zero;
          afrag[ks][r] = (uint32_t)__bfloat16_as_ushort(lo) |
                         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
        }
      }
    }
    float acc[32], best[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[i] = 0.0f;
      best[i] = -CUDART_INF_F;
    }
    int s = 0;
    uint32_t phase = 0;
    for (int a = 0; a < WINDOW; ++a) {
      const uint32_t tile = ring + (uint32_t)s * tile_bytes;
      mbar_wait(full0 + 8u * s, phase);
      // B: 128-byte swizzle, MN-major, one 64-column block (the leading
      // offset is not used); the stride offset is the next 8 k rows (1024
      // B), one k step of 16 rows +2048 B, across the two boxes alike
      const uint64_t desc_b = gmma_desc(tile, tile_bytes, 1024, 1);
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < K_STEPS; ++k)
        wgmma_m64n64k16(acc, afrag[k], desc_b + (uint64_t)(128 * k), k);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_operands(acc);
      if (tid == 0) mbar_arrive(empty0 + 8u * s);
      const unsigned code = (unsigned)a;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        best[i] = fmaxf(best[i], __uint_as_float((__float_as_uint(acc[i]) & ~LANE_MASK) | code));
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }

    // accumulator layout of m64n64k16: register 4n + 2i + j of thread
    // (warp w, lane) holds row 16w + lane/4 + 8i, lane 8n + 2(lane%4) + j of
    // this block's half
    const int warp = tid / 32;
    const int lane = tid % 32;
    const long long nw = n_pad / WINDOW;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = b0 + wg * K1B_WG_ROWS + warp * 16 + (lane >> 2) + 8 * i;
        if (b < B) {
          const long long col = chunk * WINDOW + half * K1D_LANES + 8 * n + 2 * (lane & 3);
          *reinterpret_cast<float2*>(out + (long long)b * nw + col) =
              make_float2(best[4 * n + 2 * i], best[4 * n + 2 * i + 1]);
        }
      }
    }
  }
}

// --- FMA: register tiles fed by a TMA ring ----------------------------------
//
// fused_stage1_fma_kernel<T, MQ> takes float32 tables (T = float) and bf16
// tables deeper than the deep wgmma kernel's 512 (T = __nv_bfloat16,
// converted to float32 as it is read).  Every score is the parent's:
// fmaf(q[b, d], t[d, j], acc) over d ascending from acc = +0.0, then the
// LOP3 pack and the fmaxf window max, so its output is bit-equal to the
// one-thread-a-lane kernel it replaced.
//
// What bounds it: the float32 FMA issue rate, 2 B DA N_pad operations at 67
// TFLOP/s (7.77 ms at topk_hybrid's [4096 x 34] x [34 x 1,867,776]; 0.76 ms
// at phase 3b's [256 x 98] x [98 x 1,015,808]).  Counting the window max's
// LOP3 and FMNMX too, it is B N_pad (DA + 2) CUDA-core instructions at 132
// SMs x 128 lanes x 1.98 GHz = 33.5e12 a second: 8.22 ms at DA 34.  The
// kernel before it gave each thread one lane and 32 queries: each FFMA came
// with a ninth of a global load and a quarter of a shared load, and the
// table was read from L2 once per 32 queries.  Here:
//
// - A block owns 16 MQ query rows (128 at MQ = 8), one chunk and all 128
//   lanes of its windows.  Two consumer warpgroups (256 threads) each own a
//   micro-tile of MQ queries x 8 lanes: queries qg + 16 i (i < MQ) and lanes
//   4 lg .. 4 lg + 3 and 64 + 4 lg .. +3, with qg, lg in 0..15.  A thread's
//   lanes stay fixed while the block walks the 128 positions a, so the
//   window max best[MQ][8] folds in registers with no shuffle.
// - The query tile is staged once as float32 in groups of 4 k: group g
//   holds [16 MQ rows][4] (zeros past DA and past B), so one 16-byte load
//   gives a query's next 4 k, the MQ queries of a thread sit at fixed
//   offsets, and the four query groups of a warp read 64 contiguous
//   bytes.  A k step costs MQ/4 + 2 shared loads (two 16-byte loads of the
//   table tile, 128 contiguous bytes a warp) for 8 MQ FFMA: 4 loads per 64
//   FFMA at MQ = 8, against the parent's 9 per 32.
// - The table arrives in k chunks: a tile is [kc, 128] (kc <= 64 rows of
//   position a's 128 consecutive columns, row pitch N_pad), one TMA box,
//   rows past DA zero-filled.  A producer warpgroup (one thread works)
//   keeps a ring of up to 4 tiles in flight behind `full` (TMA bytes) and
//   `empty` (one arrival per consumer warp) mbarriers; the consumers never
//   meet at a block barrier.  Each position takes ceil(DA / 64) tiles, so
//   the depth is bounded by the query tile alone: the launcher takes the
//   largest MQ of 8, 4, 2, 1 whose tile fits beside a ring of two tiles,
//   which holds DA <= 2,048 at MQ = 1.  A k chunk's rows past DA are never
//   multiplied (a chunk's last 1-3 rows take a scalar step), so each score
//   takes exactly DA FMAs, and a position's first FMA adds to +0.0 (the
//   zero register), so the accumulators need no reset between positions.
// - The grid is (query tiles, chunks), the query tiles fastest: the blocks
//   of one chunk run together and share its table slice in L2.  A batch of
//   B <= 64 rows takes the smallest tile that holds it (16, 32 or 64 rows)
//   rather than computing empty rows.  At phase 3b's B = 256 the grid is 2
//   x 62 = 124 blocks, one a card's SM: any split of 62 chunks by a power
//   of two fills 132 SMs no better (62 n / (132 ceil(62 n / 132)) = 94%).
//
// Measured on an H100 (700 W, the SM clock at 1,980 MHz throughout;
// tools/compare_parent_kernels.py k1fma, in turns with the kernel before
// it): 12.29 ms at [4096 x 34] x [34 x 1,867,776], 63.2% of the operations
// bound (the one-thread-a-lane kernel 21.71 ms); 1.194 ms at [256 x 98] x
// [98 x 1,015,808], 63.7% (3.232 ms).  The k loop issues 279 instructions
// per 256 FFMA (cuobjdump).  What holds it below the bound: the window max
// (64 LOP3 and 64 FMNMX a position, on the half-rate integer pipe) and the
// group's first shared loads meet both of a scheduler's two warps at once,
// since their tiles arrive together; a third consumer warpgroup does not
// fit in the registers, and four warpgroups of MQ = 4, a k loop unrolled or
// software-pipelined by hand, and tiles of 128 rows each timed slower or no
// faster in turns.

constexpr int K1F_CONSUMERS = 2;                  // consumer warpgroups
constexpr int K1F_CTHREADS = 128 * K1F_CONSUMERS;  // consumer threads
constexpr int K1F_THREADS = K1F_CTHREADS + 128;    // and the producer warpgroup
constexpr int K1F_KC_MAX = 64;                    // table rows a tile
constexpr int K1F_MAX_STAGES = 4;
constexpr int K1F_MIN_STAGES = 2;
constexpr int K1F_MAX_DA = 2048;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Lanes 4 lg .. +3 and 64 + 4 lg .. +3 of row k of a table tile, as float32.
__device__ __forceinline__ void tile_lanes(const float* row, int lg, float (&v)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(row)[lg];
  const float4 hi = reinterpret_cast<const float4*>(row + 64)[lg];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void tile_lanes(const __nv_bfloat16* row, int lg, float (&v)[8]) {
  const uint2 lo = reinterpret_cast<const uint2*>(row)[lg];
  const uint2 hi = reinterpret_cast<const uint2*>(row + 64)[lg];
  const uint32_t w[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its float32
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One group of 4 k of a thread's micro-tile: qk the group's query values,
// tile the group's first table row.  FIRST: the first k starts from +0.0.
template <typename T, int MQ, bool FIRST>
__device__ __forceinline__ void fma_group(float (&acc)[MQ][8], const float4* qk, const T* tile,
                                          int lg) {
  float4 qv[MQ];
#pragma unroll
  for (int i = 0; i < MQ; ++i) qv[i] = qk[16 * i];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float tv[8];
    tile_lanes(tile + kk * WINDOW, lg, tv);
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const float x = lane_of(qv[i], kk);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[i][c] = fmaf(x, tv[c], FIRST && kk == 0 ? 0.0f : acc[i][c]);
    }
  }
}

// Row k of a chunk (the group qk holds it) alone.
template <typename T, int MQ, bool FIRST>
__device__ __forceinline__ void fma_row(float (&acc)[MQ][8], const float4* qk, const T* tile,
                                        int lg, int k) {
  float tv[8];
  tile_lanes(tile + k * WINDOW, lg, tv);
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    const float x = reinterpret_cast<const float*>(qk + 16 * i)[k % 4];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(x, tv[c], FIRST ? 0.0f : acc[i][c]);
  }
}

template <typename T, int MQ>
__global__ void __launch_bounds__(K1F_THREADS, 1)
fused_stage1_fma_kernel(const __grid_constant__ CUtensorMap table, const T* __restrict__ q,
                        float* __restrict__ out, int B, int DA, int kc, int nk, int stages,
                        long long n_pad) {
  constexpr int TQ = 16 * MQ;
  extern __shared__ __align__(16) uint8_t k1f_smem[];
  // [ring: stages x kc x 128 T][query tile: nk kc / 4 groups x TQ x 4
  // float][full][empty],
  // the ring 1024-byte aligned
  const uint32_t base = smem_u32(k1f_smem);
  const uint32_t ring = (base + 1023u) & ~1023u;
  uint8_t* ring_ptr = k1f_smem + (ring - base);
  const uint32_t tile_bytes = (uint32_t)kc * WINDOW * sizeof(T);
  float* qs = reinterpret_cast<float*>(ring_ptr + (size_t)stages * tile_bytes);
  const uint32_t full0 = ring + (uint32_t)stages * tile_bytes + (uint32_t)(TQ * nk * kc * 4);
  const uint32_t empty0 = full0 + 8u * stages;
  const long long chunk = blockIdx.y;
  const int b0 = blockIdx.x * TQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8u * s, 1);
      mbar_init(empty0 + 8u * s, K1F_CTHREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= K1F_CTHREADS) {
    // ---- producer: position a's k chunks j = 0 .. nk-1, in that order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == K1F_CTHREADS) {
      const int col0 = (int)(chunk * CHUNK);
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < WINDOW * nk; ++i) {
        const int a = i / nk;
        if (i >= stages) mbar_wait(empty0 + 8u * s, phase ^ 1u);
        const uint32_t full = full0 + 8u * s;
        mbar_expect_tx(full, tile_bytes);
        tma_load_2d(ring + (uint32_t)s * tile_bytes, &table, full, col0 + a * WINDOW,
                    (i - a * nk) * kc);
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
  const int tid = threadIdx.x;
  for (int i = tid; i < TQ * nk * kc; i += K1F_CTHREADS) {
    const int g = i / (4 * TQ);
    const int r = (i / 4) % TQ;
    const int d = 4 * g + i % 4;
    const int b = b0 + r;
    qs[i] = (b < B && d < DA) ? to_f32(q[(long long)b * DA + d]) : 0.0f;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(K1F_CTHREADS) : "memory");  // consumers only

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qg = (warp >> 1) * 4 + (lane >> 3);  // a warp: 4 query groups x 8 lane groups
  const int lg = (warp & 1) * 8 + (lane & 7);
  // group g of query i of the thread: q4[g TQ + 16 i]
  const float4* q4 = reinterpret_cast<const float4*>(qs) + qg;

  float acc[MQ][8], best[MQ][8];  // acc set by each position's first FMA
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      best[i][j] = -CUDART_INF_F;
    }
  }

  int s = 0;
  uint32_t phase = 0;
  for (int a = 0; a < WINDOW; ++a) {
    for (int j = 0; j < nk; ++j) {
      mbar_wait(full0 + 8u * s, phase);
      const T* tile = reinterpret_cast<const T*>(ring_ptr + (size_t)s * tile_bytes);
      const float4* qk = q4 + (j * kc / 4) * TQ;
      const int rows = min(kc, DA - j * kc);
      int k = 0;
      if (j == 0) {  // the position's first FMA adds to +0.0 (no reset of acc)
        if (rows >= 4) {
          fma_group<T, MQ, true>(acc, qk, tile, lg);
          k = 4;
          qk += TQ;
        } else {
          fma_row<T, MQ, true>(acc, qk, tile, lg, 0);
          k = 1;
        }
      }
      for (; k + 4 <= rows; k += 4, qk += TQ)
        fma_group<T, MQ, false>(acc, qk, tile + k * WINDOW, lg);
      for (; k < rows; ++k) fma_row<T, MQ, false>(acc, qk, tile, lg, k);
      __syncwarp();  // the warp's reads of the slot are done
      if (lane == 0) mbar_arrive(empty0 + 8u * s);
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }
    const unsigned code = (unsigned)a;
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        best[i][c] =
            fmaxf(best[i][c], __uint_as_float((__float_as_uint(acc[i][c]) & ~LANE_MASK) | code));
      }
    }
  }

  const long long nw = n_pad / WINDOW;
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    const int b = b0 + qg + 16 * i;
    if (b < B) {
      float* o = out + (long long)b * nw + chunk * WINDOW;
      reinterpret_cast<float4*>(o)[lg] =
          make_float4(best[i][0], best[i][1], best[i][2], best[i][3]);
      reinterpret_cast<float4*>(o + 64)[lg] =
          make_float4(best[i][4], best[i][5], best[i][6], best[i][7]);
    }
  }
}

// A tensor map of the table t [DA, N_pad] (elements of `type`, `elem`
// bytes) in boxes of [box_rows, box_cols]; rows past DA zero-filled.
// Returns 0, -1 when cuTensorMapEncodeTiled is not found, or -1000 -
// CUresult when the map is refused.
int encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* t, int DA,
               long long n_pad, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[2] = {(cuuint64_t)n_pad, (cuuint64_t)DA};
  const cuuint64_t strides[1] = {(cuuint64_t)n_pad * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUresult r = encode(map, type, 2, const_cast<void*>(t), dims, strides, box, elem_strides,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

// The bf16 table as the wgmma kernels read it: [box_rows, 64] boxes (64
// bf16 = one 128-byte swizzle row).
int encode_table_map(CUtensorMap* map, const void* t, int DA, long long n_pad, int box_rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, t, DA, n_pad, K1B_BOX, box_rows,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

constexpr int K1B_MAX_DA = 256;   // a TMA box has at most 256 rows
constexpr int K1B_MAX_STAGES = 4;

// Launch shape: the contraction padded to wgmma's depth of 16, and as many
// ring slots (up to 4) as the card's per-block shared memory holds beside
// two mbarriers per slot and 1024 bytes of slack for the ring's alignment.
// Errors: a cudaError_t, or -1 when cuTensorMapEncodeTiled is not found, or -(CUresult)
// - 1000 when the tensor map is refused.
int launch_fused_stage1_bf16(const void* q, const void* t, void* out, int B, int DA,
                             long long n_pad, int device, void* stream) {
  if (DA < 1 || DA > K1B_MAX_DA) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  int smem_max = 0;
  dev_err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int da_pad = (DA + 15) / 16 * 16;
  const int slot_bytes = da_pad * WINDOW * 2 + 16;  // a tile and its two mbarriers
  int stages = (smem_max - 1024) / slot_bytes;
  if (stages > K1B_MAX_STAGES) stages = K1B_MAX_STAGES;
  if (stages < 1) return (int)cudaErrorInvalidConfiguration;
  const int smem = 1024 + stages * slot_bytes;
  CUtensorMap map;
  const int map_err = encode_table_map(&map, t, DA, n_pad, da_pad);
  if (map_err != 0) return map_err;
  typedef void (*Kernel)(const CUtensorMap, const __nv_bfloat16*, float*, int, int, int,
                         long long);
  static const Kernel kernels[] = {
      fused_stage1_bf16_kernel<1>,  fused_stage1_bf16_kernel<2>,  fused_stage1_bf16_kernel<3>,
      fused_stage1_bf16_kernel<4>,  fused_stage1_bf16_kernel<5>,  fused_stage1_bf16_kernel<6>,
      fused_stage1_bf16_kernel<7>,  fused_stage1_bf16_kernel<8>,  fused_stage1_bf16_kernel<9>,
      fused_stage1_bf16_kernel<10>, fused_stage1_bf16_kernel<11>, fused_stage1_bf16_kernel<12>,
      fused_stage1_bf16_kernel<13>, fused_stage1_bf16_kernel<14>, fused_stage1_bf16_kernel<15>,
      fused_stage1_bf16_kernel<16>};
  const Kernel kernel = kernels[da_pad / 16 - 1];
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + K1B_ROWS - 1) / K1B_ROWS, (unsigned)(n_pad / CHUNK));
  kernel<<<grid, K1B_THREADS, smem, (cudaStream_t)stream>>>(
      map, static_cast<const __nv_bfloat16*>(q), static_cast<float*>(out), B, DA, stages,
      n_pad);
  return (int)cudaGetLastError();
}

// The deep route, 256 < DA <= 512.  Launch shape: the contraction padded to
// wgmma's depth of 16, boxes of half of it, and as many ring slots (up to
// 8) as the card's per-block shared memory holds.  Errors as
// launch_fused_stage1_bf16's.
int launch_fused_stage1_deep(const void* q, const void* t, void* out, int B, int DA,
                             long long n_pad, int device, void* stream) {
  if (DA <= K1B_MAX_DA || DA > K1D_MAX_DA) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  int smem_max = 0;
  dev_err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int da_pad = (DA + 15) / 16 * 16;
  const int slot_bytes = da_pad * K1D_LANES * 2 + 16;  // a tile and its two mbarriers
  const int stages = std::min((smem_max - 1024) / slot_bytes, K1D_MAX_STAGES);
  if (stages < 1) return (int)cudaErrorInvalidConfiguration;
  const int smem = 1024 + stages * slot_bytes;
  CUtensorMap map;
  const int map_err = encode_table_map(&map, t, DA, n_pad, da_pad / 2);
  if (map_err != 0) return map_err;
  typedef void (*Kernel)(const CUtensorMap, const __nv_bfloat16*, float*, int, int, int,
                         long long);
  static const Kernel kernels[] = {
      fused_stage1_deep_kernel<17>, fused_stage1_deep_kernel<18>, fused_stage1_deep_kernel<19>,
      fused_stage1_deep_kernel<20>, fused_stage1_deep_kernel<21>, fused_stage1_deep_kernel<22>,
      fused_stage1_deep_kernel<23>, fused_stage1_deep_kernel<24>, fused_stage1_deep_kernel<25>,
      fused_stage1_deep_kernel<26>, fused_stage1_deep_kernel<27>, fused_stage1_deep_kernel<28>,
      fused_stage1_deep_kernel<29>, fused_stage1_deep_kernel<30>, fused_stage1_deep_kernel<31>,
      fused_stage1_deep_kernel<32>};
  const Kernel kernel = kernels[da_pad / 16 - K1D_MIN_STEPS];
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // x: query tile x 2 lane halves, the half fastest; y: the chunk
  const dim3 grid(2u * (unsigned)((B + K1B_ROWS - 1) / K1B_ROWS), (unsigned)(n_pad / CHUNK));
  kernel<<<grid, K1B_THREADS, smem, (cudaStream_t)stream>>>(
      map, static_cast<const __nv_bfloat16*>(q), static_cast<float*>(out), B, DA, stages,
      n_pad);
  return (int)cudaGetLastError();
}

// The FMA route.  Launch shape, from DA and B: k chunks of kc <= 64 rows,
// nk a position; the query tile the smallest of 16, 32 and 64 rows that
// holds B (128 rows for larger B), halved while it does not fit beside two
// ring slots in the card's per-block shared memory; as many ring slots (up
// to 4) as fit.  Errors: a cudaError_t (cudaErrorInvalidValue for B < 1 or
// DA outside 1..2,048), -1 when cuTensorMapEncodeTiled is not found, or
// -1000 - CUresult when the tensor map is refused.
template <typename T>
int launch_fused_stage1_fma(const void* q, const void* t, void* out, int B, int DA,
                            long long n_pad, int device, void* stream) {
  if (B < 1 || DA < 1 || DA > K1F_MAX_DA) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int smem_max = 0;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  const int nk = (DA + K1F_KC_MAX - 1) / K1F_KC_MAX;
  const int kc = ((DA + nk - 1) / nk + 3) / 4 * 4;
  const int slot_bytes = kc * WINDOW * (int)sizeof(T) + 16;  // a tile and its two mbarriers
  const auto q_bytes = [&](int mq) { return 16 * mq * nk * kc * 4; };
  int mq = 8;
  while (mq > 1 && 8 * mq >= B) mq /= 2;
  while (mq > 1 && 1024 + K1F_MIN_STAGES * slot_bytes + q_bytes(mq) > smem_max) mq /= 2;
  const int stages = std::min(K1F_MAX_STAGES, (smem_max - 1024 - q_bytes(mq)) / slot_bytes);
  if (stages < K1F_MIN_STAGES) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + stages * slot_bytes + q_bytes(mq);
  CUtensorMap map;
  const bool f32 = sizeof(T) == 4;
  const int map_err = encode_map(&map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                 (int)sizeof(T), t, DA, n_pad, WINDOW, kc,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (map_err != 0) return map_err;
  typedef void (*Kernel)(const CUtensorMap, const T*, float*, int, int, int, int, int,
                         long long);
  const Kernel kernel = mq == 8   ? fused_stage1_fma_kernel<T, 8>
                        : mq == 4 ? fused_stage1_fma_kernel<T, 4>
                        : mq == 2 ? fused_stage1_fma_kernel<T, 2>
                                  : fused_stage1_fma_kernel<T, 1>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((B + 16 * mq - 1) / (16 * mq)), (unsigned)(n_pad / CHUNK));
  kernel<<<grid, K1F_THREADS, smem, (cudaStream_t)stream>>>(
      map, static_cast<const T*>(q), static_cast<float*>(out), B, DA, kc, nk, stages, n_pad);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2: window peel.
//
// Replaces otto_tpu/ops/row_topk.py::_peel_kernel (launched by peel_rows).
// For every row b and every 128-column window w, R rounds: take the window's
// maximum, write it to vals[b, r, w] and the first column holding it to
// cols[b, r, w] = w*128 + argmax, then set every slot equal to that maximum
// to -inf (the reference clears all equal slots, not only the first).  Put
// another way: the R largest distinct values of the window, each with its
// smallest column; once the window holds no value above -inf, every later
// round gives (-inf, w*128 + 0).
//
// Design: one thread per window, one warp per tile of 32 windows of a row
// (16 KB, the last tile of a row shorter), on a persistent grid.
// - Staging.  Each warp owns one shared-memory slot.  Its lanes copy their
//   windows (512 bytes each) with one cp.async.bulk apiece, completing on
//   the warp's mbarrier, into rows of 528 bytes: the 16-byte pad puts the
//   float4 q of lanes t..t+7 in distinct banks, so a lane reads its window
//   into 32 float4 registers with no bank conflict and with the column of
//   every register known at compile time.  As soon as the window is in
//   registers the warp starts the copy of its next tile into the same slot,
//   so those bytes are in flight while the rounds run.
// - Rounds.  Round r is one pass over the 128 registers: the largest value
//   strictly below round r-1's value, and the first column holding it
//   ("v < prev && v > best", kept in four independent chains, one per
//   column mod 4, merged with ties to the smaller column).  Four
//   instructions an element a round, no shuffles, no ballots, no
//   divergence, and any R with the same registers.  A window that runs out
//   of values skips the passes left.
// - Stores.  Lane t writes vals[b, r, w0 + t] and cols[b, r, w0 + t]: each
//   round's stores of a warp are two 128-byte transactions.
// - Float rules: comparisons only, no arithmetic on the values, so
//   denormals (K1's pad windows pack to bit patterns in [0, 128)) stay
//   distinct; built without fast math or flush-to-zero.  NaN is outside the
//   contract.
//
// What bounds it: the bytes set the least time (the input read once and R
// (value, column) pairs a window written: 239 MB + 22.4 MB at [4096,
// 14,592], R = 6, 0.078 ms at 3.35 TB/s), but the rounds take the time:
// their compares and selects issue at half a warp a clock on Hopper's
// integer/compare pipe.  On an H100 (700 W) the staging and loads alone run
// in ~0.085 ms and the whole kernel in ~0.136 ms at that shape; the cost of
// the rounds grows with R.
// ---------------------------------------------------------------------------

constexpr int K2_TILE = 32;                       // windows per warp tile, one per lane
constexpr int K2_WARPS = 4;                       // warps per block
constexpr int K2_ROW_BYTES = (WINDOW + 4) * 4;    // a staged window, padded: 528
constexpr int K2_SLOT_BYTES = K2_TILE * K2_ROW_BYTES;
constexpr int K2_SMEM = K2_WARPS * K2_SLOT_BYTES + 8 * K2_WARPS;  // slots, then mbarriers

// One round over a window in registers: the largest value strictly below
// `below` (any value when kFirst) and the smallest column holding it, or
// (-inf, 0) when there is none.
template <bool kFirst>
__device__ __forceinline__ void peel_round(const float4 (&v)[K2_TILE], float below, float& best,
                                           int& col) {
  float b[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  int c[4] = {0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < K2_TILE; ++q) {
    const float e[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // columns ascend within a chain, so ">" keeps the first of equals
      if ((kFirst || e[k] < below) && e[k] > b[k]) {
        b[k] = e[k];
        c[k] = 4 * q + k;
      }
    }
  }
  best = b[0];
  col = c[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (b[k] > best || (b[k] == best && c[k] < col)) {
      best = b[k];
      col = c[k];
    }
  }
}

__global__ void __launch_bounds__(K2_WARPS * 32, 3)
peel_rows_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ cols, int B, int M, int rounds) {
  extern __shared__ __align__(16) uint8_t k2_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t slot = smem_u32(k2_smem) + warp * K2_SLOT_BYTES;
  const uint32_t bar = smem_u32(k2_smem) + K2_WARPS * K2_SLOT_BYTES + 8u * warp;
  const float4* mine =
      reinterpret_cast<const float4*>(k2_smem + warp * K2_SLOT_BYTES + lane * K2_ROW_BYTES);
  const int W = M / WINDOW;
  const int per_row = (W + K2_TILE - 1) / K2_TILE;
  const long long n_tiles = (long long)B * per_row;
  const long long stride = (long long)gridDim.x * K2_WARPS;
  long long g = (long long)blockIdx.x * K2_WARPS + warp;
  if (g >= n_tiles) return;  // whole warps exit together

  if (lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // lane 0 arms the barrier for the tile's bytes, then each lane with a
  // window copies it
  auto issue = [&](long long tile) {
    const long long b = tile / per_row;
    const int w0 = (int)(tile - b * per_row) * K2_TILE;
    const int n = min(K2_TILE, W - w0);
    if (lane == 0) mbar_expect_tx(bar, (uint32_t)n * WINDOW * 4);
    __syncwarp();
    if (lane < n)
      bulk_load(slot + lane * K2_ROW_BYTES, x + b * M + (long long)(w0 + lane) * WINDOW,
                WINDOW * 4, bar);
  };

  issue(g);
  uint32_t phase = 0;
  for (; g < n_tiles; g += stride) {
    const long long b = g / per_row;
    const int w0 = (int)(g - b * per_row) * K2_TILE;
    const bool live = lane < W - w0;
    mbar_wait(bar, phase);
    phase ^= 1u;
    float4 v[K2_TILE];
    if (live) {
#pragma unroll
      for (int q = 0; q < K2_TILE; ++q) v[q] = mine[q];
    }
    // every lane's reads of the slot come before the next copy into it
    __syncwarp();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (g + stride < n_tiles) issue(g + stride);
    if (!live) continue;

    const int w = w0 + lane;
    float* vo = vals + b * rounds * W + w;
    int* co = cols + b * rounds * W + w;
    float m;
    int c;
    peel_round<true>(v, 0.0f, m, c);
    vo[0] = m;
    co[0] = w * WINDOW + c;
    for (int r = 1; r < rounds; ++r) {
      if (m == -CUDART_INF_F) {
        c = 0;  // nothing left above -inf: the window's first slot
      } else {
        const float prev = m;
        peel_round<false>(v, prev, m, c);
      }
      vo[(long long)r * W] = m;
      co[(long long)r * W] = w * WINDOW + c;
    }
  }
}

// Persistent grid: as many blocks as fit on the card at once (three per SM
// on an H100), capped by the tile count.  The grid size and the shared-memory
// opt-in are worked out once per device.
int launch_peel_rows(const void* x, void* vals, void* cols, int B, int M, int rounds,
                     int device, void* stream) {
  constexpr int MAX_DEVICES = 64;
  static int resident[MAX_DEVICES] = {0};  // blocks the card holds at once
  if (device < 0 || device >= MAX_DEVICES || B < 1 || M < WINDOW || M % WINDOW ||
      rounds < 1 || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (resident[device] == 0) {
    e = cudaFuncSetAttribute(peel_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K2_SMEM);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, peel_rows_kernel, K2_WARPS * 32,
                                                      K2_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[device] = sms * per_sm;
  }
  const int W = M / WINDOW;
  const long long tiles = (long long)B * ((W + K2_TILE - 1) / K2_TILE);
  const long long blocks =
      std::min((tiles + K2_WARPS - 1) / K2_WARPS, (long long)resident[device]);
  peel_rows_kernel<<<(unsigned)blocks, K2_WARPS * 32, K2_SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(vals), static_cast<int*>(cols), B, M,
      rounds);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_stage1_bf16(const void* q, const void* t, void* out, int B, int DA,
                      long long n_pad, int device, void* stream) {
  return launch_fused_stage1_bf16(q, t, out, B, DA, n_pad, device, stream);
}

int fused_stage1_bf16_deep(const void* q, const void* t, void* out, int B, int DA,
                           long long n_pad, int device, void* stream) {
  return launch_fused_stage1_deep(q, t, out, B, DA, n_pad, device, stream);
}

int fused_stage1_f32(const void* q, const void* t, void* out, int B, int DA,
                     long long n_pad, int device, void* stream) {
  return launch_fused_stage1_fma<float>(q, t, out, B, DA, n_pad, device, stream);
}

int fused_stage1_bf16_fma(const void* q, const void* t, void* out, int B, int DA,
                          long long n_pad, int device, void* stream) {
  return launch_fused_stage1_fma<__nv_bfloat16>(q, t, out, B, DA, n_pad, device, stream);
}

int peel_rows_f32(const void* x, void* vals, void* cols, int B, int M, int rounds,
                  int device, void* stream) {
  return launch_peel_rows(x, vals, cols, B, M, rounds, device, stream);
}

}  // extern "C"
