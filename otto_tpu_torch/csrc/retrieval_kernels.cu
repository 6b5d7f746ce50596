// Retrieval kernels for Hopper (sm_90a): the fused stage-1 window max and the
// window peel.  Plain C entry points, loaded with ctypes by
// otto_tpu_torch/ops/_kernels.py.  Every entry point selects the tensors'
// device, launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() so that a refused launch is
// reported to the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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
// The [B, N] score matrix is never stored.
//
// Design: one block per (query tile of TQ rows, chunk); one thread per lane
// l, looping over the 128 positions a.  The query tile sits in shared memory
// as float32, laid out [d][TQ] so that one 16-byte broadcast load feeds four
// FMAs.  The table is read transposed ([DA, N_pad]): for fixed (d, a) the 128
// threads of a block read 128 consecutive columns, so the loads coalesce.
// Scores accumulate in float32 FMA over d in ascending order.  Blocks of one
// chunk are adjacent in launch order (blockIdx.x runs over query tiles), so
// the chunk's table slice (DA*16384 elements) is served from L2 to all of
// them.
//
// What bounds it: FMA throughput.  Each table element read feeds TQ FMAs; at
// DA = 102 (the compensated table) a 4096-query batch over 1,867,776 items is
// 7.8e11 FMAs.  Tensor cores (wgmma over bf16 tiles, with the pack and max in
// the epilogue) are the next step; this simple form is the correct baseline.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int K1_TQ = 32;       // queries per block
constexpr int K1_THREADS = 128; // one thread per lane of the window

template <typename T>
__global__ void __launch_bounds__(K1_THREADS)
fused_stage1_kernel(const T* __restrict__ q, const T* __restrict__ t,
                    float* __restrict__ out, int B, int DA, long long n_pad) {
  extern __shared__ float4 qs4[];  // [DA][K1_TQ] float32
  float* qs = reinterpret_cast<float*>(qs4);
  const int b0 = blockIdx.x * K1_TQ;
  const long long chunk = blockIdx.y;
  const int l = threadIdx.x;

  for (int i = threadIdx.x; i < DA * K1_TQ; i += blockDim.x) {
    const int d = i / K1_TQ;
    const int r = i - d * K1_TQ;
    const int b = b0 + r;
    qs[i] = (b < B) ? to_f32(q[(long long)b * DA + d]) : 0.0f;
  }
  __syncthreads();

  float best[K1_TQ];
#pragma unroll
  for (int r = 0; r < K1_TQ; ++r) best[r] = -CUDART_INF_F;

  const T* col0 = t + chunk * CHUNK + l;
  for (int a = 0; a < WINDOW; ++a) {
    float acc[K1_TQ];
#pragma unroll
    for (int r = 0; r < K1_TQ; ++r) acc[r] = 0.0f;
    const T* col = col0 + a * WINDOW;
#pragma unroll 2
    for (int d = 0; d < DA; ++d) {
      const float x = to_f32(col[(long long)d * n_pad]);
      const float4* qv = qs4 + d * (K1_TQ / 4);
#pragma unroll
      for (int r4 = 0; r4 < K1_TQ / 4; ++r4) {
        const float4 v = qv[r4];
        acc[4 * r4 + 0] = fmaf(v.x, x, acc[4 * r4 + 0]);
        acc[4 * r4 + 1] = fmaf(v.y, x, acc[4 * r4 + 1]);
        acc[4 * r4 + 2] = fmaf(v.z, x, acc[4 * r4 + 2]);
        acc[4 * r4 + 3] = fmaf(v.w, x, acc[4 * r4 + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < K1_TQ; ++r) {
      const unsigned bits = (__float_as_uint(acc[r]) & ~LANE_MASK) | (unsigned)a;
      best[r] = fmaxf(best[r], __uint_as_float(bits));
    }
  }

  const long long nw = n_pad / WINDOW;
#pragma unroll
  for (int r = 0; r < K1_TQ; ++r) {
    const int b = b0 + r;
    if (b < B) out[(long long)b * nw + chunk * WINDOW + l] = best[r];
  }
}

template <typename T>
int launch_fused_stage1(const void* q, const void* t, void* out, int B, int DA,
                        long long n_pad, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const dim3 grid((B + K1_TQ - 1) / K1_TQ, (unsigned)(n_pad / CHUNK));
  const size_t smem = (size_t)DA * K1_TQ * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_stage1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_stage1_kernel<T><<<grid, K1_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(t), static_cast<float*>(out),
      B, DA, n_pad);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2: window peel.
//
// Replaces otto_tpu/ops/row_topk.py::_peel_kernel (launched by peel_rows).
// For every row b and every 128-column window w, R rounds: take the window's
// maximum, write it to vals[b, r, w] and the first column holding it to
// cols[b, r, w] = w*128 + argmax, then set every slot equal to that maximum
// to -inf (the reference clears all equal slots, not only the first).
//
// Design: one warp per (row, window).  Lane i holds window positions
// i, i+32, i+64, i+96 in registers, so each of the four loads of a warp reads
// 128 consecutive bytes.  A round is a butterfly shuffle max, then a ballot
// per register slot: with this layout ballot bit order is position order, so
// the first set bit of the first non-empty ballot is the first-match argmax.
//
// What bounds it: device-memory bytes.  The input is read once
// ([B, 14,592] float32 at full width) and R*W (value, column) pairs are
// written per row; there is no reuse to exploit.
// ---------------------------------------------------------------------------

constexpr int K2_WARPS = 8;

__global__ void __launch_bounds__(K2_WARPS * 32)
peel_rows_kernel(const float* __restrict__ x, float* __restrict__ vals,
                 int* __restrict__ cols, int B, int M, int rounds) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * K2_WARPS + (threadIdx.x >> 5);
  const int W = M / WINDOW;
  if (g >= (long long)B * W) return;  // whole warps exit together
  const long long b = g / W;
  const int w = (int)(g - b * W);

  const float* src = x + b * M + (long long)w * WINDOW;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = src[lane + 32 * i];

  const long long out_row = b * (long long)rounds * W;
  for (int r = 0; r < rounds; ++r) {
    float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    int pos = WINDOW;
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      const unsigned m = __ballot_sync(0xffffffffu, v[i] == mx);
      if (m) pos = 32 * i + (__ffs(m) - 1);
    }
    if (lane == 0) {
      vals[out_row + (long long)r * W + w] = mx;
      cols[out_row + (long long)r * W + w] = w * WINDOW + pos;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (v[i] == mx) ? -CUDART_INF_F : v[i];
  }
}

}  // namespace

extern "C" {

int fused_stage1_bf16(const void* q, const void* t, void* out, int B, int DA,
                      long long n_pad, int device, void* stream) {
  return launch_fused_stage1<__nv_bfloat16>(q, t, out, B, DA, n_pad, device, stream);
}

int fused_stage1_f32(const void* q, const void* t, void* out, int B, int DA,
                     long long n_pad, int device, void* stream) {
  return launch_fused_stage1<float>(q, t, out, B, DA, n_pad, device, stream);
}

int peel_rows_f32(const void* x, void* vals, void* cols, int B, int M, int rounds,
                  int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long warps = (long long)B * (M / WINDOW);
  const unsigned blocks = (unsigned)((warps + K2_WARPS - 1) / K2_WARPS);
  peel_rows_kernel<<<blocks, K2_WARPS * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(vals), static_cast<int*>(cols),
      B, M, rounds);
  return (int)cudaGetLastError();
}

}  // extern "C"
