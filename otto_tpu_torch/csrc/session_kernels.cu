// Session kernels for Hopper (sm_90a): the per-session aid vote.  Plain C
// entry point, loaded with ctypes by otto_tpu_torch/ops/_kernels.py.  It
// selects the tensors' device, launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so that a
// refused launch is reported to the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K3: session aid vote.
//
// Replaces otto_tpu/ops/pallas_sessions.py::_vote_kernel (launched by
// aid_vote_aggregate).  Per session row of L aids (padding -1) and weights:
//     agg[i]      = sum_j w[j] * (a[j] == a[i])          (a[i] >= 0, else 0)
//     firstpos[i] = min j with a[j] == a[i]              (a[i] >= 0, else L)
//     first[i]    = a[i] >= 0 && firstpos[i] == i
// The [L, L] equality tile is never stored.
//
// Design: one block per row, one thread per position i (blockDim = L rounded
// up to a warp, L <= 1024).  The row's aids and weights are staged in shared
// memory, padded to a multiple of four with an aid (-2) that equals no real
// or padding aid and a zero weight.  Thread i walks j = 0..L-1 in ascending
// order, four positions per step through 16-byte loads; every thread of a
// warp reads the same address, so each load is a shared-memory broadcast.
// The sum runs in that fixed order, so the result does not depend on the
// launch.
//
// What bounds it: shared-memory load and compare issue, L^2 per row
// (4096 x 256 x 256 = 2.7e8 compare-adds at the serving shape); device
// memory moves only 5 x 4 bytes per position.  The vector loads cut the
// load instructions by four.
// ---------------------------------------------------------------------------

constexpr int K3_MAX_L = 1024;
constexpr int K3_PAD_AID = -2;

__device__ __forceinline__ void vote_step(int a, float w, int j, int ai, float& acc,
                                          int& fp) {
  const bool eq = (a == ai);
  acc += eq ? w : 0.0f;
  fp = (eq && j < fp) ? j : fp;
}

__global__ void __launch_bounds__(K3_MAX_L)
aid_vote_kernel(const int* __restrict__ aids, const float* __restrict__ w,
                float* __restrict__ agg, int* __restrict__ first,
                int* __restrict__ firstpos, int L, int Lp) {
  extern __shared__ int4 smem4[];  // aids [Lp] int32, then weights [Lp] float32
  int* sa = reinterpret_cast<int*>(smem4);
  float* sw = reinterpret_cast<float*>(sa + Lp);
  const long long row = blockIdx.x;
  const int i = threadIdx.x;

  int ai = K3_PAD_AID;
  if (i < L) {
    ai = aids[row * L + i];
    sa[i] = ai;
    sw[i] = w[row * L + i];
  } else if (i < Lp) {
    sa[i] = K3_PAD_AID;
    sw[i] = 0.0f;
  }
  __syncthreads();
  if (i >= L) return;

  float acc = 0.0f;
  int fp = L;
  if (ai >= 0) {
    const int4* a4 = reinterpret_cast<const int4*>(sa);
    const float4* w4 = reinterpret_cast<const float4*>(sw);
    for (int q = 0; q < Lp / 4; ++q) {
      const int4 a = a4[q];
      const float4 v = w4[q];
      vote_step(a.x, v.x, 4 * q + 0, ai, acc, fp);
      vote_step(a.y, v.y, 4 * q + 1, ai, acc, fp);
      vote_step(a.z, v.z, 4 * q + 2, ai, acc, fp);
      vote_step(a.w, v.w, 4 * q + 3, ai, acc, fp);
    }
  }
  const long long o = row * L + i;
  agg[o] = acc;
  firstpos[o] = fp;
  first[o] = (ai >= 0 && fp == i) ? 1 : 0;
}

}  // namespace

extern "C" {

int aid_vote_f32(const void* aids, const void* w, void* agg, void* first, void* firstpos,
                 int S, int L, int device, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (L < 1 || L > K3_MAX_L || S < 1) return (int)cudaErrorInvalidValue;
  const int threads = (L + 31) / 32 * 32;  // a multiple of 4, >= L
  const int Lp = threads;
  const size_t smem = (size_t)Lp * (sizeof(int) + sizeof(float));
  aid_vote_kernel<<<(unsigned)S, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(aids), static_cast<const float*>(w), static_cast<float*>(agg),
      static_cast<int*>(first), static_cast<int*>(firstpos), L, Lp);
  return (int)cudaGetLastError();
}

}  // extern "C"
