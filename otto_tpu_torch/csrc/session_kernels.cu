// Session kernels for Hopper (sm_90a): the per-session aid vote.  Plain C
// entry point, loaded with ctypes by otto_tpu_torch/ops/_kernels.py.  It
// selects the tensors' device, launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so that a
// refused launch is reported to the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
// Only a row's live prefix is scanned: `hi` = 1 + the last position holding
// an aid >= 0; no slot at or past hi can equal a real aid, so a row costs
// hi^2 compares and not L^2, and positions past hi are written as padding
// without a scan.  On the aid-weight path the mean hi is ~6 of L = 76, so
// what a row costs is mostly its loads, stores and bookkeeping.  Two
// kernels, chosen by L:
// - L <= 128, the paths' rows: aid_vote_rows_kernel<NC>, one warp a row
//   (NC = 1, 2 or 4 chunks of 32 positions), eight warps a block, on a
//   persistent grid.  A lane keeps its positions' aids and weights in
//   registers and loads the next row's into registers before it computes
//   the current one, so the loads are in flight during the compute.  hi
//   comes from one ballot a chunk; only the chunks below hi go to the
//   warp's slice of shared memory, for the scan; stores come from
//   registers, 128 bytes a warp.
// - 128 < L <= 1,024: aid_vote_block_kernel, one block a row and one
//   thread a position (the earlier design), the row in shared memory, hi by
//   a block-wide max.  A warp a row would leave too few warps in flight to
//   hide the scan's dependent adds at these lengths.
// The scan is the same in both: a thread reads 16-byte broadcasts of (aid,
// weight) in ascending j, with one compare, a predicated add and a
// predicated min per (position, j), for up to four of its positions at
// once.  The sum runs in ascending j, the order of the earlier kernel, so the
// result does not depend on the launch.
//
// What bounds it: device-memory bytes, 4 bytes in and 12 out a position
// (12.2 MB + 18.2 MB at [20,000, 76]), on the aid-weight path's rows: there
// the kernel runs at ~81% of that bound from device memory (0.0113 ms on an
// H100 at 700 W).  Rows whose live prefixes are long are bound by the
// scan's compares instead (hi^2 a row).
// ---------------------------------------------------------------------------

constexpr int K3_WARPS = 8;       // rows kernel: warps (rows in flight) a block
constexpr int K3_ROWS_MAX_L = 128;
constexpr int K3_MAX_L = 1024;    // block kernel: one thread a position
constexpr int K3_PAD_AID = -2;    // equals no real aid (>= 0) and no padding (-1)

// Scans j = 0..hp-1 (hp a multiple of 4) for the first NU of this thread's
// G positions ai[].
template <int NU, int G>
__device__ __forceinline__ void vote_scan(const int* sa, const float* sw, int hp,
                                          const int (&ai)[G], float (&acc)[G], int (&fp)[G]) {
  const int4* a4 = reinterpret_cast<const int4*>(sa);
  const float4* w4 = reinterpret_cast<const float4*>(sw);
  for (int q = 0; q < hp / 4; ++q) {
    const int4 a = a4[q];
    const float4 w = w4[q];
    const int av[4] = {a.x, a.y, a.z, a.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        if (av[k] == ai[u]) {
          acc[u] += wv[k];
          fp[u] = min(fp[u], 4 * q + k);
        }
      }
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(K3_WARPS * 32)
aid_vote_rows_kernel(const int* __restrict__ aids, const float* __restrict__ w,
                     float* __restrict__ agg, int* __restrict__ first,
                     int* __restrict__ firstpos, int S, int L) {
  __shared__ int4 k3_rows[K3_WARPS][NC * 32 * 2 / 4];  // per warp: [32 NC] aids, [32 NC] weights
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int* sa = reinterpret_cast<int*>(k3_rows[warp]);
  float* sw = reinterpret_cast<float*>(sa + 32 * NC);
  long long row = (long long)blockIdx.x * K3_WARPS + warp;
  const long long stride = (long long)gridDim.x * K3_WARPS;
  if (row >= S) return;  // whole warps exit together

  int na[NC];
  float nw[NC];
  auto fetch = [&](long long r) {
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const int i = 32 * u + lane;
      na[u] = (i < L) ? aids[r * L + i] : -1;
      nw[u] = (i < L) ? w[r * L + i] : 0.0f;
    }
  };
  fetch(row);
  for (; row < S; row += stride) {
    int a[NC];
    float wv[NC];
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      a[u] = na[u];
      wv[u] = nw[u];
    }
    if (row + stride < S) fetch(row + stride);  // in flight while this row computes

    int hi = 0;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const unsigned m = __ballot_sync(0xffffffffu, a[u] >= 0);
      if (m) hi = 32 * u + 32 - __clz(m);
    }
    __syncwarp();  // every lane is done reading the last row's slice
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      if (32 * u < hi) {
        sa[32 * u + lane] = a[u];
        sw[32 * u + lane] = wv[u];
      }
    }
    __syncwarp();

    float acc[NC];
    int fp[NC];
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      acc[u] = 0.0f;
      fp[u] = L;
    }
    // whole quads: the slots in [hi, hp) lie in written chunks and hold no
    // real aid; positions in chunks at or past hi need no scan
    const int hp = (hi + 3) & ~3;
    switch ((hi + 31) / 32) {
      case 1: vote_scan<1>(sa, sw, hp, a, acc, fp); break;
      case 2: vote_scan<(NC >= 2 ? 2 : NC)>(sa, sw, hp, a, acc, fp); break;
      case 3: vote_scan<(NC >= 3 ? 3 : NC)>(sa, sw, hp, a, acc, fp); break;
      case 4: vote_scan<(NC >= 4 ? 4 : NC)>(sa, sw, hp, a, acc, fp); break;
      default: break;
    }

    float* ao = agg + row * L + lane;
    int* fo = first + row * L + lane;
    int* po = firstpos + row * L + lane;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      if (32 * u + lane < L) {
        const bool valid = a[u] >= 0;  // false at and past hi
        ao[32 * u] = valid ? acc[u] : 0.0f;
        po[32 * u] = valid ? fp[u] : L;
        fo[32 * u] = (valid && fp[u] == 32 * u + lane) ? 1 : 0;
      }
    }
  }
}

__global__ void __launch_bounds__(K3_MAX_L)
aid_vote_block_kernel(const int* __restrict__ aids, const float* __restrict__ w,
                      float* __restrict__ agg, int* __restrict__ first,
                      int* __restrict__ firstpos, int L, int Lp) {
  extern __shared__ int4 k3_row[];  // [Lp] aids, then [Lp] weights
  __shared__ int s_hi;
  int* sa = reinterpret_cast<int*>(k3_row);
  float* sw = reinterpret_cast<float*>(sa + Lp);
  const long long row = blockIdx.x;
  const int i = threadIdx.x;

  if (i == 0) s_hi = 0;
  int ai[1] = {K3_PAD_AID};
  if (i < L) {
    ai[0] = aids[row * L + i];
    sa[i] = ai[0];
    sw[i] = w[row * L + i];
  } else if (i < Lp) {
    sa[i] = K3_PAD_AID;
    sw[i] = 0.0f;
  }
  __syncthreads();
  const int h = __reduce_max_sync(0xffffffffu, (i < L && ai[0] >= 0) ? i + 1 : 0);
  if (i % 32 == 0 && h > 0) atomicMax(&s_hi, h);
  __syncthreads();
  if (i >= L) return;

  float acc[1] = {0.0f};
  int fp[1] = {L};
  if (ai[0] >= 0) vote_scan<1>(sa, sw, (s_hi + 3) & ~3, ai, acc, fp);
  const long long o = row * L + i;
  agg[o] = acc[0];
  firstpos[o] = fp[0];
  first[o] = (ai[0] >= 0 && fp[0] == i) ? 1 : 0;
}

}  // namespace

extern "C" {

// Rows of L <= 128 go to aid_vote_rows_kernel<NC> (NC = L/32 rounded up to
// 1, 2 or 4) on a persistent grid, worked out once per (device, NC);
// longer rows, up to 1,024, to aid_vote_block_kernel.
int aid_vote_f32(const void* aids, const void* w, void* agg, void* first, void* firstpos,
                 int S, int L, int device, void* stream) {
  constexpr int MAX_DEVICES = 64;
  static int resident[MAX_DEVICES][3] = {};  // rows kernel blocks the card holds, by NC
  if (device < 0 || device >= MAX_DEVICES || L < 1 || L > K3_MAX_L || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const int* a = static_cast<const int*>(aids);
  const float* wt = static_cast<const float*>(w);
  float* o_agg = static_cast<float*>(agg);
  int* o_first = static_cast<int*>(first);
  int* o_pos = static_cast<int*>(firstpos);
  if (L > K3_ROWS_MAX_L) {
    const int Lp = (L + 3) / 4 * 4;
    const int threads = (L + 31) / 32 * 32;  // >= Lp
    aid_vote_block_kernel<<<(unsigned)S, threads, (size_t)Lp * 8, st>>>(a, wt, o_agg, o_first,
                                                                       o_pos, L, Lp);
    return (int)cudaGetLastError();
  }
  const int nc = L <= 32 ? 1 : L <= 64 ? 2 : 4;
  const int slot = nc == 4 ? 2 : nc - 1;
  typedef void (*RowsKernel)(const int*, const float*, float*, int*, int*, int, int);
  RowsKernel kernel = aid_vote_rows_kernel<4>;
  if (nc == 2) kernel = aid_vote_rows_kernel<2>;
  if (nc == 1) kernel = aid_vote_rows_kernel<1>;
  if (resident[device][slot] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K3_WARPS * 32, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[device][slot] = sms * per_sm;
  }
  const long long blocks =
      std::min(((long long)S + K3_WARPS - 1) / K3_WARPS, (long long)resident[device][slot]);
  kernel<<<(unsigned)blocks, K3_WARPS * 32, 0, st>>>(a, wt, o_agg, o_first, o_pos, S, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
