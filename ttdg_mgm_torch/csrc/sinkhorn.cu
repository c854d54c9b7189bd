// Batched log-domain Sinkhorn for Hopper.
//
// Replaces the TPU kernel `_kernel` of
// ttdg_mgm_tpu/ops/pallas/sinkhorn_pallas.py (`sinkhorn_pallas`), the drop-in
// for ops/sinkhorn.py:sinkhorn on (N, n1, n2) batches, and computes the same
// function: log_s = s / tau, optional dummy rows at log value -100,
// `max_iter` alternating masked row / column logsumexp normalisations (rows
// first), exact zeros outside the valid region.  The masked logsumexp is that
// of ops/sinkhorn.py:_masked_logsumexp: NEG_INF = -1e30 stands in for -inf,
// an all-masked slice gives NEG_INF, and the sum of exponentials is clamped
// at 1e-38 before its log.
//
// What bounds it on the H100: neither bytes nor operations at HiPPI's size
// (16 matrices of 60 x 60): it is a chain of `max_iter` dependent
// normalisations, each a max, an exp per entry, a sum and a log, so its time
// is the latency of that chain, and next the special-function unit's
// throughput (one exp per live entry and sweep, 16 per clock per SM).
//
// What the design does about it:
//
// * every slice of a sweep runs at once: one block of 512 threads per matrix
//   gives each slice (row or column) a group of 8 lanes, 64 slices at a time;
//   a lane holds 8 of the slice's entries in registers, so a normalisation's
//   two butterflies take 3 shuffle stages each (not 5), and the lane's exps
//   are independent;
// * only the live region is touched: the slices and entries outside it are
//   NEG_INF after the first write and stay so, and the exps of entries that
//   are masked anyway are not taken;
// * the matrix stays in shared memory for the whole solve, with a row stride
//   of 65 floats and an entry order (4 consecutive entries per lane, lanes 4
//   apart) that make both the row and the column sweeps free of bank
//   conflicts; one barrier per sweep; device memory is read and written once.
//
// That path is specialised at compile time for n1, n2 <= 64 (HiPPI's shape).
// Every larger matrix that fits in one block's shared memory takes the same
// code with the entries kept in shared memory instead of registers (three
// passes per slice), and a slice group walks its slices in rounds.  `tau` is
// read from device memory, so a caller whose temperature is a device value
// (HiPPI's overflow-guarded `sk_tau / c`) does not synchronise with the host.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kDummy = -100.0f;
constexpr int kThreads = 512;
constexpr int kGroup = 8;                         // lanes per slice
constexpr int kSlices = kThreads / kGroup;        // slices at a time: 64
constexpr int kRegs = 8;                          // entries per lane, small path
constexpr int kSmallN = kGroup * kRegs;           // 64
constexpr int kSmallLd = kSmallN + 1;             // row stride, small path
constexpr unsigned kFull = 0xffffffffu;

// The t-th entry a lane holds: runs of 4 consecutive entries, lanes 4 apart,
// every 32 entries.  With a row stride of 1 mod 32, the 4 slices of a warp
// then hit 32 distinct banks in a row sweep and in a column sweep.
__device__ __forceinline__ int entry(int lane, int t) {
  return ((t >> 2) << 5) + (lane << 2) + (t & 3);
}

__device__ __forceinline__ float group_max(float v) {
  for (int o = kGroup / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
  for (int o = kGroup / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The masked logsumexp of a slice from its lanes' max and sum of exps.
__device__ __forceinline__ float slice_lse(float m, float acc) {
  return m > kNegInf / 2 ? m + logf(fmaxf(acc, 1e-38f)) : kNegInf;
}

// Subtract from each of the first `count` slices its logsumexp over its
// first `len` entries (the live ones; the rest are NEG_INF and stay so):
// entry k of slice s lives at x[s * s_stride + k * k_stride].  kSmall: len
// <= 64, entries in registers.  Loops are warp-uniform, so the shuffles see
// every lane.
template <bool kSmall>
__device__ void normalise(float* x, int count, int len, int s_stride, int k_stride) {
  const int lane = threadIdx.x % kGroup;
  const int warp_first = (threadIdx.x / 32) * (32 / kGroup);
  const int runs = (len + 31) / 32;  // entries a lane holds: up to 4 per run
  for (int s0 = warp_first; s0 < count; s0 += kSlices) {
    const int s = s0 + (threadIdx.x % 32) / kGroup;
    const bool on = s < count;
    float* v = x + s * s_stride;
    if (kSmall) {
      float e[kRegs];
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < kRegs; ++t) {
        const int k = entry(lane, t);
        e[t] = (on && k < len) ? v[k * k_stride] : -INFINITY;
        m = fmaxf(m, e[t]);
      }
      m = group_max(m);
      const float ms = m > kNegInf / 2 ? m : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < kRegs; ++t) {
        if (entry(lane, t) < len) acc += expf(e[t] - ms);
      }
      const float lse = slice_lse(m, group_sum(acc));
#pragma unroll
      for (int t = 0; t < kRegs; ++t) {
        const int k = entry(lane, t);
        if (on && k < len) v[k * k_stride] = e[t] - lse;
      }
    } else {
      float m = -INFINITY;
      for (int t = 0; t < 4 * runs; ++t) {
        const int k = entry(lane, t);
        if (on && k < len) m = fmaxf(m, v[k * k_stride]);
      }
      m = group_max(m);
      const float ms = m > kNegInf / 2 ? m : 0.0f;
      float acc = 0.0f;
      for (int t = 0; t < 4 * runs; ++t) {
        const int k = entry(lane, t);
        if (on && k < len) acc += expf(v[k * k_stride] - ms);
      }
      const float lse = slice_lse(m, group_sum(acc));
      for (int t = 0; t < 4 * runs; ++t) {
        const int k = entry(lane, t);
        if (on && k < len) v[k * k_stride] -= lse;
      }
    }
  }
}

template <bool kSmall>
__global__ void __launch_bounds__(kThreads)
sinkhorn_kernel(const float* __restrict__ s, const int* __restrict__ nrows,
                const int* __restrict__ ncols, const float* __restrict__ tau, int n1, int n2,
                int max_iter, int dummy_row, float* __restrict__ out) {
  extern __shared__ float x[];
  const int ld = kSmall ? kSmallLd : n2;
  const int b = blockIdx.x;
  const int nr = nrows[b];
  const int nc = ncols[b];
  const float t = *tau;
  // the live rows and columns, as loop bounds
  const int rows_live = min(max(dummy_row ? max(nr, nc) : nr, 0), n1);
  const int cols_live = min(max(nc, 0), n2);
  const size_t base = static_cast<size_t>(b) * n1 * n2;
  for (int idx = threadIdx.x; idx < n1 * n2; idx += blockDim.x) {
    const int i = idx / n2;
    const int j = idx % n2;
    const bool real = (i < nr) && (j < nc);
    const bool live = (i < rows_live) && (j < cols_live);
    float v = real ? s[base + idx] / t : kNegInf;
    if (dummy_row && !real && i >= nr && i < nc && j < nc) v = kDummy;
    x[i * ld + j] = live ? v : kNegInf;
  }
  __syncthreads();
  for (int it = 0; it < max_iter; ++it) {
    if (it % 2 == 0) {
      normalise<kSmall>(x, rows_live, cols_live, ld, 1);
    } else {
      normalise<kSmall>(x, cols_live, rows_live, 1, ld);
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < n1 * n2; idx += blockDim.x) {
    const int i = idx / n2;
    const int j = idx % n2;
    out[base + idx] = ((i < nr) && (j < nc)) ? expf(x[i * ld + j]) : 0.0f;
  }
}

bool small_shape(int n1, int n2) { return n1 <= kSmallN && n2 <= kSmallN; }

}  // namespace

// Shared memory one matrix needs, in bytes.
extern "C" int ttdg_sinkhorn_smem_bytes(int n1, int n2) {
  const int ld = small_shape(n1, n2) ? kSmallLd : n2;
  return n1 * ld * static_cast<int>(sizeof(float));
}

// Plain C entry point (bound with ctypes).  s and out (N, n1, n2) float32,
// nrows and ncols (N,) int32, tau one float32, all on the device.  Launches on
// `stream` and returns cudaGetLastError(); the caller raises when it is not 0.
// `generic` != 0 takes the shared-memory path for a small shape too (for
// checks of that path).
extern "C" int ttdg_sinkhorn(const void* s, const void* nrows, const void* ncols,
                             const void* tau, int N, int n1, int n2, int max_iter,
                             int dummy_row, int generic, void* out, void* stream) {
  if (N <= 0 || n1 <= 0 || n2 <= 0 || max_iter < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool small = small_shape(n1, n2) && !generic;
  const int smem = small ? ttdg_sinkhorn_smem_bytes(n1, n2)
                         : n1 * n2 * static_cast<int>(sizeof(float));
  auto kernel = small ? sinkhorn_kernel<true> : sinkhorn_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const int*>(nrows),
      static_cast<const int*>(ncols), static_cast<const float*>(tau), n1, n2, max_iter,
      dummy_row, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
