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
// (16 matrices of 60 x 60): it is a chain of 2 * max_iter dependent
// reductions, so its time is latency.  The design keeps each matrix in
// shared memory for the whole solve (one block per matrix, 60 x 60 floats =
// 14.4 KB), one warp per row or column with shuffle reductions, one barrier
// per sweep, and reads and writes device memory once.  `tau` is read from
// device memory, so a caller whose temperature is a device value (HiPPI's
// overflow-guarded `sk_tau / c`) does not synchronise with the host.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kDummy = -100.0f;
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Normalise `count` slices of `len` entries: entry k of slice s lives at
// x[s * s_stride + k * k_stride].  One warp per slice.
__device__ void normalise(float* x, int count, int len, int s_stride, int k_stride, int nc,
                          int rows_live, bool by_rows) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int s = threadIdx.x >> 5; s < count; s += warps) {
    float m = -INFINITY;
    for (int k = lane; k < len; k += 32) m = fmaxf(m, x[s * s_stride + k * k_stride]);
    m = warp_max(m);
    const bool live_slice = m > kNegInf / 2;
    const float m_safe = live_slice ? m : 0.0f;
    float acc = 0.0f;
    for (int k = lane; k < len; k += 32) acc += expf(x[s * s_stride + k * k_stride] - m_safe);
    acc = warp_sum(acc);
    const float lse = live_slice ? m_safe + logf(fmaxf(acc, 1e-38f)) : kNegInf;
    for (int k = lane; k < len; k += 32) {
      const int i = by_rows ? s : k;
      const int j = by_rows ? k : s;
      const bool live = (i < rows_live) && (j < nc);
      float* e = x + s * s_stride + k * k_stride;
      *e = live ? *e - lse : kNegInf;
    }
  }
}

__global__ void sinkhorn_kernel(const float* __restrict__ s, const int* __restrict__ nrows,
                                const int* __restrict__ ncols, const float* __restrict__ tau,
                                int n1, int n2, int max_iter, int dummy_row,
                                float* __restrict__ out) {
  extern __shared__ float x[];
  const int b = blockIdx.x;
  const int nr = nrows[b];
  const int nc = ncols[b];
  const float t = *tau;
  const int rows_live = dummy_row ? max(nr, nc) : nr;
  const size_t base = static_cast<size_t>(b) * n1 * n2;
  for (int idx = threadIdx.x; idx < n1 * n2; idx += blockDim.x) {
    const int i = idx / n2;
    const int j = idx % n2;
    const bool real = (i < nr) && (j < nc);
    const bool live = (i < rows_live) && (j < nc);
    float v = real ? s[base + idx] / t : kNegInf;
    if (dummy_row && !real && i >= nr && i < nc && j < nc) v = kDummy;
    x[idx] = live ? v : kNegInf;
  }
  __syncthreads();
  for (int it = 0; it < max_iter; ++it) {
    if (it % 2 == 0) {
      normalise(x, n1, n2, n2, 1, nc, rows_live, true);
    } else {
      normalise(x, n2, n1, 1, n2, nc, rows_live, false);
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < n1 * n2; idx += blockDim.x) {
    const int i = idx / n2;
    const int j = idx % n2;
    out[base + idx] = ((i < nr) && (j < nc)) ? expf(x[idx]) : 0.0f;
  }
}

}  // namespace

// Shared memory one matrix needs, in bytes.
extern "C" int ttdg_sinkhorn_smem_bytes(int n1, int n2) {
  return n1 * n2 * static_cast<int>(sizeof(float));
}

// Plain C entry point (bound with ctypes).  s and out (N, n1, n2) float32,
// nrows and ncols (N,) int32, tau one float32, all on the device.  Launches on
// `stream` and returns cudaGetLastError(); the caller raises when it is not 0.
extern "C" int ttdg_sinkhorn(const void* s, const void* nrows, const void* ncols,
                             const void* tau, int N, int n1, int n2, int max_iter,
                             int dummy_row, void* out, void* stream) {
  if (N <= 0 || n1 <= 0 || n2 <= 0 || max_iter < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = ttdg_sinkhorn_smem_bytes(n1, n2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sinkhorn_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const int*>(nrows),
      static_cast<const int*>(ncols), static_cast<const float*>(tau), n1, n2, max_iter,
      dummy_row, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
