// Multi-level FPN ROIAlign (d2 aligned=True, adaptive grid) for Hopper.
//
// Replaces the TPU kernel `_pool_kernel` of
// ttdg_mgm_tpu/ops/pallas/roi_pool_pallas.py (reached through
// `multilevel_roi_align_windowed`).  That kernel DMAs a 32x40xC window of a
// row-concatenated level atlas per ROI and contracts it on the MXU, a design
// that answers the TPU gather unit's per-row transaction cost.  Hopper has no
// such limit: a warp reads C contiguous floats of one bilinear corner in one
// coalesced transaction.  So this kernel computes the semantics of record,
// ttdg_mgm_tpu/ops/roi_align.py:multilevel_roi_align, directly, and is exact
// for every ROI (no window, no misfit budget).
//
// What bounds it on the H100: bytes.  Per ROI it reads at most
// P*P*m*m*4 corners of C floats (most from L2, neighbouring samples share
// corners) and writes P*P*C floats; the arithmetic is 8 flops per corner and
// channel, far below the card's float32 rate.  The design keeps the reads
// coalesced (NHWC levels, threads over channels), computes the sample
// geometry once per ROI into shared memory, skips samples whose weight is 0
// (surplus adaptive slots, out-of-range samples), and writes each bin once.
//
// Layout: one block per ROI; threads run over channels.  The sample
// positions and per-sample weights come from the same PyTorch code as the
// plain version (ops/roi_align.py:roi_geometry), so the two agree up to the
// order of the sums.

#include "roi_geometry.cuh"

namespace {

using ttdg::AxisSample;
using Levels = ttdg::LevelTable<const float>;

__global__ void roi_pool_kernel(Levels lv, int C, int K, const int* __restrict__ level,
                                const float* __restrict__ ys, const float* __restrict__ wy,
                                const float* __restrict__ xs, const float* __restrict__ wx,
                                int P, int m, float* __restrict__ out) {
  __shared__ AxisSample sy[ttdg::kMaxSamples];
  __shared__ AxisSample sx[ttdg::kMaxSamples];
  const int r = blockIdx.x;
  const int l = level[r];
  const int b = r / K;
  const int H = lv.H[l];
  const int W = lv.W[l];
  const int S = P * m;
  const float* f = lv.ptr[l] + static_cast<size_t>(b) * H * W * C;

  ttdg::load_axis_samples(sy, sx, r, S, ys, wy, xs, wx, H, W);
  __syncthreads();

  float* o = out + static_cast<size_t>(r) * P * P * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int p = 0; p < P; ++p) {
      for (int q = 0; q < P; ++q) {
        float acc = 0.0f;
        for (int i = 0; i < m; ++i) {
          const AxisSample a = sy[p * m + i];
          if (a.w == 0.0f) continue;
          const float ly = a.frac;
          const float* row0 = f + static_cast<size_t>(a.c0) * W * C;
          const float* row1 = f + static_cast<size_t>(a.c1) * W * C;
          for (int j = 0; j < m; ++j) {
            const AxisSample e = sx[q * m + j];
            if (e.w == 0.0f) continue;
            const float lx = e.frac;
            const float v = __ldg(row0 + static_cast<size_t>(e.c0) * C + c) * ((1.0f - ly) * (1.0f - lx))
                          + __ldg(row0 + static_cast<size_t>(e.c1) * C + c) * ((1.0f - ly) * lx)
                          + __ldg(row1 + static_cast<size_t>(e.c0) * C + c) * (ly * (1.0f - lx))
                          + __ldg(row1 + static_cast<size_t>(e.c1) * C + c) * (ly * lx);
            acc += v * (a.w * e.w);
          }
        }
        o[(static_cast<size_t>(p) * P + q) * C + c] = acc;
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` and returns
// cudaGetLastError(); the caller raises when it is not 0.
extern "C" int ttdg_roi_pool(const void* f0, const void* f1, const void* f2, const void* f3,
                             int num_levels, int H0, int W0, int H1, int W1, int H2, int W2,
                             int H3, int W3, int C, int R, int K, const void* level,
                             const void* ys, const void* wy, const void* xs, const void* wx,
                             int P, int m, void* out, void* stream) {
  if (num_levels < 1 || num_levels > ttdg::kMaxLevels || P * m > ttdg::kMaxSamples || R <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Levels lv = ttdg::make_level_table(
      static_cast<const float*>(f0), static_cast<const float*>(f1),
      static_cast<const float*>(f2), static_cast<const float*>(f3), H0, W0, H1, W1, H2, W2, H3, W3);
  const int threads = ttdg::channel_threads(C);
  roi_pool_kernel<<<R, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, C, K, static_cast<const int*>(level), static_cast<const float*>(ys),
      static_cast<const float*>(wy), static_cast<const float*>(xs),
      static_cast<const float*>(wx), P, m, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
