// Backward of the multi-level FPN ROIAlign (roi_pool.cu) for Hopper: the
// feature gradient of the training pools.
//
// Replaces the TPU kernel `_scatter_kernel` of
// ttdg_mgm_tpu/ops/pallas/roi_pool_pallas.py (the custom VJP
// `_pool_from_atlas_bwd` of `multilevel_roi_align_windowed_train`).  That
// kernel read-modify-writes a 32x40xC window of the level atlas per ROI, one
// ROI after another, because TPU grid steps run in order and windows of
// different ROIs overlap.  Hopper blocks run in parallel and in no order, so
// overlapping ROIs meet in device memory: each sample's four bilinear corners
// are added with float32 atomics (`red.global.add.f32`) into a zeroed gradient
// of the ROI's level.  Like roi_pool.cu, it computes the semantics of record,
// the gradient of ttdg_mgm_tpu/ops/roi_align.py:multilevel_roi_align, for
// every ROI (no window, no misfit budget):
//
//   d feat[l][b, y, x, c] += sum over samples of  w_y * w_x * bilinear * g[r, p, q, c]
//
// The atomics make the sum's order, and so its last bits, change from run to
// run.
//
// What bounds it on the H100: bytes and atomic throughput.  Reads g once
// (P*P*C floats per ROI), and per valid sample issues 4 atomic adds of C
// floats into the rows its corners touch; neighbouring threads add to
// neighbouring channels of one row, so each warp's 32 atomics land in one
// 128-byte line.  Training ROIs cluster around the few ground-truth boxes, so
// many blocks add to the same rows and contend in L2; a gather-ordered or
// shared-memory design is later work.
//
// Layout: one block per ROI; threads run over channels.  The sample geometry
// is computed in the kernel from the ROI's four floats by the code the
// forward kernel uses (roi_geometry.cuh), so this is the exact gradient of
// roi_pool.cu, and nothing runs before the launch.

#include "roi_geometry.cuh"

namespace {

using ttdg::AxisSample;
using Grads = ttdg::LevelTable<float>;

__global__ void roi_pool_backward_kernel(Grads lv, ttdg::PoolSpec sp, int C, int K,
                                         const float* __restrict__ rois,
                                         const float* __restrict__ g) {
  __shared__ AxisSample sy[ttdg::kMaxSamples];
  __shared__ AxisSample sx[ttdg::kMaxSamples];
  const int r = blockIdx.x;
  const ttdg::RoiFrame fr = ttdg::roi_frame(rois + static_cast<size_t>(r) * 4, sp);
  const int b = r / K;
  const int H = lv.H[fr.level];
  const int W = lv.W[fr.level];
  const int P = sp.P;
  const int m = sp.m;
  float* f = lv.ptr[fr.level] + static_cast<size_t>(b) * H * W * C;

  ttdg::fill_axis_samples(sy, sx, fr, sp, H, W);
  __syncthreads();

  const float* gr = g + static_cast<size_t>(r) * P * P * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int p = 0; p < P; ++p) {
      for (int q = 0; q < P; ++q) {
        const float gv = __ldg(gr + (static_cast<size_t>(p) * P + q) * C + c);
        if (gv == 0.0f) continue;
        for (int i = 0; i < m; ++i) {
          const AxisSample a = sy[p * m + i];
          if (a.w == 0.0f) continue;
          const float ly = a.frac;
          float* row0 = f + static_cast<size_t>(a.c0) * W * C;
          float* row1 = f + static_cast<size_t>(a.c1) * W * C;
          for (int j = 0; j < m; ++j) {
            const AxisSample e = sx[q * m + j];
            if (e.w == 0.0f) continue;
            const float lx = e.frac;
            const float t = gv * (a.w * e.w);
            atomicAdd(row0 + static_cast<size_t>(e.c0) * C + c, t * ((1.0f - ly) * (1.0f - lx)));
            atomicAdd(row0 + static_cast<size_t>(e.c1) * C + c, t * ((1.0f - ly) * lx));
            atomicAdd(row1 + static_cast<size_t>(e.c0) * C + c, t * (ly * (1.0f - lx)));
            atomicAdd(row1 + static_cast<size_t>(e.c1) * C + c, t * (ly * lx));
          }
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes), with ttdg_roi_pool's arguments.
// `d0..d3` are the level gradients, zeroed by the caller; the kernel adds
// into them.  Launches on `stream` and returns cudaGetLastError(); the caller
// raises when it is not 0.
extern "C" int ttdg_roi_pool_backward(void* d0, void* d1, void* d2, void* d3, int num_levels,
                                      int H0, int W0, int H1, int W1, int H2, int W2, int H3,
                                      int W3, int C, int R, int K, const void* rois, float s0,
                                      float s1, float s2, float s3, int min_level, int P, int n,
                                      const void* g, void* stream) {
  ttdg::PoolSpec sp;
  if (!ttdg::make_pool_spec(&sp, num_levels, s0, s1, s2, s3, min_level, P, n) || R <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grads lv = ttdg::make_level_table(
      static_cast<float*>(d0), static_cast<float*>(d1), static_cast<float*>(d2),
      static_cast<float*>(d3), H0, W0, H1, W1, H2, W2, H3, W3);
  const int threads = ttdg::channel_threads(C);
  roi_pool_backward_kernel<<<R, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, sp, C, K, static_cast<const float*>(rois), static_cast<const float*>(g));
  return static_cast<int>(cudaGetLastError());
}
