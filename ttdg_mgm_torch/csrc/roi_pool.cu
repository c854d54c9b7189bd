// Multi-level FPN ROIAlign (d2 aligned=True, adaptive grid) for Hopper.
//
// Replaces the TPU kernel `_pool_kernel` of
// ttdg_mgm_tpu/ops/pallas/roi_pool_pallas.py (reached through
// `multilevel_roi_align_windowed`).  That kernel DMAs a 32x40xC window of a
// row-concatenated level atlas per ROI and contracts it on the MXU, a design
// that answers the TPU gather unit's per-row transaction cost.  Hopper has no
// such limit: a warp reads C contiguous floats of one bilinear corner in
// coalesced transactions.  So this kernel computes the semantics of record,
// ttdg_mgm_tpu/ops/roi_align.py:multilevel_roi_align, directly, and is exact
// for every ROI (no window, no misfit budget).
//
// What bounds it on the H100: bytes.  Per ROI it reads at most
// P*P*m*m*4 corners of C floats (most from L2, neighbouring samples share
// corners) and writes P*P*C floats; the arithmetic is 8 flops per corner and
// channel, far below the card's float32 rate.  What the design does about it:
//
// * nothing runs before the launch: the ROI's level, sample positions and
//   weights are computed in the kernel from the ROI's four floats
//   (roi_geometry.cuh), once per block into shared memory;
// * every access is 16 bytes wide: a group of C/4 threads covers the
//   channels of one bin with float4 loads and one float4 store;
// * a block of 256 threads holds 256 / (C/4) such groups, which take
//   different bins of the same ROI, and a small pool (few ROIs) is split over
//   several blocks per ROI, so the card stays full;
// * the per-sample tests are hoisted out of the inner loop, and fewer bytes
//   are read: each axis and bin gets a list of the distinct pixels its live
//   samples touch, each with its summed weight (neighbouring samples share
//   corners, so a bin reads about half of four corners per sample), and the
//   inner loop takes two rows by four columns at a time, so a thread has 8
//   independent 16-byte loads in flight;
// * the output is written with streaming stores (__stcs), so its hundreds of
//   megabytes do not evict the feature levels from L2, where neighbouring
//   ROIs re-read them.

#include "roi_geometry.cuh"

namespace {

using ttdg::AxisSample;
using Levels = ttdg::LevelTable<const float>;

constexpr int kThreads = 256;

// One pixel row (y axis, offset c * W * C) or column (x axis, offset c * C)
// that a bin reads, with the summed weight of the bin's samples on it.
struct Tap {
  int off;
  float w;
};

constexpr int kMaxTaps = 2 * ttdg::kMaxSamples;  // two corners per sample slot

__device__ __forceinline__ void add_tap(Tap* taps, int* cnt, int off, float w) {
  if (w == 0.0f) return;
  for (int k = 0; k < *cnt; ++k) {
    if (taps[k].off == off) {
      taps[k].w += w;
      return;
    }
  }
  taps[*cnt].off = off;
  taps[*cnt].w = w;
  ++*cnt;
}

// A 16-byte read-only load that is made only when `on`.
__device__ __forceinline__ float4 ldg4_if(bool on, const float* p) {
  return on ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void fma_tap(float4* acc, const float4 v, float w) {
  acc->x = fmaf(v.x, w, acc->x);
  acc->y = fmaf(v.y, w, acc->y);
  acc->z = fmaf(v.z, w, acc->z);
  acc->w = fmaf(v.w, w, acc->w);
}

__global__ void __launch_bounds__(kThreads)
roi_pool_kernel(Levels lv, ttdg::PoolSpec sp, int C, int K, const float* __restrict__ rois,
                int bins_per_block, float* __restrict__ out) {
  __shared__ AxisSample sy[ttdg::kMaxSamples];
  __shared__ AxisSample sx[ttdg::kMaxSamples];
  __shared__ Tap ty[kMaxTaps];
  __shared__ Tap tx[kMaxTaps];
  __shared__ int ny[ttdg::kMaxSamples];
  __shared__ int nx[ttdg::kMaxSamples];

  const int r = blockIdx.x;
  const ttdg::RoiFrame fr = ttdg::roi_frame(rois + static_cast<size_t>(r) * 4, sp);
  const int b = r / K;
  const int H = lv.H[fr.level];
  const int W = lv.W[fr.level];
  const int P = sp.P;
  const int m = sp.m;
  const float* f = lv.ptr[fr.level] + static_cast<size_t>(b) * H * W * C;

  ttdg::fill_axis_samples(sy, sx, fr, sp, H, W);
  __syncthreads();
  // Per bin and axis, the distinct pixels its live samples touch, each with
  // its summed weight (bin weight times bilinear weight): a bin's value is
  // sum_y sum_x wy * wx * f[y][x], and neighbouring samples share pixels, so
  // this reads about half of what four corners per sample would.
  for (int t = threadIdx.x; t < 2 * P; t += blockDim.x) {
    const bool is_y = t < P;
    const int p = is_y ? t : t - P;
    const AxisSample* src = (is_y ? sy : sx) + p * m;
    Tap* dst = (is_y ? ty : tx) + p * 2 * m;
    const int scale = is_y ? W * C : C;
    int cnt = 0;
    for (int i = 0; i < m; ++i) {
      const AxisSample a = src[i];
      if (a.w == 0.0f) continue;
      add_tap(dst, &cnt, a.c0 * scale, a.w * (1.0f - a.frac));
      add_tap(dst, &cnt, a.c1 * scale, a.w * a.frac);
    }
    (is_y ? ny : nx)[p] = cnt;
  }
  __syncthreads();

  const int lanes = C / 4;                 // threads per bin
  const int groups = blockDim.x / lanes;   // bins in flight per block
  const int group = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  if (group >= groups) return;
  const int bin_lo = blockIdx.y * bins_per_block;
  const int bin_hi = min(bin_lo + bins_per_block, P * P);
  const float* fc = f + lane * 4;
  float* o = out + static_cast<size_t>(r) * P * P * C + lane * 4;

  for (int bin = bin_lo + group; bin < bin_hi; bin += groups) {
    const int p = bin / P;
    const int q = bin % P;
    const int cy = ny[p];
    const int cx = nx[q];
    const Tap* ys = ty + p * 2 * m;
    const Tap* xs = tx + q * 2 * m;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // two rows by four columns at a time: 8 independent 16-byte loads
    for (int i = 0; i < cy; i += 2) {
      const Tap ya = ys[i];
      const bool two = i + 1 < cy;
      const Tap yb = two ? ys[i + 1] : ya;
      const float* ra = fc + ya.off;
      const float* rb = fc + yb.off;
      for (int j = 0; j < cx; j += 4) {
        const int n = min(cx - j, 4);
        const Tap x0 = xs[j];
        const Tap x1 = n > 1 ? xs[j + 1] : x0;
        const Tap x2 = n > 2 ? xs[j + 2] : x0;
        const Tap x3 = n > 3 ? xs[j + 3] : x0;
        const float4 a0 = ldg4_if(true, ra + x0.off);
        const float4 a1 = ldg4_if(n > 1, ra + x1.off);
        const float4 a2 = ldg4_if(n > 2, ra + x2.off);
        const float4 a3 = ldg4_if(n > 3, ra + x3.off);
        const float4 b0 = ldg4_if(two, rb + x0.off);
        const float4 b1 = ldg4_if(two && n > 1, rb + x1.off);
        const float4 b2 = ldg4_if(two && n > 2, rb + x2.off);
        const float4 b3 = ldg4_if(two && n > 3, rb + x3.off);
        fma_tap(&acc, a0, ya.w * x0.w);
        if (n > 1) fma_tap(&acc, a1, ya.w * x1.w);
        if (n > 2) fma_tap(&acc, a2, ya.w * x2.w);
        if (n > 3) fma_tap(&acc, a3, ya.w * x3.w);
        if (two) {
          fma_tap(&acc, b0, yb.w * x0.w);
          if (n > 1) fma_tap(&acc, b1, yb.w * x1.w);
          if (n > 2) fma_tap(&acc, b2, yb.w * x2.w);
          if (n > 3) fma_tap(&acc, b3, yb.w * x3.w);
        }
      }
    }
    __stcs(reinterpret_cast<float4*>(o + static_cast<size_t>(bin) * C), acc);
  }
}

// The device geometry alone, for checks against ops/roi_align.py:roi_geometry:
// level (R,), ys, wy, xs, wx (R, P*m) as that function returns them.
__global__ void roi_geometry_kernel(ttdg::PoolSpec sp, int R, const float* __restrict__ rois,
                                    int* __restrict__ level, float* __restrict__ ys,
                                    float* __restrict__ wy, float* __restrict__ xs,
                                    float* __restrict__ wx) {
  const int r = blockIdx.x;
  if (r >= R) return;
  const ttdg::RoiFrame fr = ttdg::roi_frame(rois + static_cast<size_t>(r) * 4, sp);
  const int S = sp.P * sp.m;
  if (threadIdx.x == 0) level[r] = fr.level;
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    float pos, wgt;
    ttdg::axis_position(fr.y0, fr.bin_h, t, sp, &pos, &wgt);
    ys[static_cast<size_t>(r) * S + t] = pos;
    wy[static_cast<size_t>(r) * S + t] = wgt;
    ttdg::axis_position(fr.x0, fr.bin_w, t, sp, &pos, &wgt);
    xs[static_cast<size_t>(r) * S + t] = pos;
    wx[static_cast<size_t>(r) * S + t] = wgt;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream` and
// returns cudaGetLastError(); the caller raises when it is not 0.
//
// ttdg_roi_pool: `rois` is (R, 4) float32, R = B * K; `n` is the sampling
// ratio (0 = adaptive).  C must be a multiple of 4, at most 1024, and the
// level pointers 16-byte aligned.
extern "C" int ttdg_roi_pool(const void* f0, const void* f1, const void* f2, const void* f3,
                             int num_levels, int H0, int W0, int H1, int W1, int H2, int W2,
                             int H3, int W3, int C, int R, int K, const void* rois, float s0,
                             float s1, float s2, float s3, int min_level, int P, int n,
                             void* out, void* stream) {
  ttdg::PoolSpec sp;
  if (!ttdg::make_pool_spec(&sp, num_levels, s0, s1, s2, s3, min_level, P, n) || R <= 0 ||
      C < 4 || C % 4 != 0 || C / 4 > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Levels lv = ttdg::make_level_table(
      static_cast<const float*>(f0), static_cast<const float*>(f1),
      static_cast<const float*>(f2), static_cast<const float*>(f3), H0, W0, H1, W1, H2, W2, H3, W3);
  // a small pool is split over several blocks per ROI (about 2048 blocks in
  // all), each taking a whole number of rounds of its bin groups
  const int groups = kThreads / (C / 4);
  const int bins = P * P;
  int splits = (2048 + R - 1) / R;
  const int max_splits = (bins + groups - 1) / groups;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  int per_block = (bins + splits - 1) / splits;
  per_block = ((per_block + groups - 1) / groups) * groups;
  splits = (bins + per_block - 1) / per_block;
  roi_pool_kernel<<<dim3(R, splits), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, sp, C, K, static_cast<const float*>(rois), per_block, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ttdg_roi_geometry(int num_levels, float s0, float s1, float s2, float s3,
                                 int min_level, int P, int n, int R, const void* rois,
                                 void* level, void* ys, void* wy, void* xs, void* wx,
                                 void* stream) {
  ttdg::PoolSpec sp;
  if (!ttdg::make_pool_spec(&sp, num_levels, s0, s1, s2, s3, min_level, P, n) || R <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  roi_geometry_kernel<<<R, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      sp, R, static_cast<const float*>(rois), static_cast<int*>(level), static_cast<float*>(ys),
      static_cast<float*>(wy), static_cast<float*>(xs), static_cast<float*>(wx));
  return static_cast<int>(cudaGetLastError());
}
