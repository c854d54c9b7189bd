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
// * every access is 16 bytes wide: a group of C/4 threads (C/8 in bfloat16)
//   covers the channels of one bin with 16-byte loads and one 16-byte store;
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
//
// bfloat16 features (the bf16 compute policy): the TPU kernel casts its
// per-axis interpolation weights ry, cx to the feature dtype, accumulates
// both contractions in float32 and writes its output in the feature dtype.
// This kernel is templated on the element type and does the same: each
// bin's tap weights are summed in float32 (every product and sum rounded,
// as the plain version ops/roi_align.py:multilevel_roi_align_bf16 does) and
// rounded to bfloat16, the products of two such weights and a bfloat16
// sample are exact in float32, the sum runs in float32 and the output is
// rounded once.  A 16-byte load is 8 bfloat16 channels (4 float32), so a bin
// takes C/8 threads and the channel count must be a multiple of 8; the
// feature reads and the output writes are half the float32 bytes.

#include <cuda_bf16.h>

#include "roi_geometry.cuh"

namespace {

using ttdg::AxisSample;

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
      taps[k].w = __fadd_rn(taps[k].w, w);
      return;
    }
  }
  taps[*cnt].off = off;
  taps[*cnt].w = w;
  ++*cnt;
}

// The channels of one 16-byte load, as float32: 4 float32 or 8 bfloat16.
template <typename T>
struct Pack {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));
  float v[N];
};

// A 16-byte read-only load that is made only when `on`.
__device__ __forceinline__ uint4 ldg16_if(bool on, const void* p) {
  return on ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void fma_tap(Pack<float>* acc, const uint4 r, float w) {
  acc->v[0] = fmaf(__uint_as_float(r.x), w, acc->v[0]);
  acc->v[1] = fmaf(__uint_as_float(r.y), w, acc->v[1]);
  acc->v[2] = fmaf(__uint_as_float(r.z), w, acc->v[2]);
  acc->v[3] = fmaf(__uint_as_float(r.w), w, acc->v[3]);
}

__device__ __forceinline__ void fma_tap(Pack<__nv_bfloat16>* acc, const uint4 r, float w) {
  const float4 lo = ttdg::bf16x4(make_uint2(r.x, r.y));
  const float4 hi = ttdg::bf16x4(make_uint2(r.z, r.w));
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) acc->v[k] = fmaf(v[k], w, acc->v[k]);
}

__device__ __forceinline__ uint4 pack16(const Pack<float>& a) {
  return make_uint4(__float_as_uint(a.v[0]), __float_as_uint(a.v[1]), __float_as_uint(a.v[2]),
                    __float_as_uint(a.v[3]));
}

__device__ __forceinline__ uint4 pack16(const Pack<__nv_bfloat16>& a) {
  const uint2 lo = ttdg::pack_bf16x4(make_float4(a.v[0], a.v[1], a.v[2], a.v[3]));
  const uint2 hi = ttdg::pack_bf16x4(make_float4(a.v[4], a.v[5], a.v[6], a.v[7]));
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_pool_kernel(ttdg::LevelTable<const T> lv, ttdg::PoolSpec sp, int C, int K,
                const float* __restrict__ rois, int bins_per_block, T* __restrict__ out) {
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
  const T* f = lv.ptr[fr.level] + static_cast<size_t>(b) * H * W * C;

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
      add_tap(dst, &cnt, a.c0 * scale, __fmul_rn(a.w, __fsub_rn(1.0f, a.frac)));
      add_tap(dst, &cnt, a.c1 * scale, __fmul_rn(a.w, a.frac));
    }
    for (int k = 0; k < cnt; ++k) dst[k].w = ttdg::tap_weight(dst[k].w, T());
    (is_y ? ny : nx)[p] = cnt;
  }
  __syncthreads();

  constexpr int kN = Pack<T>::N;           // channels per thread
  const int lanes = C / kN;                // threads per bin
  const int groups = blockDim.x / lanes;   // bins in flight per block
  const int group = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  if (group >= groups) return;
  const int bin_lo = blockIdx.y * bins_per_block;
  const int bin_hi = min(bin_lo + bins_per_block, P * P);
  const T* fc = f + lane * kN;
  T* o = out + static_cast<size_t>(r) * P * P * C + lane * kN;

  for (int bin = bin_lo + group; bin < bin_hi; bin += groups) {
    const int p = bin / P;
    const int q = bin % P;
    const int cy = ny[p];
    const int cx = nx[q];
    const Tap* ys = ty + p * 2 * m;
    const Tap* xs = tx + q * 2 * m;
    Pack<T> acc;
#pragma unroll
    for (int k = 0; k < kN; ++k) acc.v[k] = 0.0f;
    // two rows by four columns at a time: 8 independent 16-byte loads
    for (int i = 0; i < cy; i += 2) {
      const Tap ya = ys[i];
      const bool two = i + 1 < cy;
      const Tap yb = two ? ys[i + 1] : ya;
      const T* ra = fc + ya.off;
      const T* rb = fc + yb.off;
      for (int j = 0; j < cx; j += 4) {
        const int n = min(cx - j, 4);
        const Tap x0 = xs[j];
        const Tap x1 = n > 1 ? xs[j + 1] : x0;
        const Tap x2 = n > 2 ? xs[j + 2] : x0;
        const Tap x3 = n > 3 ? xs[j + 3] : x0;
        const uint4 a0 = ldg16_if(true, ra + x0.off);
        const uint4 a1 = ldg16_if(n > 1, ra + x1.off);
        const uint4 a2 = ldg16_if(n > 2, ra + x2.off);
        const uint4 a3 = ldg16_if(n > 3, ra + x3.off);
        const uint4 b0 = ldg16_if(two, rb + x0.off);
        const uint4 b1 = ldg16_if(two && n > 1, rb + x1.off);
        const uint4 b2 = ldg16_if(two && n > 2, rb + x2.off);
        const uint4 b3 = ldg16_if(two && n > 3, rb + x3.off);
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
    __stcs(reinterpret_cast<uint4*>(o + static_cast<size_t>(bin) * C), pack16(acc));
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

template <typename T>
int launch_pool(const void* f0, const void* f1, const void* f2, const void* f3, int H0, int W0,
                int H1, int W1, int H2, int W2, int H3, int W3, const ttdg::PoolSpec& sp, int C,
                int R, int K, const void* rois, void* out, cudaStream_t stream) {
  constexpr int kN = Pack<T>::N;
  if (C < kN || C % kN != 0 || C / kN > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const ttdg::LevelTable<const T> lv = ttdg::make_level_table(
      static_cast<const T*>(f0), static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const T*>(f3), H0, W0, H1, W1, H2, W2, H3, W3);
  // a small pool is split over several blocks per ROI (about 2048 blocks in
  // all), each taking a whole number of rounds of its bin groups
  const int groups = kThreads / (C / kN);
  const int P = sp.P;
  const int bins = P * P;
  int splits = (2048 + R - 1) / R;
  const int max_splits = (bins + groups - 1) / groups;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  int per_block = (bins + splits - 1) / splits;
  per_block = ((per_block + groups - 1) / groups) * groups;
  splits = (bins + per_block - 1) / per_block;
  roi_pool_kernel<T><<<dim3(R, splits), kThreads, 0, stream>>>(
      lv, sp, C, K, static_cast<const float*>(rois), per_block, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream` and
// returns cudaGetLastError(); the caller raises when it is not 0.
//
// ttdg_roi_pool: `rois` is (R, 4) float32, R = B * K; `n` is the sampling
// ratio (0 = adaptive); `dtype` 0 for float32 levels and output, 1 for
// bfloat16.  C must fill whole 16-byte loads (a multiple of 4 in float32, of
// 8 in bfloat16), at most 1024, and the level pointers be 16-byte aligned.
extern "C" int ttdg_roi_pool(const void* f0, const void* f1, const void* f2, const void* f3,
                             int num_levels, int H0, int W0, int H1, int W1, int H2, int W2,
                             int H3, int W3, int C, int R, int K, const void* rois, float s0,
                             float s1, float s2, float s3, int min_level, int P, int n, int dtype,
                             void* out, void* stream) {
  ttdg::PoolSpec sp;
  if (!ttdg::make_pool_spec(&sp, num_levels, s0, s1, s2, s3, min_level, P, n) || R <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch_pool<__nv_bfloat16>(f0, f1, f2, f3, H0, W0, H1, W1, H2, W2, H3, W3, sp, C, R,
                                      K, rois, out, st);
  }
  return launch_pool<float>(f0, f1, f2, f3, H0, W0, H1, W1, H2, W2, H3, W3, sp, C, R, K, rois,
                            out, st);
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
