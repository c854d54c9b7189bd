// Per-ROI sample geometry shared by the ROI pool (roi_pool.cu) and its
// backward (roi_pool_backward.cu): the level table, the ROI's FPN level and
// its sample positions and weights along each axis, computed on the device
// from the ROI's four floats.
//
// The arithmetic reproduces ops/roi_align.py:roi_geometry (assign_fpn_levels,
// _axis_samples) operation by operation, as PyTorch evaluates it on CUDA
// tensors, so that kernel and plain version pick the same level and the same
// sample count (`ceil(bin)` decides it) and place the samples on the same
// floats.  Every product, sum and quotient is pinned with a round-to-nearest
// intrinsic: nvcc would contract `a * b - 0.5f` into one FMA, PyTorch rounds
// after each operation.  A division by a Python scalar (`/ P`, `/ 224.0`,
// `/ m`) is a multiplication by the scalar's float32 reciprocal there, and so
// it is here; a division by a tensor (`/ nd`) is a true division.
//
// One axis sample's clamped bilinear corners follow
// ops/roi_align.py:_bilinear_corners.
//
// Also shared by both: the tap weight as the bfloat16 variants multiply it,
// and the unpacking and packing of four bfloat16 channels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ttdg {

constexpr int kMaxLevels = 4;
constexpr int kMaxSamples = 64;  // P * m per axis: 14 * 4 = 56 at most
constexpr int kAdaptiveCap = 4;  // ops/roi_align.py:ADAPTIVE_CAP

template <typename T>
struct LevelTable {
  T* ptr[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
};

// What the level assignment and the sample grid depend on besides the ROI.
struct PoolSpec {
  float inv_stride[kMaxLevels];  // 1 / stride of each level
  int num_levels;
  int min_level;                 // FPN number of level 0 (2 for p2)
  int P;                         // output bins per axis
  int n;                         // sampling ratio; 0 = adaptive grid
  int m;                         // sample slots per bin and axis
  float inv_P;                   // float32 1 / P
  float inv_m;                   // float32 1 / m
  float w_fixed;                 // float32 of the double 1 / m: fixed-grid weight
};

struct AxisSample {
  int c0, c1;     // clamped corner indices
  float frac;     // interpolation weight of c1
  float w;        // bin-average weight, 0 when out of range or surplus
};

struct RoiFrame {
  int level;
  float x0, y0;        // ROI start in level pixels, shifted by half a pixel
  float bin_w, bin_h;
};

// assign_fpn_levels (canonical size 224, canonical level 4) and the ROI's
// frame in its level's pixel grid.
__device__ __forceinline__ RoiFrame roi_frame(const float* __restrict__ roi, const PoolSpec& sp) {
  const float rx0 = roi[0], ry0 = roi[1], rx1 = roi[2], ry1 = roi[3];
  const float w = fmaxf(__fsub_rn(rx1, rx0), 0.0f);
  const float h = fmaxf(__fsub_rn(ry1, ry0), 0.0f);
  const float area = __fmul_rn(w, h);
  const float rel = __fadd_rn(__fmul_rn(__fsqrt_rn(area), 1.0f / 224.0f), 1e-8f);
  float lvl = floorf(__fadd_rn(4.0f, log2f(rel)));
  const float lo = static_cast<float>(sp.min_level);
  const float hi = static_cast<float>(sp.min_level + sp.num_levels - 1);
  lvl = fminf(fmaxf(lvl, lo), hi);
  RoiFrame f;
  f.level = static_cast<int>(lvl) - sp.min_level;
  const float s = sp.inv_stride[f.level];
  f.x0 = __fsub_rn(__fmul_rn(rx0, s), 0.5f);
  f.y0 = __fsub_rn(__fmul_rn(ry0, s), 0.5f);
  const float x1 = __fsub_rn(__fmul_rn(rx1, s), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(ry1, s), 0.5f);
  f.bin_w = __fmul_rn(__fsub_rn(x1, f.x0), sp.inv_P);
  f.bin_h = __fmul_rn(__fsub_rn(y1, f.y0), sp.inv_P);
  return f;
}

// _axis_samples: position and weight of sample slot t (bin t / m, slot t % m).
__device__ __forceinline__ void axis_position(float b0, float bin, int t, const PoolSpec& sp,
                                              float* pos, float* wgt) {
  const float i = static_cast<float>(t % sp.m);
  const float p = static_cast<float>(t / sp.m);
  float frac;
  if (sp.n > 0) {
    frac = __fmul_rn(__fadd_rn(i, 0.5f), sp.inv_m);
    *wgt = sp.w_fixed;
  } else {
    const float nd = fminf(fmaxf(ceilf(fmaxf(bin, 0.0f)), 1.0f), static_cast<float>(sp.m));
    frac = __fdiv_rn(__fadd_rn(fminf(i, __fsub_rn(nd, 1.0f)), 0.5f), nd);
    *wgt = (i < nd) ? __fdiv_rn(1.0f, nd) : 0.0f;
  }
  *pos = __fadd_rn(b0, __fmul_rn(bin, __fadd_rn(p, frac)));
}

__device__ __forceinline__ AxisSample axis_sample(float pos, float wgt, int size) {
  AxisSample s;
  const float lim = static_cast<float>(size);
  const bool valid = (pos > -1.0f) && (pos < lim);
  const float c = fminf(fmaxf(pos, 0.0f), lim - 1.0f);
  const float c0 = floorf(c);
  const float c1 = fminf(c0 + 1.0f, lim - 1.0f);
  s.c0 = static_cast<int>(c0);
  s.c1 = static_cast<int>(c1);
  s.frac = c - c0;
  s.w = valid ? wgt : 0.0f;
  return s;
}

// Fill sy[0, S) and sx[0, S) (shared memory, S = P * m) for the ROI whose
// frame is `f`, on a level of H x W pixels; the caller syncs.
__device__ __forceinline__ void fill_axis_samples(AxisSample* sy, AxisSample* sx,
                                                  const RoiFrame& f, const PoolSpec& sp, int H,
                                                  int W) {
  const int S = sp.P * sp.m;
  for (int t = threadIdx.x; t < 2 * S; t += blockDim.x) {
    float pos, wgt;
    if (t < S) {
      axis_position(f.y0, f.bin_h, t, sp, &pos, &wgt);
      sy[t] = axis_sample(pos, wgt, H);
    } else {
      axis_position(f.x0, f.bin_w, t - S, sp, &pos, &wgt);
      sx[t - S] = axis_sample(pos, wgt, W);
    }
  }
}

template <typename T>
inline LevelTable<T> make_level_table(T* p0, T* p1, T* p2, T* p3, int H0, int W0, int H1,
                                      int W1, int H2, int W2, int H3, int W3) {
  LevelTable<T> lv;
  T* ptrs[kMaxLevels] = {p0, p1, p2, p3};
  const int Hs[kMaxLevels] = {H0, H1, H2, H3};
  const int Ws[kMaxLevels] = {W0, W1, W2, W3};
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = ptrs[i];
    lv.H[i] = Hs[i];
    lv.W[i] = Ws[i];
  }
  return lv;
}

// Returns false when the pool's shape is outside what the kernels take.
inline bool make_pool_spec(PoolSpec* sp, int num_levels, float s0, float s1, float s2, float s3,
                           int min_level, int P, int n) {
  if (num_levels < 1 || num_levels > kMaxLevels || P < 1 || n < 0) return false;
  const float strides[kMaxLevels] = {s0, s1, s2, s3};
  for (int i = 0; i < kMaxLevels; ++i) sp->inv_stride[i] = 1.0f / strides[i];
  sp->num_levels = num_levels;
  sp->min_level = min_level;
  sp->P = P;
  sp->n = n;
  sp->m = n > 0 ? n : kAdaptiveCap;
  sp->inv_P = 1.0f / static_cast<float>(P);
  sp->inv_m = 1.0f / static_cast<float>(sp->m);
  sp->w_fixed = static_cast<float>(1.0 / static_cast<double>(sp->m));
  return P * sp->m <= kMaxSamples;
}

inline int channel_threads(int C) { return C >= 256 ? 256 : ((C + 31) / 32) * 32; }

// A tap weight as the kernels multiply it: float32, or rounded to bfloat16
// for bfloat16 features (the TPU kernel's ry.astype(dtype)).
__device__ __forceinline__ float tap_weight(float w, float) { return w; }
__device__ __forceinline__ float tap_weight(float w, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// Four bfloat16 channels (8 bytes) as float32: bfloat16 is the upper half
// of a float32, each word holds two channels, the lower one first.
__device__ __forceinline__ float4 bf16x4(const uint2 r) {
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}

// Four float32 values rounded to bfloat16 and packed as bf16x4 reads them.
__device__ __forceinline__ uint2 pack_bf16x4(const float4 v) {
  const unsigned a = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
  const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
  const unsigned c = __bfloat16_as_ushort(__float2bfloat16_rn(v.z));
  const unsigned d = __bfloat16_as_ushort(__float2bfloat16_rn(v.w));
  return make_uint2(a | (b << 16), c | (d << 16));
}

}  // namespace ttdg
