// Per-ROI sample geometry shared by the ROI pool (roi_pool.cu) and its
// backward (roi_pool_backward.cu): the level table and one axis sample's
// clamped bilinear corners, as ops/roi_align.py:_bilinear_gather computes
// them.

#pragma once

#include <cuda_runtime.h>

namespace ttdg {

constexpr int kMaxLevels = 4;
constexpr int kMaxSamples = 64;  // P * m per axis: 14 * 4 = 56 at most

template <typename T>
struct LevelTable {
  T* ptr[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
};

struct AxisSample {
  int c0, c1;     // clamped corner indices
  float frac;     // interpolation weight of c1
  float w;        // bin-average weight, 0 when out of range or surplus
};

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

// Fill sy[0, S) and sx[0, S) (shared memory) for ROI r; the caller syncs.
__device__ __forceinline__ void load_axis_samples(AxisSample* sy, AxisSample* sx, int r, int S,
                                                  const float* __restrict__ ys,
                                                  const float* __restrict__ wy,
                                                  const float* __restrict__ xs,
                                                  const float* __restrict__ wx, int H, int W) {
  for (int t = threadIdx.x; t < 2 * S; t += blockDim.x) {
    if (t < S) {
      sy[t] = axis_sample(ys[static_cast<size_t>(r) * S + t], wy[static_cast<size_t>(r) * S + t], H);
    } else {
      const int u = t - S;
      sx[u] = axis_sample(xs[static_cast<size_t>(r) * S + u], wx[static_cast<size_t>(r) * S + u], W);
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

inline int channel_threads(int C) { return C >= 256 ? 256 : ((C + 31) / 32) * 32; }

}  // namespace ttdg
