// Backward of the multi-level FPN ROIAlign (roi_pool.cu) for Hopper: the
// feature gradient of the training pools.
//
// Replaces the TPU kernel `_scatter_kernel` of
// ttdg_mgm_tpu/ops/pallas/roi_pool_pallas.py (the custom VJP
// `_pool_from_atlas_bwd` of `multilevel_roi_align_windowed_train`).  That
// kernel read-modify-writes a 32x40xC window of the level atlas per ROI, one
// ROI after another, because TPU grid steps run in order and windows of
// different ROIs overlap.  Like roi_pool.cu, this computes the semantics of
// record, the gradient of ttdg_mgm_tpu/ops/roi_align.py:multilevel_roi_align,
// for every ROI (no window, no misfit budget):
//
//   d feat[l][b, y, x, c] = sum over ROIs r of image b on level l, in ROI
//                           order, of sum_pq ry[p, y] * cx[q, x] * g[r, p, q, c]
//
// where ry and cx are the ROI's separable bilinear sample weights.
//
// What bounds it on the H100: bytes, at least.  The least it moves is the
// cotangent read once and every level gradient written once (the gradients
// are mostly zero, and larger than the cotangent).  A scatter with float32
// atomics moves about twice that, and training ROIs cluster around a few
// ground-truth boxes, so its atomics contend on the same rows in L2; it also
// adds in an order that changes from run to run.
//
// What this design does about it: it gathers instead of scattering.  A block
// owns one kTile x kTile output tile of one level of one image, for kChunk
// channels, and writes it exactly once (zeros where no ROI reaches), so the
// wrapper allocates the gradients without zeroing them and nothing is read
// back.  A first, small kernel (roi_plan_kernel, one warp per ROI) writes the
// plan: each ROI's level and inclusive pixel footprint, the span of its valid
// samples' bilinear corners (ops/roi_align.py:roi_footprints is its plain
// version), in a compact table for the scan, then its frame and its samples
// along both axes, computed with the code the forward kernel uses
// (roi_geometry.cuh), so this is the exact gradient of roi_pool.cu.  The
// tile's block scans its image's table in ROI order and keeps the ROIs whose
// footprint meets the tile (an ordered compaction with warp ballots).  It
// takes them in batches of kBatch, in that order:
//
// * the batch's samples are copied from the plan (cp.async);
// * one thread per ROI, axis and tile row (or column) finds the samples whose
//   corners fall on its pixel (a binary search: the corners are monotone in
//   the sample index) and sums their weights per bin: ry[p, y] and cx[q, x]
//   are sparse, one or two bins per pixel unless bins are under a pixel, so
//   only the bins that touch the tile are contracted;
// * the cotangent bins that reach the tile are staged in shared memory,
//   16-byte copies all in flight at once;
// * each thread adds sum_p sum_q ry * cx * g for its 8 pixels and 4 channels,
//   two of its column's bins per step with their loads in flight together.
//
// Every output element is the sum of the same terms in the same order in
// every run: the kernel has no atomics and is deterministic.  The coarsest
// levels' tiles, which see the most ROIs, are numbered first so that they
// start first.  What holds it back at the training shapes (PERF.md): each
// (tile, ROI) pair costs a few dependent phases of shared-memory and L2
// latency, with two 256-thread blocks per SM, and an ROI's cotangent bins are
// read again by every tile its footprint meets.
//
// bfloat16 (the bf16 compute policy): the TPU kernel casts the cotangent to
// the feature dtype, sums each ROI's window update in float32 but adds the
// overlapping windows in a bfloat16 scratch and atlas, rounding at every
// window.  This kernel, templated on the element type, takes a bfloat16
// cotangent and writes bfloat16 gradients: the tap weights are rounded to
// bfloat16 as the forward's are (so their products with a bfloat16
// cotangent are exact in float32), each output element is summed in float32
// over every ROI in ROI order, as in float32, and rounded once.  That is more
// exact than the TPU kernel (ROADMAP.md, Queue 3).  A thread still holds 4
// channels, read and staged as 8 bytes instead of 16, so the cotangent reads
// and the gradient writes are half the float32 bytes.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>

#include <climits>

#include "roi_geometry.cuh"

namespace {

using ttdg::AxisSample;

constexpr int kTile = 8;                      // tile side in pixels
constexpr int kChunk = 128;                   // channels per block
constexpr int kLanes = kChunk / 4;            // threads per pixel, 4 channels each
constexpr int kThreads = 256;
constexpr int kSlots = kThreads / kLanes;     // pixels in flight
constexpr int kRowStep = kSlots / kTile;      // a thread's rows are this far apart
constexpr int kRowsPerSlot = kTile / kRowStep;  // pixels per thread
constexpr int kMaxBins = ttdg::kMaxSamples;   // P <= P * m <= 64
constexpr int kStageF4 = 4096;                // float4 of staged cotangent: 64 KB
constexpr int kMinBlocks = 2;                 // blocks per SM the registers allow
constexpr int kBatch = 4;                     // ROIs per batch
constexpr int kQ = 2;                         // a column's bins per step of the sum
constexpr int kWt = 4 * kTile * kMaxBins;     // weights per batch: room for 2 ROIs at P = 64
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSlots % kTile == 0, "a thread's pixels share one column");

// The plan: first, for the scan, one 16-byte HitTest per ROI (its level and
// inclusive footprint; y0 > y1, or x0 > x1, when no sample on that axis
// carries weight); then one row per ROI: a RoiPlan header (its frame on that
// level, the start and bin size along each axis, then the HitTest's values as
// int32), its S = P * m samples along y and its S samples along x.
struct alignas(16) HitTest {
  short level, y0, y1, x0, x1;
  short skip;  // 1: the cotangent is all zero, the ROI adds nothing
  short pad[2];
};

struct alignas(16) RoiPlan {
  float fx0, fy0, bin_w, bin_h;
  int level, y0, y1, x0, x1;
  int pad[3];
};

__host__ __device__ __forceinline__ size_t plan_row_bytes(int S) {
  return sizeof(RoiPlan) + 2 * static_cast<size_t>(S) * sizeof(AxisSample);
}

__device__ __forceinline__ const RoiPlan* plan_row(const void* plan, int R, int r, int S) {
  return reinterpret_cast<const RoiPlan*>(static_cast<const char*>(plan) +
                                          R * sizeof(HitTest) +
                                          static_cast<size_t>(r) * plan_row_bytes(S));
}

// A ROI that meets the block's tile: its index and frame.
struct Hit {
  int r;
  float fx0, fy0, bin_w, bin_h;
};

// Blocks of each level, in launch order (coarsest level first).
struct TileSpec {
  int level[ttdg::kMaxLevels];
  int start[ttdg::kMaxLevels + 1];  // first block of each entry; start[n] = total
  int n;
};

// 4 channels of the element type, as float32: loads, shared-memory stages
// and stores of 16 bytes (float32) or 8 bytes (bfloat16).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return ttdg::bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ float4 unstage4(const float4* gs, int t, float) { return gs[t]; }
__device__ __forceinline__ float4 unstage4(const float4* gs, int t, __nv_bfloat16) {
  return ttdg::bf16x4(reinterpret_cast<const uint2*>(gs)[t]);
}

__device__ __forceinline__ void store4(float* p, const float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4 v) {
  *reinterpret_cast<uint2*>(p) = ttdg::pack_bf16x4(v);
}

// Whether a 32-bit word of cotangent holds a value other than +-0.
__device__ __forceinline__ bool nonzero_word(unsigned w, float) { return (w << 1) != 0u; }
__device__ __forceinline__ bool nonzero_word(unsigned w, __nv_bfloat16) {
  return (w & 0x7fff7fffu) != 0u;
}

__device__ __forceinline__ void fma4(float4* acc, const float4 v, float w) {
  acc->x = fmaf(v.x, w, acc->x);
  acc->y = fmaf(v.y, w, acc->y);
  acc->z = fmaf(v.z, w, acc->z);
  acc->w = fmaf(v.w, w, acc->w);
}

// One warp per ROI: its level, frame and samples, and the span of its valid
// samples' corners.  An ROI whose bins are under a pixel along an axis puts
// many bins on each of its few pixels, the costliest case of the gather (the
// zero boxes that pad the mask pool's rows are such ROIs): its cotangent is
// read here, and the ROI is skipped when it is all zero, which changes no
// sum.  `g` null: no such test.
template <typename T>
__global__ void roi_plan_kernel(ttdg::LevelTable<T> lv, ttdg::PoolSpec sp, int R, int C,
                                const float* __restrict__ rois, const T* __restrict__ g,
                                void* __restrict__ plan) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // whole warps leave together
  const ttdg::RoiFrame fr = ttdg::roi_frame(rois + static_cast<size_t>(r) * 4, sp);
  const int H = lv.H[fr.level];
  const int W = lv.W[fr.level];
  const int S = sp.P * sp.m;
  RoiPlan* row = const_cast<RoiPlan*>(plan_row(plan, R, r, S));
  AxisSample* smp = reinterpret_cast<AxisSample*>(row + 1);
  int ylo = INT_MAX, yhi = -1, xlo = INT_MAX, xhi = -1;
  for (int t = lane; t < S; t += 32) {
    float pos, wgt;
    ttdg::axis_position(fr.y0, fr.bin_h, t, sp, &pos, &wgt);
    const AxisSample a = ttdg::axis_sample(pos, wgt, H);
    smp[t] = a;
    if (a.w != 0.0f) {
      ylo = min(ylo, a.c0);
      yhi = max(yhi, a.c1);
    }
    ttdg::axis_position(fr.x0, fr.bin_w, t, sp, &pos, &wgt);
    const AxisSample e = ttdg::axis_sample(pos, wgt, W);
    smp[S + t] = e;
    if (e.w != 0.0f) {
      xlo = min(xlo, e.c0);
      xhi = max(xhi, e.c1);
    }
  }
  ylo = __reduce_min_sync(kFull, ylo);
  yhi = __reduce_max_sync(kFull, yhi);
  xlo = __reduce_min_sync(kFull, xlo);
  xhi = __reduce_max_sync(kFull, xhi);
  bool skip = false;
  if (g != nullptr && !(fabsf(fr.bin_w) >= 1.0f && fabsf(fr.bin_h) >= 1.0f)) {
    const uint4* gr = reinterpret_cast<const uint4*>(g + static_cast<size_t>(r) * sp.P * sp.P * C);
    const int n4 = static_cast<int>(sp.P * sp.P * C * sizeof(T) / 16);
    bool nonzero = false;
    for (int t = lane; t < n4 && !nonzero; t += 4 * 32) {  // four loads in flight
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (t + 32 * k < n4) {
          const uint4 v = __ldg(gr + t + 32 * k);
          nonzero |= nonzero_word(v.x, T()) | nonzero_word(v.y, T()) |
                     nonzero_word(v.z, T()) | nonzero_word(v.w, T());
        }
      }
    }
    skip = !__any_sync(kFull, nonzero);
  }
  if (lane == 0) {
    RoiPlan pl;
    pl.level = fr.level;
    pl.y0 = yhi < 0 ? 0 : ylo;
    pl.y1 = yhi;
    pl.x0 = xhi < 0 ? 0 : xlo;
    pl.x1 = xhi;
    pl.fx0 = fr.x0;
    pl.fy0 = fr.y0;
    pl.bin_w = fr.bin_w;
    pl.bin_h = fr.bin_h;
    pl.pad[0] = pl.pad[1] = pl.pad[2] = 0;
    *row = pl;
    HitTest ht;
    ht.level = static_cast<short>(pl.level);
    ht.y0 = static_cast<short>(pl.y0);
    ht.y1 = static_cast<short>(pl.y1);
    ht.x0 = static_cast<short>(pl.x0);
    ht.x1 = static_cast<short>(pl.x1);
    ht.skip = skip ? 1 : 0;
    ht.pad[0] = ht.pad[1] = 0;
    static_cast<HitTest*>(plan)[r] = ht;
  }
}

// The samples t in [*lo, *hi] of one axis (c0 and c1 monotone in t: rising
// when `rising`, else falling) whose corners c0 or c1 fall on pixel `pix`;
// *lo > *hi when none does.
__device__ __forceinline__ void samples_on(const AxisSample* smp, int S, bool rising, int pix,
                                           int* lo, int* hi) {
  // first t whose far corner has reached pix, first t whose near corner has passed it
  int a = 0, b = S;
  while (a < b) {
    const int mid = (a + b) >> 1;
    const AxisSample s = smp[mid];
    if (rising ? s.c1 >= pix : s.c0 <= pix) b = mid; else a = mid + 1;
  }
  int c = a, d = S;
  while (c < d) {
    const int mid = (c + d) >> 1;
    const AxisSample s = smp[mid];
    if (rising ? s.c0 > pix : s.c1 < pix) d = mid; else c = mid + 1;
  }
  *lo = a;
  *hi = c - 1;
}

struct Shared {
  Hit list[kThreads];             // the ROIs of one scan round that meet the tile
  int warp_hits[kThreads / 32];
  int nb;                         // ROIs in the current batch
  int wt_off[kBatch + 1];         // each ROI's first weight (prefix over the batch)
  int stage_off[kBatch + 1];      // each ROI's first staged float4; equal ends: not staged
  int rect[kBatch][4];            // each ROI's bins that reach the tile: p0, p1, q0, q1
  short lo[kBatch][2][kTile];     // per ROI, axis and tile row or column: its first bin
  short n[kBatch][2][kTile];      // and how many (contiguous: samples are monotone)
  alignas(16) AxisSample smp[kBatch][2][ttdg::kMaxSamples];  // 16-byte copies land here
  float wt[kWt];                  // per ROI, axis, row or column: the weights of its bins
  float4 gs[kStageF4];            // staged cotangent bins, this block's channels
};

static_assert(2 * kBatch * kTile <= kThreads, "one tap list per thread");

// Thread 0: the next batch of ROIs from list[h0, hits): at most kBatch, their
// weights (2 * kTile * P each) within kWt.
__device__ void plan_batch(Shared& sh, int h0, int hits, int P) {
  const int need = 2 * kTile * P;
  int nb = 0;
  while (nb < kBatch && h0 + nb < hits && (nb + 1) * need <= kWt) ++nb;
  for (int h = 0; h <= nb; ++h) sh.wt_off[h] = h * need;
  sh.nb = nb;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
roi_pool_backward_kernel(ttdg::LevelTable<T> lv, ttdg::PoolSpec sp, TileSpec ts, int C, int R,
                         int K, const void* __restrict__ plan, const T* __restrict__ g) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  // which level, image and tile this block owns
  int e = 0;
  while (e + 1 < ts.n && static_cast<int>(blockIdx.x) >= ts.start[e + 1]) ++e;
  const int l = ts.level[e];
  const int H = lv.H[l];
  const int W = lv.W[l];
  const int nty = (H + kTile - 1) / kTile;
  const int ntx = (W + kTile - 1) / kTile;
  const int local = blockIdx.x - ts.start[e];
  const int b = local / (nty * ntx);
  const int y0 = (local % (nty * ntx)) / ntx * kTile;
  const int x0 = (local % ntx) * kTile;
  const int P = sp.P;
  const int S = P * sp.m;
  const int c_base = blockIdx.y * kChunk;

  const int lane = threadIdx.x % kLanes;  // channels c_base + 4 lane ..
  const int slot = threadIdx.x / kLanes;
  const int col = slot % kTile;           // this thread's tile column
  const int row0 = slot / kTile;          // and rows row0, row0 + kRowStep, ...
  const int c = c_base + lane * 4;
  const bool has_c = c < C;

  float4 acc[kRowsPerSlot];
#pragma unroll
  for (int k = 0; k < kRowsPerSlot; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int base = 0; base < K; base += kThreads) {
    // ordered compaction of this round's ROIs that meet the tile
    const int k = base + threadIdx.x;
    bool hit = false;
    if (k < K) {
      const HitTest ht = static_cast<const HitTest*>(plan)[b * K + k];
      hit = ht.level == l && !ht.skip && ht.y0 <= ht.y1 && ht.x0 <= ht.x1 && ht.y1 >= y0 &&
            ht.y0 < y0 + kTile && ht.x1 >= x0 && ht.x0 < x0 + kTile;
    }
    const unsigned ballot = __ballot_sync(kFull, hit);
    const int wid = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) sh.warp_hits[wid] = __popc(ballot);
    __syncthreads();
    int before = 0, hits = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      before += w < wid ? sh.warp_hits[w] : 0;
      hits += sh.warp_hits[w];
    }
    if (hit) {
      const float4 fr = *reinterpret_cast<const float4*>(plan_row(plan, R, b * K + k, S));
      Hit& dst = sh.list[before + __popc(ballot & ((1u << (threadIdx.x & 31)) - 1u))];
      dst.r = b * K + k;
      dst.fx0 = fr.x;
      dst.fy0 = fr.y;
      dst.bin_w = fr.z;
      dst.bin_h = fr.w;
    }
    __syncthreads();

    for (int h0 = 0, nb = 0; h0 < hits; h0 += nb) {
      if (threadIdx.x == 0) plan_batch(sh, h0, hits, P);
      // the batch's samples, from the plan
      for (int t = threadIdx.x; t < kBatch * 2 * S; t += kThreads) {
        const int hb = t / (2 * S);
        if (h0 + hb >= hits) break;
        const int u = t % (2 * S);
        const AxisSample* src =
            reinterpret_cast<const AxisSample*>(plan_row(plan, R, sh.list[h0 + hb].r, S) + 1) + u;
        __pipeline_memcpy_async(&sh.smp[hb][u / S][u % S], src, sizeof(AxisSample));
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      nb = sh.nb;
      // per ROI, axis and tile row or column (one thread each): the bins
      // whose samples touch it, with their summed weights, and per ROI the
      // rectangle of bins that reach the tile (a reduction over the kTile
      // lanes of its axis)
      {
        const int t = threadIdx.x;
        const int hb = t / (2 * kTile);
        const int axis = (t / kTile) % 2;
        const int i = t % kTile;
        int first = INT_MAX, last = -1;
        if (hb < nb) {
          const Hit& hv = sh.list[h0 + hb];
          const AxisSample* smp = sh.smp[hb][axis];
          const int pix = (axis == 0 ? y0 : x0) + i;
          float* w_out = sh.wt + sh.wt_off[hb] + (axis * kTile + i) * P;
          int lo, hi;
          samples_on(smp, S, (axis == 0 ? hv.bin_h : hv.bin_w) >= 0.0f, pix, &lo, &hi);
          if (lo <= hi) {
            first = lo / sp.m;
            last = hi / sp.m;
            float w = 0.0f;
            int p = first;
            for (int u = lo; u <= hi; ++u) {
              if (u / sp.m != p) {
                w_out[p] = ttdg::tap_weight(w, T());
                w = 0.0f;
                p = u / sp.m;
              }
              const AxisSample a = smp[u];
              if (a.w == 0.0f) continue;
              if (a.c0 == pix) w = __fadd_rn(w, __fmul_rn(a.w, __fsub_rn(1.0f, a.frac)));
              if (a.c1 == pix) w = __fadd_rn(w, __fmul_rn(a.w, a.frac));
            }
            w_out[p] = ttdg::tap_weight(w, T());
          }
          sh.lo[hb][axis][i] = static_cast<short>(lo <= hi ? first : 0);
          sh.n[hb][axis][i] = static_cast<short>(lo <= hi ? last - first + 1 : 0);
        }
        for (int o = kTile / 2; o > 0; o >>= 1) {
          first = min(first, __shfl_xor_sync(kFull, first, o));
          last = max(last, __shfl_xor_sync(kFull, last, o));
        }
        if (hb < nb && i == 0) {
          sh.rect[hb][2 * axis] = first;
          sh.rect[hb][2 * axis + 1] = last;
        }
      }
      __syncthreads();
      // stage each ROI's rectangle of cotangent bins; the batch ends before
      // the first ROI whose bins no longer fit (it starts the next batch),
      // and an ROI whose bins alone do not fit is read from device memory
      if (threadIdx.x == 0) {
        int staged = 0, keep = nb;
        for (int hb = 0; hb < nb; ++hb) {
          sh.stage_off[hb] = staged;
          const int* rc = sh.rect[hb];
          const int f4 = (rc[1] >= rc[0] && rc[3] >= rc[2])
                             ? (rc[1] - rc[0] + 1) * (rc[3] - rc[2] + 1) * kLanes : 0;
          if (staged + f4 > kStageF4 && (hb > 0 || f4 <= kStageF4)) {
            keep = hb;
            break;
          }
          if (f4 <= kStageF4) staged += f4;
        }
        sh.stage_off[keep] = staged;
        sh.nb = keep;
      }
      __syncthreads();
      nb = sh.nb;
      for (int t = threadIdx.x; t < sh.stage_off[nb]; t += kThreads) {
        int hb = 0;
        while (hb + 1 < nb && t >= sh.stage_off[hb + 1]) ++hb;
        const int* rc = sh.rect[hb];
        const int nq = rc[3] - rc[2] + 1;
        const int u = t - sh.stage_off[hb];
        const int bin = u / kLanes;
        const int cc = c_base + (u % kLanes) * 4;
        if (cc < C) {
          const int p = rc[0] + bin / nq;
          const int q = rc[2] + bin % nq;
          const T* src =
              g + (static_cast<size_t>(sh.list[h0 + hb].r) * P * P + p * P + q) * C + cc;
          __pipeline_memcpy_async(reinterpret_cast<char*>(sh.gs) + t * 4 * sizeof(T), src,
                                  4 * sizeof(T));
        } else if (sizeof(T) == 4) {
          sh.gs[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
          reinterpret_cast<uint2*>(sh.gs)[t] = make_uint2(0u, 0u);
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      for (int hb = 0; hb < nb && has_c; ++hb) {
        const int* rc = sh.rect[hb];
        const int nq = rc[3] - rc[2] + 1;
        const bool staged = sh.stage_off[hb + 1] > sh.stage_off[hb];
        const int gsh = sh.stage_off[hb] + lane;
        const T* gr = g + static_cast<size_t>(sh.list[h0 + hb].r) * P * P * C + c;
        const int qlo = sh.lo[hb][1][col];
        const int qn = sh.n[hb][1][col];
        const float* wx = sh.wt + sh.wt_off[hb] + (kTile + col) * P;
        // kQ of the column's bins at a time, their weights in registers and
        // their loads in flight together; the order of the terms is fixed
        for (int qb = 0; qb < qn; qb += kQ) {
          float wq[kQ];
#pragma unroll
          for (int j = 0; j < kQ; ++j) wq[j] = qb + j < qn ? wx[qlo + qb + j] : 0.0f;
#pragma unroll
          for (int k2 = 0; k2 < kRowsPerSlot; ++k2) {
            const int row = row0 + kRowStep * k2;
            const int plo = sh.lo[hb][0][row];
            const int pn = sh.n[hb][0][row];
            const float* wy = sh.wt + sh.wt_off[hb] + row * P;
            for (int pb = plo; pb < plo + pn; ++pb) {
              const float wa = wy[pb];
              float4 v[kQ];
#pragma unroll
              for (int j = 0; j < kQ; ++j) {
                const int q = qlo + qb + j;
                v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                if (qb + j < qn) {
                  v[j] = staged
                             ? unstage4(sh.gs, gsh + ((pb - rc[0]) * nq + (q - rc[2])) * kLanes,
                                        T())
                             : load4(gr + (static_cast<size_t>(pb) * P + q) * C);
                }
              }
#pragma unroll
              for (int j = 0; j < kQ; ++j) {
                if (qb + j < qn) fma4(&acc[k2], v[j], wa * wq[j]);
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (!has_c) return;
  T* f = lv.ptr[l] + static_cast<size_t>(b) * H * W * C;
  const int x = x0 + col;
#pragma unroll
  for (int k2 = 0; k2 < kRowsPerSlot; ++k2) {
    const int y = y0 + row0 + kRowStep * k2;
    if (y < H && x < W) {
      store4(f + (static_cast<size_t>(y) * W + x) * C + c, acc[k2]);
    }
  }
}

template <typename T>
ttdg::LevelTable<T> make_grads(int H0, int W0, int H1, int W1, int H2, int W2, int H3, int W3,
                               void* d0, void* d1, void* d2, void* d3) {
  return ttdg::make_level_table(static_cast<T*>(d0), static_cast<T*>(d1), static_cast<T*>(d2),
                                static_cast<T*>(d3), H0, W0, H1, W1, H2, W2, H3, W3);
}

template <typename T>
int launch_plan(const ttdg::LevelTable<T>& lv, const ttdg::PoolSpec& sp, int R, int C,
                const void* rois, const void* g, void* plan, cudaStream_t stream) {
  const int per_block = 4;  // ROIs (warps) per block
  roi_plan_kernel<T><<<(R + per_block - 1) / per_block, 32 * per_block, 0, stream>>>(
      lv, sp, R, C, static_cast<const float*>(rois), static_cast<const T*>(g), plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const ttdg::LevelTable<T>& lv, const ttdg::PoolSpec& sp, int num_levels,
                    int C, int R, int K, const void* rois, void* plan, const void* g,
                    cudaStream_t st) {
  const int err = launch_plan(lv, sp, R, C, rois, g, plan, st);
  if (err != 0) return err;
  TileSpec ts;
  ts.n = num_levels;
  ts.start[0] = 0;
  const int B = R / K;
  for (int e = 0; e < num_levels; ++e) {
    const int l = num_levels - 1 - e;  // coarsest first: its tiles see the most ROIs
    const int tiles = B * ((lv.H[l] + kTile - 1) / kTile) * ((lv.W[l] + kTile - 1) / kTile);
    ts.level[e] = l;
    ts.start[e + 1] = ts.start[e] + tiles;
  }
  const dim3 grid(ts.start[num_levels], (C + kChunk - 1) / kChunk);
  const int smem = static_cast<int>(sizeof(Shared));
  const cudaError_t e = cudaFuncSetAttribute(
      roi_pool_backward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  roi_pool_backward_kernel<T><<<grid, kThreads, smem, st>>>(lv, sp, ts, C, R, K, plan,
                                                         static_cast<const T*>(g));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes), each launching on `stream` and
// returning cudaGetLastError(); the caller raises when it is not 0.
//
// ttdg_roi_pool_backward takes ttdg_roi_pool's arguments with `d0..d3`, the
// level gradients (B, H_l, W_l, C), as outputs: every element is written, so
// they need no zeroing.  `dtype` 0: float32 cotangent and gradients, 1:
// bfloat16.  `plan` is scratch of R * ttdg_roi_plan_words(P, n) 32-bit
// words, 16-byte aligned (the HitTests, then a RoiPlan and the samples per
// ROI); `g` is the cotangent (R, P, P, C).  C must be a multiple of 4 and the
// gradients 16-byte aligned.
extern "C" int ttdg_roi_pool_backward(void* d0, void* d1, void* d2, void* d3, int num_levels,
                                      int H0, int W0, int H1, int W1, int H2, int W2, int H3,
                                      int W3, int C, int R, int K, const void* rois, float s0,
                                      float s1, float s2, float s3, int min_level, int P, int n,
                                      int dtype, void* plan, const void* g, void* stream) {
  ttdg::PoolSpec sp;
  if (!ttdg::make_pool_spec(&sp, num_levels, s0, s1, s2, s3, min_level, P, n) || R <= 0 ||
      K <= 0 || R % K != 0 || C < 4 || C % 4 != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch_backward(
        make_grads<__nv_bfloat16>(H0, W0, H1, W1, H2, W2, H3, W3, d0, d1, d2, d3), sp,
        num_levels, C, R, K, rois, plan, g, st);
  }
  return launch_backward(make_grads<float>(H0, W0, H1, W1, H2, W2, H3, W3, d0, d1, d2, d3), sp,
                         num_levels, C, R, K, rois, plan, g, st);
}

// 32-bit words of one ROI's plan row for P bins and sampling ratio n.
extern "C" int ttdg_roi_plan_words(int P, int n) {
  const int m = n > 0 ? n : ttdg::kAdaptiveCap;
  return static_cast<int>((sizeof(HitTest) + plan_row_bytes(P * m)) / 4);
}

// The plan kernel alone, for checks against ops/roi_align.py:roi_footprints:
// `plan` is R * ttdg_roi_plan_words(P, n) 32-bit words: R HitTests of 4
// words, then R rows of which words 4..8 are (level, y0, y1, x0, x1).
extern "C" int ttdg_roi_plan(int num_levels, int H0, int W0, int H1, int W1, int H2, int W2,
                             int H3, int W3, float s0, float s1, float s2, float s3,
                             int min_level, int P, int n, int R, const void* rois, void* plan,
                             void* stream) {
  ttdg::PoolSpec sp;
  if (!ttdg::make_pool_spec(&sp, num_levels, s0, s1, s2, s3, min_level, P, n) || R <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_plan(
      make_grads<float>(H0, W0, H1, W1, H2, W2, H3, W3, nullptr, nullptr, nullptr, nullptr), sp,
      R, 0, rois, nullptr, plan, static_cast<cudaStream_t>(stream));
}
