// Kernel F: attention with ViTDet's decomposed relative-position bias, for
// Hopper, forward and backward, never writing an N x N matrix to memory.
//
// Replaces no TPU kernel: the JAX package has no image-token attention.  It
// was added for the ViTDet-B backbone (models/vit.py), whose global blocks
// would otherwise keep 12 x 4096^2 float32 scores per image for the backward
// pass, and whose windowed blocks attend over zero-padded windows with a
// bias that has a gradient, which no fused operator of the port takes.
//
// The function, per (batch x head) slice b, query i and key j of N = Kh * Kw
// tokens on a Kh x Kw grid (key j at row j / Kw, column j % Kw), d = 64:
//
//   s_ij = scale * (q_i . k_j) + rel_h[b, i, j / Kw] + rel_w[b, i, j % Kw]
//   o_i  = sum_j softmax_j(s_i.) v_j,   lse_i = log sum_j exp(s_ij)
//
// q, k, v, o and their gradients are bfloat16 (the ViT's compute dtype);
// rel_h, rel_w, the log-sum-exp and the bias gradients float32.  Every sum
// is taken in float32 in a fixed order, and no float atomics are used, so a
// launch gives the same bits every time.
//
// What bounds it on the H100: a global block (N = 4096) does about 2,000
// operations per byte, so the tensor cores; a windowed block (N = 196) about
// 98, under the card's ridge of about 295, so memory.
//
// What the design does about it (a first design that is right and simple;
// no TMA, no wgmma, no pipelining):
//
// * mma.sync m16n8k16 on bf16 with float32 accumulation; each warp owns 16
//   query rows (16 key rows in the dK/dV pass), a block four warps, so one
//   block per (64-row tile, slice), tiles in the grid's x so that the blocks
//   of one slice run together and share its bias rows in L2;
// * forward and dQ pass: the warp's Q (and dO) fragments live in registers,
//   K and V tiles of 64 keys in shared memory, the block's rows of rel_h and
//   rel_w in shared memory; online softmax in float32;
// * the dQ pass also writes delta_i = dO_i . o_i, which the dK/dV pass reads;
//   the bias gradients come from the float32 dS: where a key tile is one
//   grid row (Kw = 64, the global blocks) each thread adds its own dS values
//   to its rows' rel_w bins and the quad's row sum is the tile's rel_h bin;
//   else the warp stages its dS tile in shared memory and each (row, bin)
//   sum is taken by one lane in key order, added to the warp's bins in tile
//   order;
// * the dK/dV pass loops over query tiles, with Q, dO, the log-sum-exp,
//   delta and the bias columns of its keys in shared memory.
//
// C entries: ttdg_vit_attn_fwd and ttdg_vit_attn_bwd (the two backward
// kernels, dQ first).  Each returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kD = 64;          // head size
constexpr int kTile = 64;       // rows of a tile (queries or keys)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kD + 8;     // shared row stride of a bf16 tile (no bank conflicts)
constexpr int kLdS = kTile + 1; // shared row stride of a warp's float dS tile

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two consecutive bf16 at p (4-byte aligned) as one register.
__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// p[0] and p[stride] as one register (the lower half p[0]).
__device__ __forceinline__ uint32_t ld2_strided(const __nv_bfloat16* p, int stride) {
  const uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint16_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// The A fragments (16 rows x 64 columns, four k-steps) of rows r0.. of a
// row-major (N, 64) bf16 matrix in device memory; rows at or past N read 0.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4], const __nv_bfloat16* m,
                                            int r0, int N, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + 2 * t;
    a[ks][0] = ra < N ? ld2(m + (size_t)ra * kD + c) : 0u;
    a[ks][1] = rb < N ? ld2(m + (size_t)rb * kD + c) : 0u;
    a[ks][2] = ra < N ? ld2(m + (size_t)ra * kD + c + 8) : 0u;
    a[ks][3] = rb < N ? ld2(m + (size_t)rb * kD + c + 8) : 0u;
  }
}

// Rows r0 .. r0 + 63 of a row-major (N, 64) bf16 matrix into a shared tile
// of stride kLd, zeros past N.  16-byte copies.
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* m, int r0,
                                          int N) {
  for (int idx = threadIdx.x; idx < kTile * (kD / 8); idx += kThreads) {
    const int r = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < N) v = *reinterpret_cast<const uint4*>(m + (size_t)(r0 + r) * kD + c);
    *reinterpret_cast<uint4*>(s + r * kLd + c) = v;
  }
}

// Rows r0 .. r0 + 63 of a row-major (N, K) float32 matrix into shared
// memory (stride K), zeros past N.
__device__ __forceinline__ void load_rows_f32(float* s, const float* m, int r0, int N, int K) {
  for (int idx = threadIdx.x; idx < kTile * K; idx += kThreads) {
    const int r = idx / K;
    s[idx] = r0 + r < N ? m[(size_t)r0 * K + idx] : 0.f;
  }
}

// The quad's (4 lanes of one row) reduction, in a fixed order.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Forward: grid (ceil(N / 64), BH), 128 threads.  Shared: K and V tiles, the
// block's rows of rel_h (64 x Kh) and rel_w (64 x Kw).
__global__ void __launch_bounds__(kThreads)
vit_attn_fwd_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                    const __nv_bfloat16* __restrict__ V, const float* __restrict__ RH,
                    const float* __restrict__ RW, int N, int Kh, int Kw, float scale,
                    __nv_bfloat16* __restrict__ O, float* __restrict__ LSE) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTile * kLd;
  float* rh = reinterpret_cast<float*>(Vs + kTile * kLd);
  float* rw = rh + kTile * Kh;

  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t off = (size_t)b * N * kD;
  Q += off; K += off; V += off; O += off;
  RH += (size_t)b * N * Kh;
  RW += (size_t)b * N * Kw;
  LSE += (size_t)b * N;

  load_rows_f32(rh, RH, q0, N, Kh);
  load_rows_f32(rw, RW, q0, N, Kw);
  uint32_t qa[4][4];
  load_a_rows(qa, Q, q0 + warp * 16, N, lane);
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;   // the thread's two rows in the block

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_tile(Ks, K, k0, N);
    load_tile(Vs, V, k0, N);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * kLd + ks * 16 + 2 * t;
        mma16816(s[n], qa[ks], ld2(kp), ld2(kp + 8));
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + n * 8 + 2 * t + (e & 1);
        const int lr = e < 2 ? lr0 : lr1;
        float v = -INFINITY;
        if (j < N) {
          const int jh = j / Kw, jw = j - jh * Kw;
          v = s[n][e] * scale + rh[lr * Kh + jh] + rw[lr * Kw + jw];
        }
        s[n][e] = v;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = __expf(s[n][0] - m0);
      s[n][1] = __expf(s[n][1] - m0);
      s[n][2] = __expf(s[n][2] - m1);
      s[n][3] = __expf(s[n][3] - m1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
    l0 = l0 * al0 + quad_sum(rs0);
    l1 = l1 * al1 + quad_sum(rs1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t) * kLd + n * 8 + g;
        mma16816(acc[n], pa, ld2_strided(vp, kLd), ld2_strided(vp + 8 * kLd, kLd));
      }
    }
  }
  const int r0 = q0 + lr0, r1 = q0 + lr1;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(O + (size_t)r0 * kD + c) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(O + (size_t)r1 * kD + c) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (t == 0) {
    if (r0 < N) LSE[r0] = m0 + __logf(l0);
    if (r1 < N) LSE[r1] = m1 + __logf(l1);
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ pass: grid (ceil(N / 64), BH), 128 threads.  Writes dQ, the
// bias gradients and delta.  Shared: K and V tiles, the block's rows of
// rel_h and rel_w, its log-sum-exp and delta, and per warp a float dS tile
// (16 x 64) and its bins (16 x (Kh + Kw)).
__global__ void __launch_bounds__(kThreads)
vit_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                       const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ O,
                       const __nv_bfloat16* __restrict__ dO, const float* __restrict__ LSE,
                       const float* __restrict__ RH, const float* __restrict__ RW, int N,
                       int Kh, int Kw, float scale, __nv_bfloat16* __restrict__ dQ,
                       float* __restrict__ dRH, float* __restrict__ dRW,
                       float* __restrict__ DELTA) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTile * kLd;
  float* rh = reinterpret_cast<float*>(Vs + kTile * kLd);
  float* rw = rh + kTile * Kh;
  float* lse_s = rw + kTile * Kw;
  float* delta_s = lse_s + kTile;
  const int nb = Kh + Kw;
  float* ds_all = delta_s + kTile;
  float* bins_all = ds_all + kWarps * 16 * kLdS;

  const int b = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t off = (size_t)b * N * kD;
  Q += off; K += off; V += off; O += off; dO += off; dQ += off;
  RH += (size_t)b * N * Kh;
  RW += (size_t)b * N * Kw;
  dRH += (size_t)b * N * Kh;
  dRW += (size_t)b * N * Kw;
  LSE += (size_t)b * N;
  DELTA += (size_t)b * N;
  float* ds = ds_all + warp * 16 * kLdS;
  float* bins = bins_all + warp * 16 * nb;

  load_rows_f32(rh, RH, q0, N, Kh);
  load_rows_f32(rw, RW, q0, N, Kw);
  {
    // delta = dO . O per row: two threads a row, 32 columns each
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32;
    float sum = 0.f;
    if (q0 + r < N) {
      const __nv_bfloat16* op = O + (size_t)(q0 + r) * kD + c0;
      const __nv_bfloat16* gp = dO + (size_t)(q0 + r) * kD + c0;
      for (int c = 0; c < 32; ++c) sum += __bfloat162float(op[c]) * __bfloat162float(gp[c]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((threadIdx.x & 1) == 0) {
      delta_s[r] = sum;
      lse_s[r] = q0 + r < N ? LSE[q0 + r] : 0.f;
      if (q0 + r < N) DELTA[q0 + r] = sum;
    }
  }
  for (int i = lane; i < 16 * nb; i += 32) bins[i] = 0.f;
  uint32_t qa[4][4], ga[4][4];
  load_a_rows(qa, Q, q0 + warp * 16, N, lane);
  load_a_rows(ga, dO, q0 + warp * 16, N, lane);
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  // a grid row as wide as a tile: the bins come from registers, no staging
  const bool row_tiles = Kw == kTile;

  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_tile(Ks, K, k0, N);
    load_tile(Vs, V, k0, N);
    __syncthreads();
    const float lse0 = lse_s[lr0], lse1 = lse_s[lr1];
    const float de0 = delta_s[lr0], de1 = delta_s[lr1];
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * kLd + ks * 16 + 2 * t;
        mma16816(s[n], qa[ks], ld2(kp), ld2(kp + 8));
        const __nv_bfloat16* vp = Vs + (n * 8 + g) * kLd + ks * 16 + 2 * t;
        mma16816(dp[n], ga[ks], ld2(vp), ld2(vp + 8));
      }
    }
    // dS = P * (dP - delta), P = exp(s - lse); keys past N give 0
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = n * 8 + 2 * t + (e & 1), j = k0 + jl;
        const bool hi = e >= 2;
        const int lr = hi ? lr1 : lr0;
        float d = 0.f;
        if (j < N) {
          const int jh = j / Kw, jw = j - jh * Kw;
          const float p =
              __expf(s[n][e] * scale + rh[lr * Kh + jh] + rw[lr * Kw + jw] - (hi ? lse1 : lse0));
          d = p * (dp[n][e] - (hi ? de1 : de0));
        }
        s[n][e] = d;
        if (row_tiles)
          bins[(hi ? g + 8 : g) * nb + Kh + jl] += d;   // this thread's (row, column) alone
        else
          ds[(hi ? g + 8 : g) * kLdS + jl] = d;
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kp = Ks + (kk * 16 + 2 * t) * kLd + n * 8 + g;
        mma16816(dq[n], pa, ld2_strided(kp, kLd), ld2_strided(kp + 8 * kLd, kLd));
      }
    }
    if (row_tiles) {
      // a tile is one grid row: its rel_h bin is the row sum of dS (the
      // quad's sum in a fixed order), its rel_w bins the values themselves
      float r0s = 0.f, r1s = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        r0s += s[n][0] + s[n][1];
        r1s += s[n][2] + s[n][3];
      }
      r0s = quad_sum(r0s);
      r1s = quad_sum(r1s);
      if (t == 0) {
        bins[g * nb + k0 / Kw] = r0s;
        bins[(g + 8) * nb + k0 / Kw] = r1s;
      }
      continue;
    }
    __syncwarp();
    // the bias gradients: each (row, bin) of this tile summed by one lane in
    // key order, then added to the warp's bins
    const int kend = min(k0 + kTile, N);
    const int h_lo = k0 / Kw, h_n = (kend - 1) / Kw - h_lo + 1;
    const int items = 16 * (h_n + Kw);
    for (int it = lane; it < items; it += 32) {
      const int r = it / (h_n + Kw), c = it - r * (h_n + Kw);
      const float* row = ds + r * kLdS;
      float sum = 0.f;
      if (c < h_n) {
        const int bh = h_lo + c;
        const int ja = max(bh * Kw, k0), jb = min((bh + 1) * Kw, kend);
        for (int j = ja; j < jb; ++j) sum += row[j - k0];
        bins[r * nb + bh] += sum;
      } else {
        const int bw = c - h_n;
        int j = k0 + ((bw - k0 % Kw) % Kw + Kw) % Kw;
        for (; j < kend; j += Kw) sum += row[j - k0];
        bins[r * nb + Kh + bw] += sum;
      }
    }
    __syncwarp();
  }
  const int r0 = q0 + lr0, r1 = q0 + lr1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(dQ + (size_t)r0 * kD + c) =
          __floats2bfloat162_rn(dq[n][0] * scale, dq[n][1] * scale);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(dQ + (size_t)r1 * kD + c) =
          __floats2bfloat162_rn(dq[n][2] * scale, dq[n][3] * scale);
  }
  __syncwarp();
  for (int i = lane; i < 16 * nb; i += 32) {
    const int r = i / nb, c = i - r * nb, q = q0 + warp * 16 + r;
    if (q >= N) continue;
    if (c < Kh)
      dRH[(size_t)q * Kh + c] = bins[i];
    else
      dRW[(size_t)q * Kw + (c - Kh)] = bins[i];
  }
}

// ---------------------------------------------------------------------------
// Backward, dK/dV pass: grid (ceil(N / 64), BH), 128 threads; each warp owns
// 16 keys.  Shared: Q and dO tiles of 64 queries, their log-sum-exp and
// delta, and the bias columns its keys read: rel_h's rows h_lo .. h_lo +
// h_n - 1 and all of rel_w's, for each query of the tile.
__global__ void __launch_bounds__(kThreads)
vit_attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                         const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ dO,
                         const float* __restrict__ LSE, const float* __restrict__ DELTA,
                         const float* __restrict__ RH, const float* __restrict__ RW, int N,
                         int Kh, int Kw, float scale, __nv_bfloat16* __restrict__ dK,
                         __nv_bfloat16* __restrict__ dV) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Gs = Qs + kTile * kLd;
  float* lse_s = reinterpret_cast<float*>(Gs + kTile * kLd);
  float* delta_s = lse_s + kTile;
  float* rh = delta_s + kTile;

  const int b = blockIdx.y, k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kend = min(k0 + kTile, N);
  const int h_lo = k0 / Kw, h_n = (kend - 1) / Kw - h_lo + 1;
  float* rw = rh + kTile * h_n;
  const size_t off = (size_t)b * N * kD;
  Q += off; K += off; V += off; dO += off; dK += off; dV += off;
  RH += (size_t)b * N * Kh;
  RW += (size_t)b * N * Kw;
  LSE += (size_t)b * N;
  DELTA += (size_t)b * N;

  uint32_t ka[4][4], va[4][4];
  load_a_rows(ka, K, k0 + warp * 16, N, lane);
  load_a_rows(va, V, k0 + warp * 16, N, lane);
  // the thread's two keys and their grid positions, relative to the slice
  int kh[2], kw[2];
  bool kvalid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = k0 + warp * 16 + g + 8 * h;
    kvalid[h] = j < N;
    kh[h] = (kvalid[h] ? j / Kw : h_lo) - h_lo;
    kw[h] = kvalid[h] ? j % Kw : 0;
  }

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();
    load_tile(Qs, Q, q0, N);
    load_tile(Gs, dO, q0, N);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < N;
      lse_s[i] = ok ? LSE[q0 + i] : 0.f;
      delta_s[i] = ok ? DELTA[q0 + i] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kTile * h_n; idx += kThreads) {
      const int i = idx / h_n, c = idx - i * h_n;
      rh[idx] = q0 + i < N ? RH[(size_t)(q0 + i) * Kh + h_lo + c] : 0.f;
    }
    load_rows_f32(rw, RW, q0, N, Kw);
    __syncthreads();
    // S^T (keys x queries) and dP^T = V dO^T
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const __nv_bfloat16* qp = Qs + (n * 8 + g) * kLd + ks * 16 + 2 * t;
        mma16816(s[n], ka[ks], ld2(qp), ld2(qp + 8));
        const __nv_bfloat16* gp = Gs + (n * 8 + g) * kLd + ks * 16 + 2 * t;
        mma16816(dp[n], va[ks], ld2(gp), ld2(gp + 8));
      }
    }
    // P^T and dS^T; queries past N and keys past N give 0
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = n * 8 + 2 * t + (e & 1);
        const int h = e >> 1;
        float p = 0.f;
        if (q0 + il < N && kvalid[h])
          p = __expf(s[n][e] * scale + rh[il * h_n + kh[h]] + rw[il * Kw + kw[h]] - lse_s[il]);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_s[il]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* gp = Gs + (kk * 16 + 2 * t) * kLd + n * 8 + g;
        mma16816(dv[n], pa, ld2_strided(gp, kLd), ld2_strided(gp + 8 * kLd, kLd));
        const __nv_bfloat16* qp = Qs + (kk * 16 + 2 * t) * kLd + n * 8 + g;
        mma16816(dk[n], da, ld2_strided(qp, kLd), ld2_strided(qp + 8 * kLd, kLd));
      }
    }
  }
  const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (j0 < N) {
      *reinterpret_cast<__nv_bfloat162*>(dK + (size_t)j0 * kD + c) =
          __floats2bfloat162_rn(dk[n][0] * scale, dk[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dV + (size_t)j0 * kD + c) =
          __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    }
    if (j1 < N) {
      *reinterpret_cast<__nv_bfloat162*>(dK + (size_t)j1 * kD + c) =
          __floats2bfloat162_rn(dk[n][2] * scale, dk[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dV + (size_t)j1 * kD + c) =
          __floats2bfloat162_rn(dv[n][2], dv[n][3]);
    }
  }
}

int fwd_smem(int Kh, int Kw) {
  return 2 * kTile * kLd * 2 + kTile * (Kh + Kw) * 4;
}

int dq_smem(int Kh, int Kw) {
  return 2 * kTile * kLd * 2 + kTile * (Kh + Kw) * 4 + 2 * kTile * 4 +
         kWarps * 16 * kLdS * 4 + kWarps * 16 * (Kh + Kw) * 4;
}

int dkdv_smem(int Kw) {
  // rel_h columns: at most 64 / Kw + 2 grid rows meet a tile of 64 keys
  const int h_max = kTile / Kw + 2;
  return 2 * kTile * kLd * 2 + 2 * kTile * 4 + kTile * (h_max + Kw) * 4;
}

bool shape_ok(int BH, int N, int Kh, int Kw) {
  return BH > 0 && Kh > 0 && Kw > 0 && Kh <= 64 && Kw <= 64 && Kh * Kw == N && BH <= 65535;
}

}  // namespace

extern "C" {

// q, k, v (BH, N, 64) bf16; rel_h (BH, N, Kh), rel_w (BH, N, Kw) float32;
// N = Kh * Kw.  Writes o (BH, N, 64) bf16 and lse (BH, N) float32.
int ttdg_vit_attn_fwd(const void* q, const void* k, const void* v, const float* rel_h,
                      const float* rel_w, int BH, int N, int Kh, int Kw, float scale, void* o,
                      float* lse, cudaStream_t stream) {
  if (!shape_ok(BH, N, Kh, Kw)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fwd_smem(Kh, Kw);
  cudaError_t err = cudaFuncSetAttribute(vit_attn_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kTile - 1) / kTile, BH);
  vit_attn_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rel_h, rel_w, N, Kh, Kw, scale,
      static_cast<__nv_bfloat16*>(o), lse);
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs, o and lse, and the output's gradient do (BH, N, 64)
// bf16.  Writes dq, dk, dv (bf16), drel_h, drel_w (float32, the shapes of
// rel_h and rel_w) and delta (BH, N) float32 scratch.  Two launches: the dQ
// pass (which writes delta), then the dK/dV pass.
int ttdg_vit_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, const float* rel_h,
                      const float* rel_w, int BH, int N, int Kh, int Kw, float scale, void* dq,
                      void* dk, void* dv, float* drel_h, float* drel_w, float* delta,
                      cudaStream_t stream) {
  if (!shape_ok(BH, N, Kh, Kw)) return static_cast<int>(cudaErrorInvalidValue);
  const int s1 = dq_smem(Kh, Kw), s2 = dkdv_smem(Kw);
  cudaError_t err = cudaFuncSetAttribute(vit_attn_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(vit_attn_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s2);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kTile - 1) / kTile, BH);
  const auto* Q = static_cast<const __nv_bfloat16*>(q);
  const auto* K = static_cast<const __nv_bfloat16*>(k);
  const auto* V = static_cast<const __nv_bfloat16*>(v);
  const auto* G = static_cast<const __nv_bfloat16*>(dout);
  vit_attn_bwd_dq_kernel<<<grid, kThreads, s1, stream>>>(
      Q, K, V, static_cast<const __nv_bfloat16*>(o), G, lse, rel_h, rel_w, N, Kh, Kw, scale,
      static_cast<__nv_bfloat16*>(dq), drel_h, drel_w, delta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vit_attn_bwd_dkdv_kernel<<<grid, kThreads, s2, stream>>>(
      Q, K, V, G, lse, delta, rel_h, rel_w, N, Kh, Kw, scale, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
