// Fused Graduated-Assignment multi-graph matching (GA-GM) for Hopper: the
// whole annealed solve and its exact Jonker-Volgenant LAP finale in ONE launch
// of ONE thread-block cluster, with every operand resident in shared memory.
//
// Replaces the TPU kernel built by `_make_kernel` in
// ttdg_mgm_tpu/ops/pallas/gagm_pallas.py (wrapper `ga_gm_fused`, production
// options exact_lap_finale=True, final_hungarian=False, concurrent rows).
// Semantics of record: ttdg_mgm_tpu/graph/solvers.py:ga_gm with its exact
// terminal Hungarian round (ops/lap.py:_lap_single).
//
// What it computes.  tau starts at sk_tau0 and is multiplied by sk_gamma down
// to min_tau; each tau runs up to mgm_iter power steps
//     V = (2 qw A ((U U^T) A) U + W U) / G
// each followed by a per-graph rectangular log-domain Sinkhorn (sk_iter
// sweeps, dummy entries at -100, orientation chosen by ms <= n_univ) and the
// stop test fro2(U_new - U) < tol^2 or fro2(U_new - U_last) == 0.  Then up
// to lap_cap finale steps project the power step by an exact JV LAP per graph
// (universe slots assign to node columns; node-less columns cost
// 2 max|C| + 1000), with the 2-graph identity pin after every projection.
//
// Left out: the plain version's overflow guard (graph/solvers.py:_gagm_round,
// c = max(max|V| / 1e30, 1), projecting V / c at tau / c).  It is the identity
// for max|V| < 1e30: c is then exactly 1.  The guard exists for the universe
// learner's 1e8 adjacency scale, which reaches HiPPI, not this solver, whose
// inputs are attention weights and doubly-stochastic blocks in [0, 1].
//
// What bounds it on the H100: latency, not bytes or flops.  The problem is
// ~0.6 MB at the flagship shape (4 graphs of 60 nodes, universe 32), a power
// step is a few MFLOP, and the solve is a chain of some hundreds of dependent
// steps, each a chain of dependent phases, ending in a sequential LAP
// recurrence.  What the design does about it:
//
// * One cluster of G blocks, block g owning graph g, instead of the whole
//   grid: the phases of a step meet at the hardware cluster barrier
//   (barrier.cluster), twice per step, and the first wait is split from its
//   arrive so that the projection runs between them.
// * Operands are loaded once.  Block g copies the diagonal blocks of A, its
//   rows of W and all of U into shared memory at the start and keeps them for
//   every round; intermediates never leave the SM.  After its projection a
//   block writes its new rows of U into every block's copy through
//   distributed shared memory.
// * A is block-diagonal (graph/mgm.py builds it with block_diag), so only its
//   diagonal blocks are read and multiplied:
//       V_g = (2 qw sum_j (A_g ((U_g U_j^T) A_j)) U_j + W_g U) / G.
//   The product order A((U U^T)A)U of the JAX package is kept, and every
//   output is one accumulator over ascending k, so skipping the zero blocks
//   changes no bit (fmaf(x, 0, acc) == acc).
// * Full-float32 FFMA from shared memory (no TF32, no tensor cores: the LAP
//   costs must be exact float32, and at tau = 0.01 V / tau amplifies
//   rounding), register-tiled 4 x 4 outputs per thread with 16-byte loads;
//   row strides are padded by 4 floats against bank conflicts.
// * The Sinkhorn sweeps run in shared memory, a warp normalising four rows
//   or columns at once so that their reductions overlap.
// * The LAP runs on one warp with its state in registers: each lane owns two
//   columns (minv, v, way, used, the assigned row and that row's u), or one
//   when max(ms, n_univ) <= 32 and the columns past 32 can never be chosen.
//   The cost row comes from shared memory, and the argmin is two warp
//   reductions (redux.sync on an order-preserving integer image of the
//   float, then on the column index, which carries the column's row with it:
//   first-index tie-breaks as ops/lap.py).  It scans the Mp padded node
//   columns: a search reaches a node-less column only when every node column
//   is taken, so at most n_univ - ms of them, the first ones, are ever
//   touched, and the 128-column padding of the TPU kernel adds nothing.
//
// Limits of the resident design: G <= 8 (the portable cluster size),
// Mp <= 64, n_univ <= 64, and ttdg_gagm_smem_bytes(G, Mp, n_univ) within the
// 232,448 bytes one block may use.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kDummyLog = -100.0f;
constexpr float kInfLap = 1.0e30f;
constexpr int kThreads = 256;
constexpr int kMaxTaus = 32;
constexpr int kMaxG = 8;
constexpr int kMaxMp = 64;
constexpr int kMaxNU = 64;
constexpr int kVI = 4;            // V outputs per thread: kVI rows x 4 columns
constexpr int kMaxSmem = 232448;  // bytes one block may use on the H100
constexpr int kClockSlots = 16;
constexpr unsigned kFull = 0xffffffffu;

struct Problem {
  const float* A;      // (T, T), T = G * M; only the diagonal M x M blocks are read
  const float* W;      // (T, T) joint pairwise doubly-stochastic matrix
  const float* U0;     // (T, NU) seed
  const int* ms;       // (G,) valid nodes per graph
  float* out;          // (T, NU)
  int* iters;          // (ntaus + 2,): steps per round, then a status word
  float* v_out;        // (G * Mp, NU) last power step (rows below ms), or null
  long long* clk;      // (kClockSlots,) phase clocks of block 0, or null
  int G, M, Mp, NU;
  float qw, tol2;
  int mgm_iter, sk_iter, lap_cap, ntaus;
  float taus[kMaxTaus];
};

// Shared-memory layout, in floats.  Row strides: lda for A blocks and the
// scratch tiles, ldw for the W rows, ldu for U, ldn for the block's own
// U_last and U_new.  The two scratch tiles also hold the projection's state:
// tile 0 the Sinkhorn matrix or the LAP cost, tile 1 the power step V.
struct Layout {
  int NUp, lda, ldw, ldu, ldn;
  int oA, oW, oU, oLast, oNew, oTile, oMisc, total;
};

constexpr int kMiscFloats = 2 * kMaxG + 8 + kMaxMp + kMaxG + 2 * kClockSlots;

__host__ __device__ inline Layout make_layout(int G, int Mp, int NU) {
  Layout L;
  L.NUp = (NU + 3) / 4 * 4;
  L.lda = Mp + 4;
  L.ldw = G * Mp + 4;
  L.ldu = L.NUp + 4;
  L.ldn = L.NUp;
  L.oA = 0;
  L.oW = L.oA + G * Mp * L.lda;
  L.oU = L.oW + Mp * L.ldw;
  L.oLast = L.oU + G * Mp * L.ldu;
  L.oNew = L.oLast + Mp * L.ldn;
  L.oTile = L.oNew + Mp * L.ldn;
  L.oMisc = L.oTile + 2 * Mp * L.lda;
  L.total = L.oMisc + kMiscFloats;
  return L;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float* acc, float a, const float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// The products run over each graph's live rows only: nl = ms rounded up to a
// multiple of 4.  Rows of U at or past ms are exact zeros, so every term left
// out is an exact zero and no live output changes.  Each product comes with
// TR = 4 rows per thread for large tiles and TR = 1 for small ones, where
// more threads matter more than reuse; the sum per output is the same.

// C (nr x nc, stride ldc) = X (nr x K, stride ldx) @ Y^T, Y (nc x K, stride
// ldy), both read along k; nr, nc, K multiples of 4.  An item is TR rows
// (rg + (nr / TR) i) by the 4 columns cg + (nc / 4) j.
template <int TR>
__device__ __forceinline__ void gemm_nt(float* C, int ldc, const float* X, int ldx,
                                        const float* Y, int ldy, int nr, int nc, int K) {
  const int qr = nr / TR;
  const int qc = nc / 4;
  for (int e = threadIdx.x; e < qr * qc; e += kThreads) {
    const int rg = e / qc;
    const int cgp = e % qc;
    float acc[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += 4) {
      float4 a[TR], b[4];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = ld4(X + (rg + qr * i) * ldx + k0);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ld4(Y + (cgp + qc * j) * ldy + k0);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = acc[i][j];
          t = fmaf(a[i].x, b[j].x, t);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          t = fmaf(a[i].w, b[j].w, t);
          acc[i][j] = t;
        }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(rg + qr * i) * ldc + cgp + qc * j] = acc[i][j];
  }
}

// C (nr x nc, stride ldc) = X (nr x K, stride ldx) @ Y (K x nc, stride ldy);
// nr, nc, K multiples of 4.  An item is TR rows (rg + (nr / TR) i) by 4
// contiguous columns.
template <int TR>
__device__ __forceinline__ void gemm_nn(float* C, int ldc, const float* X, int ldx,
                                        const float* Y, int ldy, int nr, int nc, int K) {
  const int qr = nr / TR;
  const int qc = nc / 4;
  for (int e = threadIdx.x; e < qr * qc; e += kThreads) {
    const int rg = e / qc;
    const int c0 = (e % qc) * 4;
    float acc[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += 4) {
      float4 a[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = ld4(X + (rg + qr * i) * ldx + k0);
      const float4 b0 = ld4(Y + (k0 + 0) * ldy + c0);
      const float4 b1 = ld4(Y + (k0 + 1) * ldy + c0);
      const float4 b2 = ld4(Y + (k0 + 2) * ldy + c0);
      const float4 b3 = ld4(Y + (k0 + 3) * ldy + c0);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        fma4(acc[i], a[i].x, b0);
        fma4(acc[i], a[i].y, b1);
        fma4(acc[i], a[i].z, b2);
        fma4(acc[i], a[i].w, b3);
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      *reinterpret_cast<float4*>(C + (rg + qr * i) * ldc + c0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// Tiles of at least this many 4 x 4 items take 4 rows per thread.
constexpr int kBigTile = 64;

__device__ __forceinline__ void gemm_nt_any(float* C, int ldc, const float* X, int ldx,
                                            const float* Y, int ldy, int nr, int nc, int K) {
  if ((nr / 4) * (nc / 4) >= kBigTile) {
    gemm_nt<4>(C, ldc, X, ldx, Y, ldy, nr, nc, K);
  } else {
    gemm_nt<1>(C, ldc, X, ldx, Y, ldy, nr, nc, K);
  }
}

__device__ __forceinline__ void gemm_nn_any(float* C, int ldc, const float* X, int ldx,
                                            const float* Y, int ldy, int nr, int nc, int K) {
  if ((nr / 4) * (nc / 4) >= kBigTile) {
    gemm_nn<4>(C, ldc, X, ldx, Y, ldy, nr, nc, K);
  } else {
    gemm_nn<1>(C, ldc, X, ldx, Y, ldy, nr, nc, K);
  }
}

// Which V outputs a thread owns: rows r0 + rstep * it (it < kVI, while below
// the graph's live rows) and the 4 columns from 4 * ug.  Threads at or beyond
// `active` own none.
struct VMap {
  int r0, rstep, ug, nit;
  bool active;
};

__device__ __forceinline__ VMap make_vmap(int nl, int NUp) {
  VMap m;
  const int ng = NUp / 4;
  m.rstep = kThreads / ng;
  m.active = static_cast<int>(threadIdx.x) < m.rstep * ng;
  m.r0 = threadIdx.x / ng;
  m.ug = threadIdx.x % ng;
  m.nit = 0;
  if (m.active) {
    for (int it = 0; it < kVI; ++it) {
      if (m.r0 + m.rstep * it < nl) m.nit = it + 1;
    }
  }
  return m;
}

// acc[it][:] += X[row_it, 0:K] @ Y[0:K, 4 ug : 4 ug + 4], ascending k; K a
// multiple of 4.
__device__ __forceinline__ void accumulate_v(float (*acc)[4], const VMap& vm, const float* X,
                                             int ldx, const float* Y, int ldy, int K) {
  if (vm.nit == 0) return;
  const float* yc = Y + vm.ug * 4;
  for (int k0 = 0; k0 < K; k0 += 4) {
    const float4 b0 = ld4(yc + (k0 + 0) * ldy);
    const float4 b1 = ld4(yc + (k0 + 1) * ldy);
    const float4 b2 = ld4(yc + (k0 + 2) * ldy);
    const float4 b3 = ld4(yc + (k0 + 3) * ldy);
#pragma unroll
    for (int it = 0; it < kVI; ++it) {
      if (it < vm.nit) {
        const float4 a = ld4(X + (vm.r0 + vm.rstep * it) * ldx + k0);
        fma4(acc[it], a.x, b0);
        fma4(acc[it], a.y, b1);
        fma4(acc[it], a.z, b2);
        fma4(acc[it], a.w, b3);
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Rows (or columns) a warp normalises at once in a Sinkhorn sweep: their
// reductions are independent, so their shuffles overlap.
constexpr int kLseRows = 4;

// One Sinkhorn half-sweep: subtract from each of `nvec` vectors of `n`
// entries (n <= 64; vector k starts at x + k * vstride, its entries estride
// apart) its masked logsumexp (all-masked -> kNegInf).  Warp w takes vectors
// w * kLseRows + i in rounds; a lane holds entries lane and lane + 32.
__device__ void lse_sweep(float* x, int nvec, int vstride, int n, int estride) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = kThreads / 32;
  const bool has0 = lane < n;
  const bool has1 = lane + 32 < n;
  for (int base = warp * kLseRows; base < nvec; base += nwarps * kLseRows) {
    float x0[kLseRows], x1[kLseRows], m[kLseRows], t[kLseRows];
#pragma unroll
    for (int i = 0; i < kLseRows; ++i) {
      const bool ok = base + i < nvec;
      const float* v = x + (base + i) * vstride;
      x0[i] = (ok && has0) ? v[lane * estride] : kNegInf;
      x1[i] = (ok && has1) ? v[(lane + 32) * estride] : kNegInf;
      m[i] = fmaxf(fmaxf(kNegInf, x0[i]), x1[i]);
    }
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < kLseRows; ++i) m[i] = fmaxf(m[i], __shfl_xor_sync(kFull, m[i], o));
    }
#pragma unroll
    for (int i = 0; i < kLseRows; ++i) {
      const float ms = (m[i] > kNegInf / 2) ? m[i] : 0.0f;
      float acc = 0.0f;
      if (has0) acc += expf(x0[i] - ms);
      if (has1) acc += expf(x1[i] - ms);
      t[i] = acc;
    }
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < kLseRows; ++i) t[i] += __shfl_xor_sync(kFull, t[i], o);
    }
#pragma unroll
    for (int i = 0; i < kLseRows; ++i) {
      if (base + i < nvec) {
        const bool live = m[i] > kNegInf / 2;
        const float lse = live ? m[i] + logf(fmaxf(t[i], 1e-38f)) : kNegInf;
        float* v = x + (base + i) * vstride;
        if (has0) v[lane * estride] = x0[i] - lse;
        if (has1) v[(lane + 32) * estride] = x1[i] - lse;
      }
    }
  }
}

// Block-wide sum of one value per thread, same order in every block.
__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

__device__ float block_max(float x, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_max(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < kThreads / 32; ++w) s = fmaxf(s, red[w]);
  __syncthreads();
  return s;
}

// Rectangular Sinkhorn of this graph's power step v (Mp x NU, dense) into
// unew (stride ldn); `ls` is scratch of Mp * (Mp + 1) floats.
__device__ void sinkhorn_graph(int ms, int Mp, int NU, int sk_iter, float tau, const float* v,
                               float* unew, int ldn, float* ls) {
  const bool orient_a = ms <= NU;
  const int R = orient_a ? max(ms, NU) : ms;       // live node rows
  const int Cn = orient_a ? NU : max(ms, NU);      // live universe columns
  const int ld = Mp + 1;
  for (int e = threadIdx.x; e < R * Cn; e += blockDim.x) {
    const int r = e / Cn;
    const int c = e % Cn;
    const bool real = r < ms && c < NU;
    float x;
    if (real) {
      x = v[r * NU + c] / tau;
    } else {
      const bool dummy = orient_a ? (r >= ms && r < NU && c < NU)
                                  : (c >= NU && c < ms && r < ms);
      x = dummy ? kDummyLog : kNegInf;
    }
    ls[r * ld + c] = x;
  }
  __syncthreads();
  for (int it = 0; it < sk_iter; ++it) {
    // orientation A normalises over universe columns first, B over node rows
    const bool over_cols = orient_a ? (it % 2 == 0) : (it % 2 == 1);
    if (over_cols) {
      lse_sweep(ls, R, ld, Cn, 1);
    } else {
      lse_sweep(ls, Cn, 1, R, ld);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < Mp * NU; e += blockDim.x) {
    const int r = e / NU;
    const int c = e % NU;
    unew[r * ldn + c] = (r < ms) ? expf(ls[r * ld + c]) : 0.0f;
  }
}

// Order-preserving integer image of a float (-0 taken as +0).
__device__ __forceinline__ unsigned float_key(float x) {
  const unsigned k = __float_as_uint(x + 0.0f);  // -0 + 0 = +0
  // negative: all bits flipped; positive: the sign bit set
  return k ^ (static_cast<unsigned>(static_cast<int>(k) >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The recurrence of lap_graph on one warp: lane t owns columns t and, with
// TWO, t + 32.  One slot per lane is enough when max(ms, NU) <= 32: a
// node-less column is reached only when every node column is taken, so the
// columns from max(ms, NU) on are never chosen.  Writes the row assigned to
// each column into pcol (-1 for none).
template <bool TWO>
__device__ __forceinline__ void lap_warp(int Mp, int NU, const float* ct, int* pcol) {
  const int lane = threadIdx.x;
  const bool live0 = lane < Mp;
  const bool live1 = TWO && lane + 32 < Mp;
  float vv0 = 0.0f, vv1 = 0.0f;   // column duals
  int p0 = -1, p1 = -1;           // row assigned to each column
  // The row duals live with the columns: uc is u of the row assigned to the
  // column.  ops/lap.py adds delta to u of the rows of the used columns and
  // of the root row, which is the same sequence of float additions.
  float uc0 = 0.0f, uc1 = 0.0f;
  for (int i = 0; i < NU; ++i) {
    float minv0 = kInfLap, minv1 = kInfLap;
    int way0 = -1, way1 = -1;
    bool used0 = false, used1 = false;    // columns in the tree
    float u_root = 0.0f;                  // u of row i, untouched until now
    int i0 = i;
    float ui0 = 0.0f;
    int j_prev = -1;
    int j_free = -1;
    for (int steps = 0;; ++steps) {
      const float* crow = ct + i0 * Mp;
      const float c0 = live0 ? crow[lane] : kInfLap;
      const float c1 = live1 ? crow[lane + 32] : kInfLap;
      const float cur0 = used0 ? kInfLap : (c0 - ui0) - vv0;
      const float cur1 = used1 ? kInfLap : (c1 - ui0) - vv1;
      if (cur0 < minv0) {
        minv0 = cur0;
        way0 = j_prev;
      }
      if (cur1 < minv1) {
        minv1 = cur1;
        way1 = j_prev;
      }
      const unsigned k0 = live0 ? float_key(used0 ? kInfLap : minv0) : 0xffffffffu;
      const unsigned k1 = live1 ? float_key(used1 ? kInfLap : minv1) : 0xffffffffu;
      // warp argmin, ties to the lowest column; the second reduction also
      // carries the column's assigned row (+ 1) in its low byte
      const unsigned kb = __reduce_min_sync(kFull, min(k0, k1));
      const unsigned cand0 = (k0 == kb) ? ((lane << 8) | (p0 + 1)) : 0xffffffffu;
      const unsigned cand1 = (k1 == kb) ? (((lane + 32) << 8) | (p1 + 1)) : 0xffffffffu;
      const unsigned best = __reduce_min_sync(kFull, min(cand0, cand1));
      const int j1 = static_cast<int>(best >> 8);
      const int nxt = static_cast<int>(best & 0xffu) - 1;
      const float delta = key_float(kb);
      u_root += delta;
      if (used0) {
        uc0 += delta;
        vv0 -= delta;
      } else {
        minv0 -= delta;
      }
      if (used1) {
        uc1 += delta;
        vv1 -= delta;
      } else {
        minv1 -= delta;
      }
      if (lane == (j1 & 31)) {
        if (j1 >> 5) used1 = true; else used0 = true;
      }
      if (nxt < 0 || steps + 1 >= Mp) {
        j_free = j1;
        break;
      }
      i0 = nxt;
      ui0 = __shfl_sync(kFull, (j1 >> 5) ? uc1 : uc0, j1 & 31);
      j_prev = j1;
    }
    // augment along the predecessor chain back to the root row i
    int j = j_free;
    for (int steps = 0;; ++steps) {
      const int jp = __shfl_sync(kFull, (j >> 5) ? way1 : way0, j & 31);
      const int src = jp < 0 ? 0 : jp;
      const int pj = __shfl_sync(kFull, (src >> 5) ? p1 : p0, src & 31);
      const float uj = __shfl_sync(kFull, (src >> 5) ? uc1 : uc0, src & 31);
      const int np = jp < 0 ? i : pj;
      const float nu = jp < 0 ? u_root : uj;
      if (lane == (j & 31)) {
        if (j >> 5) {
          p1 = np;
          uc1 = nu;
        } else {
          p0 = np;
          uc0 = nu;
        }
      }
      if (jp < 0 || steps + 1 >= Mp) break;
      j = jp;
    }
  }
  if (live0) pcol[lane] = p0;
  if (lane + 32 < Mp) pcol[lane + 32] = p1;
}

// Exact JV LAP of one graph (ops/lap.py:_lap_single recurrence, first-index
// tie-breaks) on the transposed cost ct[r][l] = -v[l][r], columns l >= ms
// costing 2 max|C| + 1000, over the Mp node columns.  Warp 0 runs the
// recurrence with its state in registers (lap_warp).  Writes the 0/1
// assignment into unew (stride ldn).
__device__ void lap_graph(int ms, int Mp, int NU, const float* v, float* unew, int ldn,
                          float* ct, int* pcol, float* red, long long* clk) {
  float dmax = 0.0f;
  for (int e = threadIdx.x; e < ms * NU; e += blockDim.x) dmax = fmaxf(dmax, fabsf(v[e]));
  dmax = block_max(dmax, red);
  const float dc = 2.0f * dmax + 1000.0f;
  for (int e = threadIdx.x; e < NU * Mp; e += blockDim.x) {
    const int r = e / Mp;
    const int l = e % Mp;
    ct[e] = (l < ms) ? -v[l * NU + r] : dc;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const long long t0 = clock64();
    if (max(ms, NU) > 32) {
      lap_warp<true>(Mp, NU, ct, pcol);
    } else {
      lap_warp<false>(Mp, NU, ct, pcol);
    }
    if (threadIdx.x == 0) clk[12] += clock64() - t0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Mp * NU; e += blockDim.x) {
    const int l = e / NU;
    const int r = e % NU;
    unew[l * ldn + r] = (l < ms && pcol[l] == r) ? 1.0f : 0.0f;
  }
}

__device__ __forceinline__ long long add_clock(long long* clk, int slot, long long last) {
  // adds the cycles since `last` to a slot of the block's clock table
  const long long now = clock64();
  if (threadIdx.x == 0) clk[slot] += now - last;
  return now;
}

__global__ void __launch_bounds__(kThreads, 1) gagm_kernel(Problem pb) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = blockIdx.x;
  const int G = pb.G, M = pb.M, Mp = pb.Mp, NU = pb.NU;
  const int T = G * M;
  const Layout L = make_layout(G, Mp, NU);
  float* sA = smem + L.oA;
  float* sW = smem + L.oW;
  float* sU = smem + L.oU;
  float* sLast = smem + L.oLast;
  float* sNew = smem + L.oNew;
  float* tile0 = smem + L.oTile;
  float* tile1 = tile0 + Mp * L.lda;
  float* sV = tile1;                       // the power step, dense Mp x NU
  float* part = smem + L.oMisc;            // (G, 2) stop-test sums of every graph
  float* red = part + 2 * kMaxG;
  int* pcol = reinterpret_cast<int*>(red + 8);
  int* sMs = pcol + kMaxMp;
  long long* clk = reinterpret_cast<long long*>(sMs + kMaxG);
  const int tid = threadIdx.x;

  // every block reads the same ms, so all take the same branch here
  bool bad = false;
  for (int i = 0; i < G; ++i) {
    const int m = pb.ms[i];
    bad = bad || m < 0 || m > M;
  }
  if (bad) {
    if (g == 0 && tid == 0) pb.iters[pb.ntaus + 1] = 1;
    return;
  }
  unsigned long long ns0 = 0;
  if (tid == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
    for (int i = 0; i < kClockSlots; ++i) clk[i] = 0;
    clk[15] = clock64();
  }
  if (tid < G) sMs[tid] = pb.ms[tid];

  // resident operands, zero-padded from M to Mp rows and columns per graph
  for (int e = tid; e < L.oTile; e += kThreads) smem[e] = 0.0f;
  __syncthreads();
  for (int e = tid; e < G * M * M; e += kThreads) {
    const int j = e / (M * M);
    const int r = (e / M) % M;
    const int c = e % M;
    sA[(j * Mp + r) * L.lda + c] = pb.A[static_cast<size_t>(j * M + r) * T + j * M + c];
  }
  for (int e = tid; e < M * T; e += kThreads) {
    const int r = e / T;
    const int c = e % T;
    sW[r * L.ldw + (c / M) * Mp + c % M] = pb.W[static_cast<size_t>(g * M + r) * T + c];
  }
  for (int e = tid; e < T * NU; e += kThreads) {
    const int r = e / NU;
    const int c = e % NU;
    sU[((r / M) * Mp + r % M) * L.ldu + c] = pb.U0[e];
  }
  __syncthreads();

  const int ms_g = sMs[g];
  const int nl_g = min(Mp, (ms_g + 3) / 4 * 4);  // live rows, a multiple of 4
  const VMap vm = make_vmap(nl_g, L.NUp);
  const float* sUg = sU + g * Mp * L.ldu;
  const float* sAg = sA + g * Mp * L.lda;
  const float alpha = pb.qw * 2.0f;
  const float div = static_cast<float>(G);
  const int nq = L.NUp / 4;
  long long t_last = clock64();

  for (int round = 0; round <= pb.ntaus; ++round) {
    const bool lap = round == pb.ntaus;
    const int cap = lap ? pb.lap_cap : pb.mgm_iter;
    const float tau = lap ? 1.0f : pb.taus[round];
    const int cs = lap ? 6 : 0;  // clock slots of this kind of round
    for (int e = tid; e < Mp * L.ldn; e += kThreads) sLast[e] = 0.0f;
    __syncthreads();
    int it = 0;
    bool done = false;
    while (it < cap && !done) {
      t_last = clock64();
      // the power step of this graph's rows
      float accq[kVI][4], accw[kVI][4];
#pragma unroll
      for (int i = 0; i < kVI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          accq[i][j] = 0.0f;
          accw[i][j] = 0.0f;
        }
      for (int j = 0; j < G; ++j) {
        const int nl_j = min(Mp, (sMs[j] + 3) / 4 * 4);
        if (nl_g == 0 || nl_j == 0) continue;
        const float* sUj = sU + j * Mp * L.ldu;
        const float* sAj = sA + j * Mp * L.lda;
        gemm_nt_any(tile0, L.lda, sUg, L.ldu, sUj, L.ldu, nl_g, nl_j, L.NUp);      // U_g U_j^T
        __syncthreads();
        gemm_nn_any(tile1, L.lda, tile0, L.lda, sAj, L.lda, nl_g, nl_j, nl_j);     // (.) A_j
        __syncthreads();
        gemm_nn_any(tile0, L.lda, sAg, L.lda, tile1, L.lda, nl_g, nl_j, nl_g);     // A_g (.)
        __syncthreads();
        accumulate_v(accq, vm, tile0, L.lda, sUj, L.ldu, nl_j);                    // (.) U_j
        __syncthreads();
      }
      for (int j = 0; j < G; ++j) {                                                // W_g U
        const int nl_j = min(Mp, (sMs[j] + 3) / 4 * 4);
        accumulate_v(accw, vm, sW + j * Mp, L.ldw, sU + j * Mp * L.ldu, L.ldu, nl_j);
      }
#pragma unroll
      for (int i = 0; i < kVI; ++i) {
        if (i < vm.nit) {
          const int r = vm.r0 + vm.rstep * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = vm.ug * 4 + j;
            if (c < NU) sV[r * NU + c] = fmaf(accq[i][j], alpha, accw[i][j]) / div;
          }
        }
      }
      // this block no longer reads the other graphs' rows of U in this step
      cluster_arrive();
      __syncthreads();
      t_last = add_clock(clk, cs + 0, t_last);
      if (pb.v_out != nullptr) {
        float* vo = pb.v_out + static_cast<size_t>(g) * Mp * NU;
        for (int e = tid; e < Mp * NU; e += kThreads) vo[e] = (e / NU < ms_g) ? sV[e] : 0.0f;
      }

      if (lap) {
        lap_graph(ms_g, Mp, NU, sV, sNew, L.ldn, tile0, pcol, red, clk);
      } else {
        sinkhorn_graph(ms_g, Mp, NU, pb.sk_iter, tau, sV, sNew, L.ldn, tile0);
      }
      __syncthreads();
      if (G == 2 && g == 0) {
        // graph 0 pinned to the identity in the 2-graph case
        for (int e = tid; e < Mp * NU; e += kThreads) {
          const int r = e / NU;
          const int c = e % NU;
          sNew[r * L.ldn + c] = (r == c && r < ms_g) ? 1.0f : 0.0f;
        }
        __syncthreads();
      }
      float d1 = 0.0f;
      float d2 = 0.0f;
      for (int e = tid; e < Mp * NU; e += kThreads) {
        const int r = e / NU;
        const int c = e % NU;
        const float un = sNew[r * L.ldn + c];
        const float a = un - sUg[r * L.ldu + c];
        const float b = un - sLast[r * L.ldn + c];
        d1 += a * a;
        d2 += b * b;
      }
      d1 = block_sum(d1, red);
      d2 = block_sum(d2, red);
      t_last = add_clock(clk, cs + 1, t_last);

      // every block has finished its products: rotate U and publish the new
      // rows and the stop-test sums into every block's shared memory
      cluster_wait();
      t_last = add_clock(clk, cs + 2, t_last);
      for (int e = tid; e < Mp * nq; e += kThreads) {
        const int r = e / nq;
        const int c = (e % nq) * 4;
        const float4 un = ld4(sNew + r * L.ldn + c);
        *reinterpret_cast<float4*>(sLast + r * L.ldn + c) = ld4(sUg + r * L.ldu + c);
        for (int b = 0; b < G; ++b) {
          float* dst = cluster.map_shared_rank(sU, b) + (g * Mp + r) * L.ldu + c;
          *reinterpret_cast<float4*>(dst) = un;
        }
      }
      if (tid < G) {
        float* dst = cluster.map_shared_rank(part, tid);
        dst[2 * g] = d1;
        dst[2 * g + 1] = d2;
      }
      t_last = add_clock(clk, cs + 3, t_last);
      cluster_arrive();
      cluster_wait();
      t_last = add_clock(clk, cs + 4, t_last);
      float s1 = 0.0f;
      float s2 = 0.0f;
      for (int b = 0; b < G; ++b) {
        s1 += part[2 * b];
        s2 += part[2 * b + 1];
      }
      done = (s1 < pb.tol2) || (s2 == 0.0f);
      ++it;
      if (tid == 0) clk[cs + 5] += 1;
    }
    if (g == 0 && tid == 0) pb.iters[round] = it;
  }
  for (int e = tid; e < M * NU; e += kThreads) {
    const int r = e / NU;
    const int c = e % NU;
    pb.out[static_cast<size_t>(g * M + r) * NU + c] = sUg[r * L.ldu + c];
  }
  if (g == 0 && tid == 0) {
    pb.iters[pb.ntaus + 1] = 0;
    if (pb.clk != nullptr) {
      unsigned long long ns1;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
      for (int i = 0; i < 13; ++i) pb.clk[i] = clk[i];
      pb.clk[13] = static_cast<long long>(ns1 - ns0);
      pb.clk[14] = clock64();
      pb.clk[15] = clk[15];
    }
  }
}

}  // namespace

// Dynamic shared memory one block needs for a problem of this shape
// (mirrored by ops/gagm.py:resident_smem_bytes).
extern "C" int ttdg_gagm_smem_bytes(int G, int Mp, int NU) {
  return static_cast<int>(sizeof(float)) * make_layout(G, Mp, NU).total;
}

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers; `taus` is a host array; `v_out` and `clk` may be null.  A, W, U0
// and out are unpadded (T = G * M rows); the kernel pads each graph to Mp
// rows in shared memory.  One cluster of G blocks is launched.  `iters` gets
// the steps of each round and, last, a status word: 0, or 1 when some ms lies
// outside [0, M] (nothing else is written then).  Returns the launch's
// cudaError_t (0 on success); the caller raises when it is not 0.
//
// clk (block 0, thread 0; SM cycles unless said): slots 0-5 for the annealed
// rounds and 6-11 for the finale: products, projection with the stop-test
// sums, wait for the other blocks' products, publishing U, the closing
// cluster barrier, steps taken; 12 the LAP warp's recurrence (inside the
// finale's projection); 13 the kernel's nanoseconds (globaltimer); 14 and 15
// the SM's cycle counter at the end and at the start.
extern "C" int ttdg_gagm(const void* A, const void* W, const void* U0, const void* ms,
                         void* out, void* iters, void* v_out, void* clk, int G, int M, int Mp,
                         int NU, float qw, float tol2, int mgm_iter, int sk_iter, int lap_cap,
                         int ntaus, const float* taus, void* stream) {
  if (ntaus < 1 || ntaus > kMaxTaus || G < 1 || G > kMaxG || M < 1 || Mp < M || Mp < NU ||
      Mp % 8 != 0 || Mp > kMaxMp || NU < 1 || NU > kMaxNU) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = ttdg_gagm_smem_bytes(G, Mp, NU);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  Problem pb;
  pb.A = static_cast<const float*>(A);
  pb.W = static_cast<const float*>(W);
  pb.U0 = static_cast<const float*>(U0);
  pb.ms = static_cast<const int*>(ms);
  pb.out = static_cast<float*>(out);
  pb.iters = static_cast<int*>(iters);
  pb.v_out = static_cast<float*>(v_out);
  pb.clk = static_cast<long long*>(clk);
  pb.G = G;
  pb.M = M;
  pb.Mp = Mp;
  pb.NU = NU;
  pb.qw = qw;
  pb.tol2 = tol2;
  pb.mgm_iter = mgm_iter;
  pb.sk_iter = sk_iter;
  pb.lap_cap = lap_cap;
  pb.ntaus = ntaus;
  for (int i = 0; i < ntaus; ++i) pb.taus[i] = taus[i];

  cudaError_t err = cudaFuncSetAttribute(gagm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gagm_kernel, pb);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
