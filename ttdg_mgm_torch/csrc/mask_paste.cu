// Mask paste for Hopper: each detection's M x M mask probabilities pasted
// into its box on the H x W image and thresholded, all K boxes of an image in
// one launch.
//
// Replaces no TPU kernel.  The JAX package pastes with a jitted `vmap`
// (ttdg_mgm_tpu/ops/mask_paste.py:paste_masks) and, at any image size on the
// host, with its NumPy twin `paste_masks_np`, whose result this kernel
// computes bit for bit.  The port's plain version
// (ops/mask_paste.py:paste_masks_plain) loops over the boxes on the host.
//
// The function, per box k with float32 corners (x1, y1, x2, y2):
//
// * the window [max(floor(y1), 0), min(ceil(y2) + 1, H)) x the same in x;
//   every other pixel is 0;
// * the sides x2 - x1 and y2 - y1 in float32, floored at the float64 1e-6;
// * the sample positions ys = ((y + 0.5) - y1) / h * M - 0.5 (xs likewise)
//   in float64;
// * four-corner bilinear sampling with zeros outside the M x M grid, in
//   NumPy's expression and order, the float32 mask values promoted:
//   g00*(1-ly)*(1-lx) + g01*(1-ly)*lx + g10*ly*(1-lx) + g11*ly*lx;
// * the pixel is v >= threshold.
//
// The float64 intrinsics (__dadd_rn, __dmul_rn, ...) keep nvcc from
// contracting any of it into an FMA, which would round differently.
//
// What bounds it on the H100: the (K, H, W) uint8 it writes, 64 MB for 100
// boxes on an 800 x 800 image (19 us at 3.35 TB/s); next, the float64
// arithmetic of the pixels inside the windows.
//
// What the design does about it:
//
// * one block per (box, 8 rows); each thread owns 16 consecutive columns and
//   writes them with one 16-byte store where the row's address allows it
//   (8- or 4-byte stores where a row of an odd width starts less aligned,
//   bytes on the ragged tail); rows and columns outside the window store
//   zeros and compute nothing, so the output needs no memset (the wrapper
//   allocates it with torch.empty);
// * a column's sample position, grid slot and weight are computed once per
//   block and kept in registers over the block's rows;
// * a row's y-weights are folded in once: for each of its rows the block's
//   shared table holds g(y0, j) * (1 - ly) and g(y0 + 1, j) * ly for every
//   mask column j (NumPy's first products), with zero cells padding both
//   sides, so a pixel costs 4 table reads, 4 products and 3 sums;
// * the boxes are read on the device, so the caller does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPix = 16;      // columns a thread owns: one 16-byte store
constexpr int kRows = 8;      // rows of a block
constexpr int kMaxThreads = 256;

// Position of pixel i's centre on a mask axis: ((i + 0.5) - lo) / side * M
// - 0.5, in float64 and NumPy's order.
__device__ __forceinline__ double sample_pos(long long i, double lo, double side, int M) {
  double t = __dadd_rn(static_cast<double>(i), 0.5);
  t = __dsub_rn(t, lo);
  t = __ddiv_rn(t, side);
  t = __dmul_rn(t, static_cast<double>(M));
  return __dsub_rn(t, 0.5);
}

// A box side, hi - lo in float32, floored at the float64 1e-6 (Python's
// max(side, 1e-6) in the NumPy version).
__device__ __forceinline__ double box_side(float lo, float hi) {
  const double s = static_cast<double>(__fsub_rn(hi, lo));
  return 1e-6 > s ? 1e-6 : s;
}

// The 16 bytes of a chunk, `n` of them inside the row, with the widest
// stores its address allows.
__device__ __forceinline__ void store_chunk(unsigned char* dst, const unsigned (&w)[4], int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (n == kPix && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (n == kPix && (a & 7) == 0) {
    uint2* d = reinterpret_cast<uint2*>(dst);
    d[0] = make_uint2(w[0], w[1]);
    d[1] = make_uint2(w[2], w[3]);
  } else if (n == kPix && (a & 3) == 0) {
    unsigned* d = reinterpret_cast<unsigned*>(dst);
    d[0] = w[0];
    d[1] = w[1];
    d[2] = w[2];
    d[3] = w[3];
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      if (i < n) dst[i] = static_cast<unsigned char>(w[i >> 2] >> ((i & 3) * 8));
    }
  }
}

// masks (K, M, M) float32, boxes (K, 4) float32 xyxy, out (K, H, W) uint8.
// Grid (K, ceil(H / kRows)); dynamic shared memory kRows * 2 * (M + 3)
// doubles.
__global__ void __launch_bounds__(kMaxThreads)
paste_masks_kernel(const float* __restrict__ masks, const float* __restrict__ boxes, int M, int H,
                   int W, double thr, unsigned char* __restrict__ out) {
  extern __shared__ double table[];
  const int k = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, H - row0);
  const int L = M + 3;  // slot j holds mask column j - 1; slots 0, M + 1 and M + 2 are padding
  const float x1 = boxes[4 * k], y1 = boxes[4 * k + 1];
  const float x2 = boxes[4 * k + 2], y2 = boxes[4 * k + 3];
  // the window, kept in float64: a coordinate far outside the image is
  // never converted to an integer
  const double ylo = fmax(floor(static_cast<double>(y1)), 0.0);
  const double yhi = fmin(__dadd_rn(ceil(static_cast<double>(y2)), 1.0), static_cast<double>(H));
  const double xlo = fmax(floor(static_cast<double>(x1)), 0.0);
  const double xhi = fmin(__dadd_rn(ceil(static_cast<double>(x2)), 1.0), static_cast<double>(W));
  // whether any of the block's rows meets the window (the same for every thread)
  const bool live = xlo < xhi && ylo < yhi && row0 < yhi && row0 + rows > ylo;

  if (live) {
    const double h = box_side(y1, y2);
    const float* mk = masks + static_cast<long long>(k) * M * M;
    for (int i = threadIdx.x; i < rows * L; i += blockDim.x) {
      const int r = i / L, j = i - r * L;
      const double gy = sample_pos(row0 + r, static_cast<double>(y1), h, M);
      const double fy = floor(gy);
      const double fy1 = __dadd_rn(fy, 1.0);
      const double ly = __dsub_rn(gy, fy);
      double g0 = 0.0, g1 = 0.0;
      if (j >= 1 && j <= M) {
        if (fy >= 0.0 && fy < M) g0 = static_cast<double>(mk[static_cast<int>(fy) * M + j - 1]);
        if (fy1 >= 0.0 && fy1 < M) g1 = static_cast<double>(mk[static_cast<int>(fy1) * M + j - 1]);
      }
      table[2 * r * L + j] = __dmul_rn(g0, __dsub_rn(1.0, ly));
      table[(2 * r + 1) * L + j] = __dmul_rn(g1, ly);
    }
    __syncthreads();
  }

  const double w = box_side(x1, x2);
  unsigned char* const img = out + static_cast<long long>(k) * H * W;
  const int nch = (W + kPix - 1) / kPix;
  for (int c = threadIdx.x; c < nch; c += blockDim.x) {
    const int x0 = c * kPix;
    const int n = min(kPix, W - x0);
    // the chunk's columns: which lie inside the window, their slot pair and weight
    unsigned inside = 0u;
    int slot[kPix];
    double lx[kPix];
    if (live && x0 < xhi && x0 + kPix > xlo) {
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int x = x0 + i;
        const double gx = sample_pos(x, static_cast<double>(x1), w, M);
        const double fx = floor(gx);
        lx[i] = __dsub_rn(gx, fx);
        // corners fx and fx + 1 read slots fx + 1 and fx + 2; with neither
        // inside the grid, both read padding
        slot[i] = fx >= -1.0 && fx <= M - 1 ? static_cast<int>(fx) + 1 : M + 1;
        if (x >= xlo && x < xhi) inside |= 1u << i;
      }
    }
    for (int r = 0; r < rows; ++r) {
      const int y = row0 + r;
      unsigned bits[4] = {0u, 0u, 0u, 0u};
      if (inside != 0u && y >= ylo && y < yhi) {
        const double* t0 = table + 2 * r * L;
        const double* t1 = t0 + L;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const double ax = __dsub_rn(1.0, lx[i]);
          double v = __dadd_rn(__dmul_rn(t0[slot[i]], ax), __dmul_rn(t0[slot[i] + 1], lx[i]));
          v = __dadd_rn(v, __dmul_rn(t1[slot[i]], ax));
          v = __dadd_rn(v, __dmul_rn(t1[slot[i] + 1], lx[i]));
          if (((inside >> i) & 1u) && v >= thr) bits[i >> 2] |= 1u << ((i & 3) * 8);
        }
      }
      store_chunk(img + static_cast<long long>(y) * W + x0, bits, n);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  masks (K, M, M) float32, boxes
// (K, 4) float32 and out (K, H, W) uint8, all contiguous on the device.
// Launches on `stream` (nothing for K, H or W of 0) and returns
// cudaGetLastError(); the caller raises when it is not 0.
extern "C" int ttdg_paste_masks(const void* masks, const void* boxes, int K, int M, int H, int W,
                                double threshold, void* out, void* stream) {
  if (K < 0 || M <= 0 || H < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  const int row_blocks = (H + kRows - 1) / kRows;
  if (row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int nch = (W + kPix - 1) / kPix;
  const int threads = nch >= kMaxThreads ? kMaxThreads : (nch + 31) / 32 * 32;
  const long long smem = static_cast<long long>(sizeof(double)) * kRows * 2 * (M + 3);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paste_masks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paste_masks_kernel<<<dim3(K, row_blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(masks), static_cast<const float*>(boxes), M, H, W, threshold,
      static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
