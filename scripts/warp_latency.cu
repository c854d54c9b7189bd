// Latency of the warp primitives that make up one search step of the GA-GM
// kernel's LAP (ttdg_mgm_torch/csrc/gagm.cu:lap_graph), each measured as a
// chain of 4096 dependent operations on one warp of one block:
// redux.sync min, a shuffle, ballot + ffs, a shared-memory load, a float
// multiply-add, and an and + select pair.  Prints cycles per iteration.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o warp_latency scripts/warp_latency.cu
//   ./warp_latency
#include <cstdio>
#include <cuda_runtime.h>
__global__ void k(long long* out, float* sink) {
  __shared__ float sm[2048];
  for (int i = threadIdx.x; i < 2048; i += 32) sm[i] = i * 0.5f;
  __syncwarp();
  const int lane = threadIdx.x;
  const int N = 4096;
  unsigned x = lane * 2654435761u + 12345u;
  long long t0, t1;
  // redux min chain
  t0 = clock64();
  for (int i = 0; i < N; ++i) x = __reduce_min_sync(0xffffffffu, x + lane) + 1u;
  t1 = clock64();
  if (lane == 0) out[0] = (t1 - t0);
  // shfl chain
  int idx = lane;
  t0 = clock64();
  for (int i = 0; i < N; ++i) idx = __shfl_sync(0xffffffffu, idx + 1, idx & 31);
  t1 = clock64();
  if (lane == 0) out[1] = (t1 - t0);
  // ballot + ffs chain
  unsigned b = x;
  t0 = clock64();
  for (int i = 0; i < N; ++i) b = __ffs(__ballot_sync(0xffffffffu, (b + lane) & 1u)) + b;
  t1 = clock64();
  if (lane == 0) out[2] = (t1 - t0);
  // LDS dependent chain
  int a = lane;
  t0 = clock64();
  for (int i = 0; i < N; ++i) a = (int)sm[(a + lane) & 2047];
  t1 = clock64();
  if (lane == 0) out[3] = (t1 - t0);
  // FADD chain
  float f = lane;
  t0 = clock64();
  for (int i = 0; i < N; ++i) f = (f - 1.5f) * 1.0001f;
  t1 = clock64();
  if (lane == 0) out[4] = (t1 - t0);
  // int select chain
  unsigned s = x;
  t0 = clock64();
  for (int i = 0; i < N; ++i) s = (s & 0x80000000u) ? ~s : (s | 0x80000000u);
  t1 = clock64();
  if (lane == 0) out[5] = (t1 - t0);
  sink[lane] = x + idx + b + a + f + s;
}
int main() {
  long long* d; float* s; cudaMalloc(&d, 64); cudaMalloc(&s, 256);
  k<<<1, 32>>>(d, s); k<<<1, 32>>>(d, s);
  long long h[6]; cudaMemcpy(h, d, 48, cudaMemcpyDeviceToHost);
  const char* n[6] = {"redux_min+add", "shfl+add", "ballot+ffs+add", "lds+cvt+add", "fadd+fmul", "and+sel"};
  for (int i = 0; i < 6; ++i) printf("%s: %.1f cycles per iteration\n", n[i], h[i] / 4096.0);
  return 0;
}
