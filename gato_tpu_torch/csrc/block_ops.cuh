// Block-level helpers shared by the kernels that give one thread block to
// one problem: a deterministic block sum, the per-knot clamp and a
// finiteness test.
#pragma once
#include <cuda_runtime.h>

namespace gato {

constexpr float PCG_ABS_TOL = 1e-6f;  // pcg.cuh:26
constexpr float CLAMP = 1e30f;

// sum of v over the block; every thread gets the result. The order is
// fixed (warp shuffles, then the warps' partials in order), so the sum is
// the same from run to run. red holds 32 floats of shared memory.
__device__ inline float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// a knot's partial sum, clamped so that a diverged problem's sums stay
// finite (pallas_solve._segsum, pallas_pcg._dot)
__device__ inline float clamp_term(float t) { return fabsf(t) <= CLAMP ? t : CLAMP; }

__device__ inline bool finite_vec(const float* v, int n) {
  bool ok = true;
  for (int i = 0; i < n; ++i) ok = ok && isfinite(v[i]);
  return ok;
}

}  // namespace gato
