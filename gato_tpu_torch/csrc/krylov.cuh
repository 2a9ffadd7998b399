// The Krylov loop's per-knot pieces for blocks held in shared memory, shared
// by the iteration kernels' phase D (sqp_iter.cuh, kShared) and the pcg
// kernel's shared and cluster variants (pcg.cu): a few rows of a
// block-tridiagonal matvec, a dot product over those rows, and the sum over
// knots that every thread of a block gets.
#pragma once
#include <cuda_runtime.h>

#include "block_ops.cuh"

namespace gato {
namespace krylov {

// Rows [r0, r0 + R) of the block-tridiagonal matvec
//   y_k = main_k x_k + lower_{k-1} x_{k-1} + lower_k^T x_{k+1}
// (pallas_pcg _matvec order) at knot k, the NX x NX blocks held
// element-major in shared memory: element e of the knot in slot s at
// blk[e * stride + s], so a warp's consecutive knots read consecutive
// banks. x(knot, c) reads the vector; prev / next say whether knot k-1 /
// k+1 exists. Each row sums in that order (main, lower, upper, each over c
// ascending; a missing neighbour adds 0 x 0, btd_matvec's +0). The loop
// over c is unrolled NX / R times only, so the loop body stays about 36
// loads long whatever R is (a fully unrolled 12-row body is some 48 KB of
// code, which the instruction cache does not hold).
template <int NX, int R, typename X>
__device__ __forceinline__ void btd_rows_at(const float* blk, int stride, int s, int k,
                                            bool prev, bool next, int r0, int em, int el,
                                            X x, float (&y)[R]) {
  constexpr int CU = NX / R;
  const float* M = blk + (size_t)(em + r0 * NX) * stride + s;       // (r0 + i, c)
  const float* Lp = blk + (size_t)(el + r0 * NX) * stride + s - 1;  // knot k-1's
  const float* Lt = blk + (size_t)(el + r0) * stride + s;           // (c, r0 + i)
  float acc[R], t1[R], t2[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = t1[i] = t2[i] = 0.0f;
#pragma unroll 1
  for (int c0 = 0; c0 < NX; c0 += CU) {
#pragma unroll
    for (int cc = 0; cc < CU; ++cc) {
      const int c = c0 + cc;
      const float xk = x(k, c);
      const float xp = prev ? x(k - 1, c) : 0.0f;
      const float xn = next ? x(k + 1, c) : 0.0f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] += M[(i * NX + c) * stride] * xk;
        t1[i] += (prev ? Lp[(i * NX + c) * stride] : 0.0f) * xp;
        t2[i] += (next ? Lt[(c * NX + i) * stride] : 0.0f) * xn;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) y[i] = acc[i] + t1[i] + t2[i];
}

// btd_rows_at for a whole horizon of N knots in one block: knot k in slot
// k, stride N.
template <int NX, int R, typename X>
__device__ __forceinline__ void btd_rows(const float* blk, int N, int k, int r0, int em,
                                         int el, X x, float (&y)[R]) {
  btd_rows_at<NX, R>(blk, N, k, k, k > 0, k < N - 1, r0, em, el, x, y);
}

template <int R>
__device__ __forceinline__ float rows_dot(const float (&a)[R], const float (&b)[R]) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i) s += a[i] * b[i];
  return s;
}

// The sum over knots of clamp(sum over the G groups of each knot's partial),
// the same value in every thread. One warp (G = 1, N <= 32): shuffles only.
// Otherwise each group writes its partials to part (G W floats), one
// barrier, and every warp sums all knots in the same order.
template <int G>
__device__ __forceinline__ float knot_total(float partial, float* part, int W,
                                            int N, int k, int g, bool one_warp) {
  float v;
  if (G == 1 && one_warp) {
    v = clamp_term(partial);
  } else {
    part[g * W + k] = partial;
    __syncthreads();
    v = 0.0f;
    for (int kk = threadIdx.x & 31; kk < N; kk += 32) {
      float s = part[kk];
#pragma unroll
      for (int h = 1; h < G; ++h) s += part[h * W + kk];
      v += clamp_term(s);
    }
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

}  // namespace krylov
}  // namespace gato
