// The merit of every line-search candidate X + a dZX, U + a dZU: one thread
// block per (problem, alpha), one thread per knot, looping over the knots
// when the horizon exceeds the block.
//
// Replaces gato_tpu/ops/pallas_merit.py::_merit_knot_kernel (as wrapped by
// merit_alphas_batched_pallas), the merit sweep of the JAX package's staged
// and fused-iteration routes. Thread k forms its knot's candidate (and the
// next knot's state) in registers: the (B, A, N) candidate trajectories that
// the JAX wrapper builds in memory are never written. It calls the generated
// knot_merit (tracking weight N_cost on the last knot, whose control cost
// and defect do not count), adds mu (defect + |x_0 - x_s|_1 at knot 0),
// clamps the knot's term to 1e30 as the plain version does
// (ops/merit_fast.py::merit_alphas_batched) and the block sums the terms in
// a fixed order, without atomics. An alpha of 0 evaluates X itself. The
// candidate is rounded as the plain version rounds it (a product, then a
// sum: no fused multiply-add).
//
// Bound: the straight-line knot_merit (a few thousand operations per knot
// and alpha) on values already in registers; the inputs are read once per
// alpha from L2. Occupancy and the block shape are left for later work.
#include <cuda_runtime.h>

#include "block_ops.cuh"
#include "generated/indy7.cuh"

namespace gato {

constexpr int MERIT_MAX_ALPHAS = 16;

// Arguments of one launch (ops/cuda_merit.py mirrors it); a named
// namespace, so that the extern "C" entry point keeps external linkage.
struct MeritArgs {
  const float* X;    // (B, N, NX)
  const float* U;    // (B, N-1, NU)
  const float* dZX;  // (B, N, NX)
  const float* dZU;  // (B, N-1, NU)
  const float* xs;   // (B, NX)
  const float* ref;  // (B, N, ref_stride), xyz first
  const float* fe;   // (B, 6)
  const float* mu;   // (B,)
  float* out;        // (B, A)
  int B;
  int N;
  int A;
  int ref_stride;
  float dt;
  float w[7];        // CostParams order
  float alphas[MERIT_MAX_ALPHAS];
};

}  // namespace gato

namespace {

namespace robot = gato::indy7;
constexpr int NQ = robot::NQ;
constexpr int NX = robot::NX;
constexpr int NU = NQ;

__device__ inline float cand(float x, float al, float dx) {
  return al == 0.0f ? x : __fadd_rn(x, __fmul_rn(al, dx));
}

__global__ void __launch_bounds__(128) merit_kernel(const gato::MeritArgs a) {
  __shared__ float red[32];
  const int N = a.N;
  const int b = blockIdx.x / a.A;
  const int j = blockIdx.x % a.A;
  const float al = a.alphas[j];
  const float mu = a.mu[b];
  const float* fe = a.fe + b * 6;
  float acc = 0.0f;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    const bool notlast = k < N - 1;
    const size_t row = (size_t)b * N + k;
    const size_t urow = (size_t)b * (N - 1) + k;
    float x[NX], xn[NX], u[NU], r3[3], out[3];
    for (int i = 0; i < NX; ++i) {
      x[i] = cand(a.X[row * NX + i], al, a.dZX[row * NX + i]);
      xn[i] = notlast ? cand(a.X[(row + 1) * NX + i], al, a.dZX[(row + 1) * NX + i])
                      : 0.0f;
    }
    for (int i = 0; i < NU; ++i)
      u[i] = notlast ? cand(a.U[urow * NU + i], al, a.dZU[urow * NU + i]) : 0.0f;
    for (int i = 0; i < 3; ++i) r3[i] = a.ref[row * a.ref_stride + i];
    const float w_track = notlast ? a.w[0] : a.w[3];
    robot::knot_merit<float, float*>(x, x + NQ, u, xn, r3, fe, a.dt, w_track, a.w, out);
    float pen = notlast ? out[2] : 0.0f;
    if (k == 0) {
      float viol = 0.0f;
      for (int i = 0; i < NX; ++i) viol += fabsf(x[i] - a.xs[b * NX + i]);
      pen = pen + viol;
    }
    const float knot = notlast ? out[0] + out[1] : out[0];
    acc += gato::clamp_term(knot + mu * pen);
  }
  const float m = gato::block_sum(acc, red);
  if (threadIdx.x == 0) a.out[(size_t)b * a.A + j] = m;
}

}  // namespace

extern "C" int gato_merit_indy7(const gato::MeritArgs* args, void* stream) {
  const int threads = args->N < 128 ? 32 * ((args->N + 31) / 32) : 128;
  merit_kernel<<<args->B * args->A, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}
