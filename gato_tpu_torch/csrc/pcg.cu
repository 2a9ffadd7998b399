// The whole preconditioned conjugate-gradient loop on an assembled
// block-tridiagonal Schur system: one thread block per problem, one thread
// per knot, N <= 1024.
//
// Replaces gato_tpu/ops/pallas_pcg.py::_pcg_kernel (body pcg_channels), the
// staged route's dual solve. The rules are those of the plain version
// ops/pcg.py::pcg_solve_batched: the counter increments before the exit
// test |r^T z| < 1e-6 + epsilon |r0^T z0|; pAp == 0 and rho == 0 divide by
// 1; a warm start whose residual or preconditioned residual holds a
// non-finite entry does not iterate and reports max_iters; a skipped
// problem reports 0 and keeps its warm start; each knot's partial of a dot
// product is clamped to 1e30 before the sum over knots.
//
// Bound: the loop re-reads the four nx x nx blocks of every knot (S and P,
// main and lower) in each of its two matvecs per iteration. The tensors
// hold each knot's block row-major, so neighbouring threads would read
// addresses nx^2 floats apart; the block first copies its problem's blocks
// into a global scratch in element-major order (element e of knot k at
// e * N + k), so that in the loop a warp reads consecutive addresses. The
// vectors that a matvec reads at the neighbouring knots (r, p) and lam live
// in shared memory; z and Ap stay in each thread's registers. At N = 1024
// that is 3 * 1024 * 12 floats of shared memory (147 KB). The
// launch lasts as long as the problem with the most iterations; tensor
// cores and more threads per knot are left for later work.
#include <cuda_runtime.h>

#include "block_ops.cuh"

namespace gato {

// Arguments of one launch (ops/cuda_pcg.py mirrors it); a named
// namespace, so that the extern "C" entry point keeps external linkage.
struct PcgArgs {
  const float* S_main;   // (B, N, NX, NX)
  const float* S_lower;  // (B, N-1, NX, NX), block (k+1, k) at k
  const float* P_main;
  const float* P_lower;
  const float* gamma;    // (B, N, NX)
  const float* lam0;     // (B, N, NX)
  const float* eps;      // (B,)
  const unsigned char* skip;  // (B,) bool
  float* lam;            // (B, N, NX)
  int* iters;            // (B,)
  float* scratch;        // (B, 4, NX * NX, N)
  int B;
  int N;
  int max_iters;
};

}  // namespace gato

namespace {

using gato::block_sum;
using gato::clamp_term;
constexpr int NX = 12;  // indy7, the only plant with generated CUDA dynamics

// y_k = main_k x_k + lower_{k-1} x_{k-1} + lower_k^T x_{k+1}, the order of
// ops/schur.py::btd_matvec; M, L are knot k's element-major blocks (stride
// N between elements), Lp knot k-1's.
template <int UNROLL>
__device__ void knot_matvec(const float* M, const float* Lp, const float* L,
                            int N, int k, const float* x, float* y) {
  const float* xk = x + k * NX;
#pragma unroll (UNROLL)
  for (int r = 0; r < NX; ++r) {
    float acc = 0.0f;
    for (int c = 0; c < NX; ++c) acc += M[(r * NX + c) * N] * xk[c];
    float t1 = 0.0f;
    if (k > 0)
      for (int c = 0; c < NX; ++c) t1 += Lp[(r * NX + c) * N] * xk[c - NX];
    float t2 = 0.0f;
    if (k < N - 1)
      for (int c = 0; c < NX; ++c) t2 += L[(c * NX + r) * N] * xk[NX + c];
    y[r] = acc + t1 + t2;
  }
}

template <int UNROLL>
__device__ bool all_finite(const float* v) {
  bool ok = true;
#pragma unroll (UNROLL)
  for (int i = 0; i < NX; ++i) ok = ok && isfinite(v[i]);
  return ok;
}

template <int UNROLL>
__device__ float dot_clamped(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll (UNROLL)
  for (int i = 0; i < NX; ++i) s += a[i] * b[i];
  return clamp_term(s);
}

// MAX_THREADS bounds the block, and so the registers a thread may hold:
// 255 up to 256 threads, 128 at 512, 64 at 1024. Up to 512 threads the
// loops over a knot's NX entries are unrolled so that z and Ap stay in
// registers; at 1024 they are not, and z and Ap live in local memory
// rather than spilling the unrolled matvec.
template <int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS) pcg_kernel(const gato::PcgArgs a) {
  constexpr int E = NX * NX;
  constexpr int U = MAX_THREADS <= 512 ? NX : 1;
  extern __shared__ float smem[];
  const int N = a.N;
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const bool on = k < N;
  float* sLam = smem;         // (N, NX)
  float* sR = sLam + N * NX;  // (N, NX)
  float* sP = sR + N * NX;    // (N, NX)
  float* red = sP + N * NX;   // 32 warp partials

  // element-major copies of the four matrices: scratch[((b*4 + m)*E + e)*N + k]
  float* sc = a.scratch + (size_t)b * 4 * E * N;
  const float* src[4] = {a.S_main + (size_t)b * N * E,
                         a.S_lower + (size_t)b * (N - 1) * E,
                         a.P_main + (size_t)b * N * E,
                         a.P_lower + (size_t)b * (N - 1) * E};
  for (int m = 0; m < 4; ++m) {
    const int knots = (m & 1) ? N - 1 : N;
    for (int i = k; i < knots * E; i += blockDim.x)
      sc[((size_t)m * E + i % E) * N + i / E] = src[m][i];
  }
  const float* Sm = sc + k;
  const float* Sl = sc + (size_t)E * N + k;
  const float* Pm = sc + (size_t)2 * E * N + k;
  const float* Pl = sc + (size_t)3 * E * N + k;

  float z[NX], Ap[NX];
  if (on)
    for (int i = 0; i < NX; ++i)
      sLam[k * NX + i] = a.lam0[((size_t)b * N + k) * NX + i];
  __syncthreads();
  if (on) {
    knot_matvec<U>(Sm, Sl - 1, Sl, N, k, sLam, Ap);
#pragma unroll (U)
    for (int i = 0; i < NX; ++i)
      sR[k * NX + i] = a.gamma[((size_t)b * N + k) * NX + i] - Ap[i];
  }
  __syncthreads();
  bool bad_local = false;
  if (on) {
    knot_matvec<U>(Pm, Pl - 1, Pl, N, k, sR, z);
#pragma unroll (U)
    for (int i = 0; i < NX; ++i) sP[k * NX + i] = z[i];
    bad_local = !(all_finite<U>(sR + k * NX) && all_finite<U>(z));
  }
  float rho = block_sum(on ? dot_clamped<U>(sR + k * NX, z) : 0.0f, red);
  const bool bad = __syncthreads_or(bad_local);
  const bool skip = a.skip[b] != 0;
  const bool dead0 = !skip && bad;
  const float rho_init = fabsf(rho);
  const float eps = a.eps[b];
  bool active = !skip && !dead0 && fabsf(rho) >= gato::PCG_ABS_TOL;
  int iters = 0;
  for (int it = 0; it < a.max_iters && active; ++it) {
    ++iters;
    if (on) knot_matvec<U>(Sm, Sl - 1, Sl, N, k, sP, Ap);
    const float pAp = block_sum(on ? dot_clamped<U>(sP + k * NX, Ap) : 0.0f, red);
    const float alpha = rho / (pAp == 0.0f ? 1.0f : pAp);
    if (on)
#pragma unroll (U)
      for (int i = 0; i < NX; ++i) {
        sLam[k * NX + i] += alpha * sP[k * NX + i];
        sR[k * NX + i] -= alpha * Ap[i];
      }
    __syncthreads();
    if (on) knot_matvec<U>(Pm, Pl - 1, Pl, N, k, sR, z);
    const float rho_new =
        block_sum(on ? dot_clamped<U>(sR + k * NX, z) : 0.0f, red);
    const bool converged = fabsf(rho_new) < gato::PCG_ABS_TOL + eps * rho_init;
    const float beta = rho_new / (rho == 0.0f ? 1.0f : rho);
    if (converged) {
      active = false;
    } else {
      if (on)
#pragma unroll (U)
        for (int i = 0; i < NX; ++i) sP[k * NX + i] = z[i] + beta * sP[k * NX + i];
      rho = rho_new;
    }
    __syncthreads();
  }
  if (dead0) iters = a.max_iters;
  if (on)
    for (int i = 0; i < NX; ++i) a.lam[((size_t)b * N + k) * NX + i] = sLam[k * NX + i];
  if (k == 0) a.iters[b] = iters;
}

template <int MAX_THREADS>
int launch(const gato::PcgArgs* a, void* stream) {
  const int threads = 32 * ((a->N + 31) / 32);
  const size_t smem = sizeof(float) * (3 * (size_t)a->N * NX + 32);
  cudaError_t err = cudaFuncSetAttribute(pcg_kernel<MAX_THREADS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pcg_kernel<MAX_THREADS>
      <<<a->B, threads, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int launch_for_n(const gato::PcgArgs* a, void* stream) {
  if (a->N <= 128) return launch<128>(a, stream);
  if (a->N <= 256) return launch<256>(a, stream);
  if (a->N <= 512) return launch<512>(a, stream);
  return launch<1024>(a, stream);
}

}  // namespace

// Another nx than NX returns cudaErrorInvalidValue.
extern "C" int gato_pcg(const gato::PcgArgs* args, int nx, void* stream) {
  if (nx != NX) return static_cast<int>(cudaErrorInvalidValue);
  return launch_for_n(args, stream);
}
