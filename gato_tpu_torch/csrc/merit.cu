// The merit of every line-search candidate X + a dZX, U + a dZU over the
// (problem, alpha) pairs of a batch, one launch.
//
// Compiled once per plant (csrc/robot.cuh), for indy7 and iiwa14: entry
// points gato_merit_<plant>.
//
// Replaces gato_tpu/ops/pallas_merit.py::_merit_knot_kernel (as wrapped by
// merit_alphas_batched_pallas), the merit sweep of the JAX package's staged
// and fused-iteration routes. A knot's candidate (and the next knot's state)
// is formed in registers: the (B, A, N) candidate trajectories that the JAX
// wrapper builds in memory are never written. Each knot's merit is the
// generated knot_merit (tracking weight N_cost on the last knot, whose
// control cost and defect do not count), plus mu (defect + |x_0 - x_s|_1
// at knot 0), clamped to 1e30 as the plain version does
// (ops/merit_fast.py::merit_alphas_batched); the knots' terms are summed in
// a fixed order, without atomics. An alpha of 0 evaluates X itself. The
// candidate is rounded as the plain version rounds it (a product, then a
// sum: no fused multiply-add).
//
// Two variants (ops/cuda_merit.py::merit_alphas_batched_cuda):
//   warps  (the default) a CTA of WARPS_PER_CTA warps, a warp a slot, a
//          lane a knot running the whole knot_merit; up to 32 knots a CTA
//          holds WARPS_PER_CTA pairs, past that a pair takes 2 or all
//          WARPS_PER_CTA slots, each slot every 32 knots in turn; the
//          slots' sums meet in shared memory, each pair's in slot order.
//          __launch_bounds__(128, 4) keeps 128 registers a thread and no
//          spills.
//   one    the earlier kernel, taken only when forced: a block per pair, a
//          thread per knot.
//
// Bound: operations, the straight-line knot_merit (3,174 SSA operations a
// knot and alpha; 147,456 of them at N=32 B=512 A=9) on values already in
// registers; the inputs are read once per alpha from L2. knot_merit
// compiles to about 4,200 instructions a thread (sinf, cosf and logf
// expand), so a warp issues about 4,200 instructions a knot: at one
// instruction a cycle on each of the 528 schedulers that alone takes about
// 0.018 ms at N=32 B=512, near three times the bound that counts an SSA
// operation as one FP32 operation at 67 TFLOP/s. 128 registers a thread
// hold 16 warps an SM, so 4,608 pairs take 2.2 rounds of 2,112 warps. The
// staged split (the mass matrix's CRBA on one warp beside the costs and
// the RNEA bias on another, then the solve) was measured slower at every
// register budget (PERF.md) and is not kept.
#include <cuda_runtime.h>

#include "block_ops.cuh"
#include "robot.cuh"

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

namespace robot = gato::robot;
constexpr int NQ = robot::NQ;
constexpr int NX = robot::NX;
constexpr int NU = NQ;
constexpr int WARPS_PER_CTA = 4;

__device__ inline float cand(float x, float al, float dx) {
  return al == 0.0f ? x : __fadd_rn(x, __fmul_rn(al, dx));
}

// knot k of pair (b, alpha al): its term of the merit sum, as
// ops/merit_fast.py::merit_alphas_batched forms it from knot_merit's (cost,
// ucost, defect) at the candidate: the last knot (tracking weight N_cost)
// counts its state cost only; knot 0 adds |x_0 - x_s|_1 to its defect; mu
// weighs the penalty; the term is clamped to 1e30
__device__ inline float knot_term(const gato::MeritArgs& a, int b, int k, float al) {
  const int N = a.N;
  const bool notlast = k < N - 1;
  const size_t row = (size_t)b * N + k;
  const size_t urow = (size_t)b * (N - 1) + k;
  float x[NX], xn[NX], u[NU], r3[3], out[3];
  for (int i = 0; i < NX; ++i) {
    x[i] = cand(a.X[row * NX + i], al, a.dZX[row * NX + i]);
    xn[i] = notlast ? cand(a.X[(row + 1) * NX + i], al, a.dZX[(row + 1) * NX + i]) : 0.0f;
  }
  for (int i = 0; i < NU; ++i)
    u[i] = notlast ? cand(a.U[urow * NU + i], al, a.dZU[urow * NU + i]) : 0.0f;
  for (int i = 0; i < 3; ++i) r3[i] = a.ref[row * a.ref_stride + i];
  robot::knot_merit<float, float*>(x, x + NQ, u, xn, r3, a.fe + b * 6, a.dt,
                                   notlast ? a.w[0] : a.w[3], a.w, out);
  float pen = notlast ? out[2] : 0.0f;
  if (k == 0) {
    float viol = 0.0f;
    for (int i = 0; i < NX; ++i) viol += fabsf(x[i] - a.xs[b * NX + i]);
    pen = pen + viol;
  }
  const float knot = notlast ? out[0] + out[1] : out[0];
  return gato::clamp_term(knot + a.mu[b] * pen);
}

// ---------------------------------------------------------------- warps --

// pairs_per_cta pairs a CTA, each on slots_per_pair warps (their product is
// WARPS_PER_CTA)
__global__ void __launch_bounds__(32 * WARPS_PER_CTA, 4)
    merit_warps_kernel(const gato::MeritArgs a, int pairs_per_cta, int slots_per_pair) {
  __shared__ float slot_sum[WARPS_PER_CTA];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * pairs_per_cta + warp / slots_per_pair;
  float acc = 0.0f;
  if (pair < a.B * a.A) {
    const int b = pair / a.A;
    const float al = a.alphas[pair % a.A];
    for (int k = (warp % slots_per_pair) * 32 + lane; k < a.N; k += 32 * slots_per_pair)
      acc += knot_term(a, b, k, al);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) slot_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x < pairs_per_cta) {
    const int p = blockIdx.x * pairs_per_cta + threadIdx.x;
    if (p < a.B * a.A) {
      float s = 0.0f;
      for (int i = 0; i < slots_per_pair; ++i) s += slot_sum[threadIdx.x * slots_per_pair + i];
      a.out[p] = s;
    }
  }
}

// ------------------------------------------------------------------ one --

__global__ void __launch_bounds__(128) merit_one_kernel(const gato::MeritArgs a) {
  __shared__ float red[32];
  const int b = blockIdx.x / a.A;
  const float al = a.alphas[blockIdx.x % a.A];
  float acc = 0.0f;
  for (int k = threadIdx.x; k < a.N; k += blockDim.x) acc += knot_term(a, b, k, al);
  const float m = gato::block_sum(acc, red);
  if (threadIdx.x == 0) a.out[blockIdx.x] = m;
}

}  // namespace

// resident CTAs per SM of a variant (1: warps, 0: one), or -1
extern "C" int gato_merit_blocks_per_sm(int variant) {
  int n = 0;
  const cudaError_t err =
      variant == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, merit_warps_kernel,
                                                                   32 * WARPS_PER_CTA, 0)
      : variant == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, merit_one_kernel, 32, 0)
                     : cudaErrorInvalidValue;
  return err == cudaSuccess ? n : -1;
}

// Launch a variant (1: warps, 0: one). A launch that the card refuses
// returns its error; nothing falls back.
extern "C" int GATO_ENTRY(gato_merit)(const gato::MeritArgs* args, int variant, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs = args->B * args->A;
  if (variant == 1) {
    const int chunks = (args->N + 31) / 32;
    const int slots_per_pair = chunks >= WARPS_PER_CTA ? WARPS_PER_CTA : chunks >= 2 ? 2 : 1;
    const int pairs_per_cta = WARPS_PER_CTA / slots_per_pair;
    const int ctas = (pairs + pairs_per_cta - 1) / pairs_per_cta;
    merit_warps_kernel<<<ctas, 32 * WARPS_PER_CTA, 0, st>>>(*args, pairs_per_cta, slots_per_pair);
  } else if (variant == 0) {
    const int threads = args->N < 128 ? 32 * ((args->N + 31) / 32) : 128;
    merit_one_kernel<<<pairs, threads, 0, st>>>(*args);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
