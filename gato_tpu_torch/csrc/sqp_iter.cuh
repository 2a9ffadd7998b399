// One SQP iteration of the batched solve, one thread block per problem: the
// body shared by csrc/bsqp_iter.cu (the whole iteration, kLineSearch = true)
// and csrc/iter.cu (phases A-E only, kLineSearch = false). Phases, separated
// by barriers:
//   A  KKT: thread k calls the generated knot_kkt (dynamics linearization by
//      sparse duals, defect, cost gradient/Hessian; the tracking weight is
//      N_cost on the last knot) and inverts its Q~ blocks (Cholesky of the
//      NQ x NQ qq block + rho I, reciprocal of the diagonal qd block and of
//      R). With kStaged (indy7's shared layout at G = 4) the G threads of knot k
//      compute the KKT blocks in the stages of csrc/kkt_stages.cuh instead
//      (qdd and Minv staged in the PCG vectors' shared memory, idle until
//      phase D), thread k of group 0 inverts the Q~ blocks, and group g
//      computes rows [3g, 3g + 3) of phi_k;
//   B  Schur: theta_k, gamma_{k+1}, S_main_{k+1} = -theta_k and the SS
//      preconditioner block -(theta_k + rho I~)^-1 (NX x NX Cholesky); with
//      kStaged group g computes rows g, 7 - g, 8 + g of theta (from the
//      diagonal on, both triangles stored) and gamma, then, after a
//      barrier, factors theta + rho I~ itself and solves columns [3g, 3g +
//      3) of the inverse;
//   C  P_lower_k = -(P_main_{k+1} phi_k P_main_k); with kStaged, rows
//      [3g, 3g + 3) on group g. Every entry is computed in the one-thread
//      order, so the split changes no value;
//   D  block PCG on the block-tridiagonal Schur system (below);
//   E  dz recovery; with kLineSearch the per-problem step_ok scrub of
//      non-finite steps, without it dz, lam and the PCG count are written
//      out as they are (the caller scrubs, as the JAX package's after_solve
//      does);
//   F  merit at alpha = 0 (built from X itself) and alpha = 2^-j: thread k
//      evaluates the generated knot_merit, a block sum per alpha;
//   G  thread 0 runs the line search and the rho schedule; every thread
//      writes its knot back.
// F and G run only with kLineSearch.
//
// The block is G groups of W = 32 ceil(N / 32) threads: thread t handles
// knot k = t mod W in group g = t / W. Phases A-C and E-G run on group 0
// alone (its first ceil(N / 32) warps), one thread per knot, except where
// kStaged spreads them as above; the other groups join phase D and the
// barriers.
//
// The plant is the one the library is compiled for (csrc/robot.cuh: NQ, NX
// and the generated functions of gato::robot); the sizes below are indy7's
// (NX = 12) where they are numbers. iiwa14 (NX = 14) has no staged KKT
// (its header defines no GATO_KKT_STAGES): its phase A is the one-thread
// knot_kkt in every variant, and its shared layout takes G in {1, 2, 7},
// the G that divide its 14 rows with G W <= MAX_THREADS.
//
// Phase D comes in two layouts (the template parameter kBlocks):
//   kShared  phases A-C write the problem's four NX x NX blocks per knot
//            (S_main, phi = S_lower, P_main, P_lower: 2,304 bytes a knot)
//            into dynamic shared memory, element-major (element e of knot k
//            at e N + k, so a warp's consecutive knots hit consecutive
//            banks), and the Krylov loop reads them from there. Group g
//            computes rows [NX g/G, NX (g+1)/G) of its knot in each matvec and
//            vector update, keeping lam, r, p, z and Ap of those rows in
//            registers; r and p go to shared memory (element-major) for the
//            neighbours' matvecs. A row sums main, then lower, then upper
//            (as kGlobal does), so its value is kGlobal's bit for bit; a dot
//            product sums each group's rows, then the G partials in order,
//            clamps the knot's term and sums the knots, so its order differs
//            from kGlobal's when G > 1 or N > 32. Four barriers an iteration,
//            the ones the data needs (r and p complete before a matvec reads
//            a neighbour's rows, the partials complete before a dot's sum);
//            a block of one warp syncs with __syncwarp and sums with
//            shuffles. It fits 232,448 bytes up to N = 86 for indy7 and
//            N = 64 for iiwa14 (3,136 bytes a knot, 230,600 bytes at G = 2);
//            ops/cuda_iter.py takes it up to N = 64 for both.
//   kGlobal  one thread per knot (G = 1); the blocks stay in the
//            element-major global scratch and the loop re-reads them every
//            iteration (the layout for 64 < N <= 128).
// Both keep the semantics of pallas_pcg: the counter increments before the
// convergence test, a non-finite warm start reports max_pcg_iters without
// iterating, |rho| < PCG_ABS_TOL skips the loop, per-knot terms are clamped
// to 1e30.
#pragma once
#include <cuda_runtime.h>

#include "block_ops.cuh"
#include "krylov.cuh"
#include "robot.cuh"
#ifdef GATO_KKT_STAGES
#include "kkt_stages.cuh"
#endif

namespace gato {

// Arguments of one launch (ops/cuda_iter.py::_IterArgs mirrors it). The
// line-search fields are read and written only by bsqp_iter, dzx_o/dzu_o
// only by iter.
struct IterArgs {
  const float* X;      // (B, N, NX)
  const float* U;      // (B, N-1, NU)
  const float* lam;    // (B, N, NX)
  const float* xs;     // (B, NX)
  const float* ref;    // (B, N, ref_stride), xyz first
  const float* fe;     // (B, 6)
  const float* rho;    // (B,)
  const float* drho;
  const float* mu;
  const float* eps;    // per-problem PCG relative tolerance
  const float* mbase;  // carried baseline merit
  const float* merit0;
  const float* conv;   // 1.0 once a problem's PCG needed 0 iterations
  const float* sqp;    // per-problem SQP iteration count
  float* X_o;
  float* U_o;
  float* lam_o;
  float* rho_o;
  float* drho_o;
  float* mbase_o;
  float* merit0_o;
  float* conv_o;
  float* sqp_o;
  float* ls_merit;
  float* ls_step;
  int* pcg_iters;
  float* scratch;      // (KNOT_FLOATS, B, N)
  float* dzx_o;        // (B, N, NX)
  float* dzu_o;        // (B, N-1, NU)
  int B;
  int N;
  int ref_stride;
  int max_pcg_iters;
  int num_alphas;
  int adapt_rho;
  int seeded;
  float dt;
  float w[7];          // CostParams order
};

// Where phase D reads the Schur and preconditioner blocks (the layout
// argument of the entry points: 0 global, 1 shared).
enum class Blocks { kGlobal = 0, kShared = 1 };

namespace iter_detail {

using krylov::btd_rows;
using krylov::knot_total;
using krylov::rows_dot;
constexpr int NQ = robot::NQ;
constexpr int NX = robot::NX;
constexpr int NU = NQ;
constexpr int BLK = NX * NX;
constexpr int MAX_ALPHAS = 16;
constexpr float RHO_INIT = 1e-3f;
constexpr float RHO_FACTOR = 1.2f;
constexpr float RHO_MIN = 1e-8f;
constexpr float RHO_MAX = 10.0f;

// per-knot scratch, element offsets (element-major: see Knot)
constexpr int E_A = 0;                 // A (NX, NX)
constexpr int E_B = E_A + NX * NX;     // B (NX, NU)
constexpr int E_C = E_B + NX * NU;     // defect c_{k+1} (NX)
constexpr int E_Q = E_C + NX;          // Q (NX, NX)
constexpr int E_QV = E_Q + NX * NX;    // q (NX)
constexpr int E_RD = E_QV + NX;        // R diagonal (NU)
constexpr int E_RV = E_RD + NU;        // r (NU)
constexpr int E_IQQ = E_RV + NU;       // (Q_qq + rho I)^-1 (NQ, NQ)
constexpr int E_IDQ = E_IQQ + NQ * NQ; // 1 / Q_dd (NQ)
constexpr int E_RI = E_IDQ + NQ;       // 1 / R (NU)
constexpr int E_PHI = E_RI + NU;       // phi_k = A_k Qinv_k = S_lower_k
constexpr int E_SM = E_PHI + NX * NX;  // S_main_k
constexpr int E_PM = E_SM + NX * NX;   // P_main_k
constexpr int E_PL = E_PM + NX * NX;   // P_lower_k (block (k+1, k))
constexpr int E_G = E_PL + NX * NX;    // gamma_k
constexpr int KNOT_FLOATS = E_G + NX;

// the four blocks of phase D, contiguous in the scratch from E_PHI on, and
// in that order in shared memory in the kShared layout: offsets from E_PHI
constexpr int SB_PHI = 0, SB_SM = BLK, SB_PM = 2 * BLK, SB_PL = 3 * BLK;
constexpr int SB_FLOATS = 4 * BLK;

constexpr int MAX_THREADS = 256;  // G W, so that 255 registers a thread fit an SM

__host__ __device__ inline int warp_threads(int N) { return 32 * ((N + 31) / 32); }

// dynamic shared memory of one block at horizon N, in bytes: X, U, lam, the
// PCG vectors r, p, z, Ap, dz, 32 warp partials, the merits and the line
// search's two words; kShared adds the four blocks of every knot and two
// buffers of one partial per thread (ops/cuda_iter.py::smem_bytes mirrors it)
inline size_t smem_bytes(int N, Blocks layout, int G) {
  size_t f = (size_t)N * (7 * NX + 2 * NU) + 32 + MAX_ALPHAS + 2;
  if (layout == Blocks::kShared) f += (size_t)SB_FLOATS * N + 2 * (size_t)G * warp_threads(N);
  return sizeof(float) * f;
}

// One knot's scratch slots: element e of knot k of problem b lives at
// scratch[(e * B + b) * N + k], so a warp's threads (consecutive knots)
// touch consecutive addresses.
struct Knot {
  float* base;
  int stride;
  __device__ float& operator[](int e) const { return base[(size_t)e * stride]; }
  __device__ Knot at(int e) const { return Knot{base + (size_t)e * stride, stride}; }
};

// Cholesky inverse of an SPD n x n matrix M (row-major, read through get),
// in the order of gato_tpu's ch_chol_factor_n / ch_chol_solve_n: columns
// [c0, c1) of it, each solved in the same order whatever the range.
template <int n, typename Get, typename Put>
__device__ void chol_inv(Get get, Put put, int c0 = 0, int c1 = n) {
  float L[n][n];
  float inv_d[n];
  for (int j = 0; j < n; ++j) {
    float s = 0.0f;
    for (int k = 0; k < j; ++k) s += L[j][k] * L[j][k];
    const float Ld = sqrtf(get(j, j) - s);
    L[j][j] = Ld;
    inv_d[j] = 1.0f / Ld;
    for (int i = j + 1; i < n; ++i) {
      float t = 0.0f;
      for (int k = 0; k < j; ++k) t += L[i][k] * L[j][k];
      L[i][j] = (get(i, j) - t) * inv_d[j];
    }
  }
  for (int c = c0; c < c1; ++c) {
    float y[n], x[n];
    for (int i = 0; i < n; ++i) {
      float s = (i == c) ? 1.0f : 0.0f;
      for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
      y[i] = s * inv_d[i];
    }
    for (int i = n - 1; i >= 0; --i) {
      float s = y[i];
      for (int k = i + 1; k < n; ++k) s -= L[k][i] * x[k];
      x[i] = s * inv_d[i];
    }
    for (int r = 0; r < n; ++r) put(r, c, x[r]);
  }
}

// Q~^-1 entry (r, c) of a knot: dense qq block, diagonal qd block
__device__ inline float qinv(const Knot& K, int r, int c) {
  if (r < NQ && c < NQ) return K[E_IQQ + r * NQ + c];
  if (r == c) return K[E_IDQ + r - NQ];
  return 0.0f;
}

// y_k = main_k x_k + lower_{k-1} x_{k-1} + lower_k^T x_{k+1} (pallas_pcg
// _matvec order) for the block-tridiagonal matrix stored at (em, el)
__device__ inline void btd_matvec(const Knot& K, const Knot& Kp, int k, int N,
                                  int em, int el, const float* x, float* y) {
  const float* xk = x + k * NX;
  for (int r = 0; r < NX; ++r) {
    float acc = 0.0f;
    for (int c = 0; c < NX; ++c) acc += K[em + r * NX + c] * xk[c];
    float t1 = 0.0f;
    if (k > 0)
      for (int c = 0; c < NX; ++c) t1 += Kp[el + r * NX + c] * xk[c - NX];
    float t2 = 0.0f;
    if (k < N - 1)
      for (int c = 0; c < NX; ++c) t2 += K[el + c * NX + r] * xk[NX + c];
    y[k * NX + r] = acc + t1 + t2;
  }
}

// row r of phi_k = A_k Q~_k^-1 (right factor block-diagonal)
__device__ inline void phi_row(const Knot& K, const Knot& Kb, int r) {
  for (int c = 0; c < NQ; ++c) {
    float s = 0.0f;
    for (int j = 0; j < NQ; ++j) s += K[E_A + r * NX + j] * K[E_IQQ + j * NQ + c];
    Kb[SB_PHI + r * NX + c] = s;
  }
  for (int c = NQ; c < NX; ++c) Kb[SB_PHI + r * NX + c] = K[E_A + r * NX + c] * K[E_IDQ + c - NQ];
}

// theta_k entry (r, s) = phi_k A_k^T + B_k R_k^-1 B_k^T + Q~_{k+1}^-1
__device__ inline float theta_entry(const Knot& K, const Knot& Kn, const Knot& Kb, int r,
                                    int s) {
  float t = 0.0f;
  for (int c = 0; c < NX; ++c) t += Kb[SB_PHI + r * NX + c] * K[E_A + s * NX + c];
  float u = 0.0f;
  for (int c = 0; c < NU; ++c) u += K[E_B + r * NU + c] * K[E_RI + c] * K[E_B + s * NU + c];
  t = t + u;
  return t + qinv(Kn, r, s);
}

// gamma_{k+1} row r = c_k - Q~_{k+1}^-1 q_{k+1} + phi_k q_k + B R^-1 r_k
__device__ inline float gamma_row(const Knot& K, const Knot& Kn, const Knot& Kb, int r) {
  float qq = 0.0f;
  for (int c = 0; c < NX; ++c)
    if (r < NQ ? c < NQ : c == r) qq += qinv(Kn, r, c) * Kn[E_QV + c];
  float t1 = 0.0f;
  for (int c = 0; c < NX; ++c) t1 += Kb[SB_PHI + r * NX + c] * K[E_QV + c];
  float t2 = 0.0f;
  for (int c = 0; c < NU; ++c) t2 += K[E_B + r * NU + c] * K[E_RI + c] * K[E_RV + c];
  return (K[E_C + r] - qq) + (t1 + t2);
}

__device__ inline float knot_dot(const float* a, const float* b, int k) {
  float s = 0.0f;
  for (int i = 0; i < NX; ++i) s += a[k * NX + i] * b[k * NX + i];
  return clamp_term(s);
}

}  // namespace iter_detail

template <bool kLineSearch, Blocks kBlocks, int G, bool kStaged>
__device__ __forceinline__ void sqp_iteration(const IterArgs& a) {
  using namespace iter_detail;
  static_assert(kBlocks == Blocks::kShared || G == 1,
                "the global layout runs one thread per knot");
  static_assert(!kStaged || (kBlocks == Blocks::kShared && G == 4),
                "the staged KKT takes the shared layout's G = 4 groups");
  static_assert(!kStaged || NX == 12, "the staged phases split 12 rows in 4");
  static_assert(NX % G == 0, "a group takes NX / G rows");
  extern __shared__ float smem[];
  const int N = a.N;
  const int W = warp_threads(N);
  const int b = blockIdx.x;
  const int g = G == 1 ? 0 : (int)threadIdx.x / W;
  const int k = (int)threadIdx.x - g * W;
  const bool lead = threadIdx.x == 0;
  const bool on = g == 0 && k < N;  // one thread per knot: phases A-C, E-G
  const bool notlast = on && k < N - 1;

  float* sX = smem;               // (N, NX) trajectory
  float* sU = sX + N * NX;        // (N, NU) controls (row N-1 unused)
  float* sLam = sU + N * NU;      // PCG vectors (N, NX) each
  float* sR = sLam + N * NX;
  float* sP = sR + N * NX;
  float* sZ = sP + N * NX;
  float* sAp = sZ + N * NX;
  float* sDX = sAp + N * NX;      // dz (N, NX), (N, NU)
  float* sDU = sDX + N * NX;
  float* red = sDU + N * NU;      // 32 warp partials
  float* sMerit = red + 32;       // merit per alpha
  float* sLS = sMerit + MAX_ALPHAS;  // [success, alpha]
  float* sBlk = sLS + 2;          // kShared: (SB_FLOATS, N) blocks
  float* part = sBlk + SB_FLOATS * N;  // kShared: 2 x (G, W) dot partials

  const size_t stride = (size_t)a.B * N;
  const Knot K{a.scratch + (size_t)b * N + k, (int)stride};
  const Knot Kp{a.scratch + (size_t)b * N + k - 1, (int)stride};  // knot k-1
  const Knot Kn{a.scratch + (size_t)b * N + k + 1, (int)stride};  // knot k+1
  // the four blocks of knot k (Kb) and k+1 (Kbn), offsets SB_*: in shared
  // memory (kShared), so that phases A-C write them where phase D reads
  // them, or in the scratch slots from E_PHI on (kGlobal)
  const Knot Kb = kBlocks == Blocks::kShared ? Knot{sBlk + k, N} : K.at(E_PHI);
  const Knot Kbn = kBlocks == Blocks::kShared ? Knot{sBlk + k + 1, N} : Kn.at(E_PHI);

  const float rho = a.rho[b];
  const float* fe = a.fe + b * 6;
  const float* xs = a.xs + b * NX;
  float r3[3] = {0.0f, 0.0f, 0.0f};
  if (kStaged ? k < N : on)
    for (int i = 0; i < 3; ++i) r3[i] = a.ref[((size_t)b * N + k) * a.ref_stride + i];
  const float w_track = (k == N - 1) ? a.w[3] : a.w[0];

  if (on) {
    for (int i = 0; i < NX; ++i) sX[k * NX + i] = a.X[((size_t)b * N + k) * NX + i];
    for (int i = 0; i < NU; ++i)
      sU[k * NU + i] = notlast ? a.U[((size_t)b * (N - 1) + k) * NU + i] : 0.0f;
    for (int i = 0; i < NX; ++i) sLam[k * NX + i] = a.lam[((size_t)b * N + k) * NX + i];
  }
  __syncthreads();

  // ---- A: KKT blocks and Q~^-1, R^-1 of knot k ----
#ifdef GATO_KKT_STAGES
  if constexpr (kStaged) {
    // qdd and Minv of knot k in the PCG vectors (sR on), idle until phase D
    static_assert(kkt_stages::DYN_FLOATS <= 4 * NX, "qdd and Minv fit r, p, z, Ap");
    float* dyn = sR + k * kkt_stages::DYN_FLOATS;
    const float* x = sX + k * NX;
    const float* u = sU + k * NU;
    if (k < N && g == 0) {
      robot::knot_dyn<float, float*>(x, x + NQ, u, fe, dyn, dyn + NQ);
    } else if (k < N && g == 1) {
      robot::knot_cost<float, Knot>(x, x + NQ, u, r3, w_track, a.w, K.at(E_Q), K.at(E_QV),
                                    K.at(E_RD), K.at(E_RV));
    }
    __syncthreads();
    if (k < N) {
      kkt_stages::tangent_part<G, Knot>(g, x, x + NQ, dyn, fe, a.dt, K.at(E_A), K.at(E_B));
      // the last knot's defect is never read: its own x stands in for x_next
      if (g == G - 1)
        robot::knot_defect<float, Knot>(x, x + NQ, sX + (k < N - 1 ? k + 1 : k) * NX, dyn,
                                        a.dt, K.at(E_C));
    }
    __syncthreads();
  }
#else
  static_assert(!kStaged, "the plant has no staged KKT (GATO_KKT_STAGES)");
#endif
  if (on) {
    if constexpr (!kStaged) {
      float xn[NX];
      for (int i = 0; i < NX; ++i) xn[i] = notlast ? sX[(k + 1) * NX + i] : 0.0f;
      const float* x = sX + k * NX;
      robot::knot_kkt<float, Knot>(x, x + NQ, sU + k * NU, xn, r3, fe, a.dt,
                                   w_track, a.w, K.at(E_A), K.at(E_B), K.at(E_C),
                                   K.at(E_Q), K.at(E_QV), K.at(E_RD), K.at(E_RV));
    }
    chol_inv<NQ>(
        [&](int r, int c) { return K[E_Q + r * NX + c] + (r == c ? rho : 0.0f); },
        [&](int r, int c, float v) { K[E_IQQ + r * NQ + c] = v; });
    for (int i = 0; i < NQ; ++i) K[E_IDQ + i] = 1.0f / K[E_Q + (NQ + i) * NX + NQ + i];
    for (int i = 0; i < NU; ++i) K[E_RI + i] = 1.0f / K[E_RD + i];
    if constexpr (!kStaged)
      for (int r = 0; r < NX; ++r) phi_row(K, Kb, r);
    if (k == 0) {
      // S_main_0 = -Q~_0^-1; P_main_0 = -Q~_0 (not its inverse: reference
      // quirk); gamma_0 = c_0 - Q~_0^-1 q_0 with c_0 = x_0 - x_s
      for (int r = 0; r < NX; ++r) {
        float qq = 0.0f;
        for (int c = 0; c < NX; ++c) {
          Kb[SB_SM + r * NX + c] = -qinv(K, r, c);
          Kb[SB_PM + r * NX + c] =
              -(K[E_Q + r * NX + c] + ((r == c && r < NQ) ? rho : 0.0f));
          if (r < NQ ? c < NQ : c == r) qq += qinv(K, r, c) * K[E_QV + c];
        }
        K[E_G + r] = (sX[r] - xs[r]) - qq;
      }
    }
  }
  // kStaged: rows [3g, 3g + 3) of phi, of P_lower and of P_main's
  // columns on group g
  const int r0 = 3 * g;
  if constexpr (kStaged) {
    __syncthreads();
    if (k < N)
      for (int r = r0; r < r0 + 3; ++r) phi_row(K, Kb, r);
  }
  __syncthreads();

  // ---- B: theta_k -> S_main_{k+1}, gamma_{k+1}, P_main_{k+1} ----
  if constexpr (kStaged) {
    // rows g, 7 - g, 8 + g: 21, 20, 19, 18 entries of theta's upper triangle
    if (k < N - 1)
      for (int i = 0; i < 3; ++i) {
        const int r = i == 0 ? g : (i == 1 ? 7 - g : 8 + g);
        for (int s = r; s < NX; ++s) {
          const float t = theta_entry(K, Kn, Kb, r, s);
          Kbn[SB_SM + r * NX + s] = -t;
          Kbn[SB_SM + s * NX + r] = -t;
        }
        Kn[E_G + r] = gamma_row(K, Kn, Kb, r);
      }
    __syncthreads();
    if (k < N - 1)
      chol_inv<NX>(
          [&](int r, int c) {
            return -Kbn[SB_SM + r * NX + c] + ((r == c && r < NQ) ? rho : 0.0f);
          },
          [&](int r, int c, float v) { Kbn[SB_PM + r * NX + c] = -v; }, r0, r0 + 3);
  } else if (notlast) {
    float theta[NX][NX];
    for (int r = 0; r < NX; ++r)
      for (int s = r; s < NX; ++s) theta[r][s] = theta[s][r] = theta_entry(K, Kn, Kb, r, s);
    for (int r = 0; r < NX; ++r) {
      for (int s = 0; s < NX; ++s) Kbn[SB_SM + r * NX + s] = -theta[r][s];
      Kn[E_G + r] = gamma_row(K, Kn, Kb, r);
    }
    chol_inv<NX>(
        [&](int r, int c) { return theta[r][c] + ((r == c && r < NQ) ? rho : 0.0f); },
        [&](int r, int c, float v) { Kbn[SB_PM + r * NX + c] = -v; });
  }
  __syncthreads();

  // ---- C: P_lower_k = -(P_main_{k+1} phi_k P_main_k) ----
  if (kStaged ? k < N - 1 : notlast) {
    for (int r = kStaged ? r0 : 0; r < (kStaged ? r0 + 3 : NX); ++r) {
      float T[NX];
      for (int c = 0; c < NX; ++c) {
        float s = 0.0f;
        for (int j = 0; j < NX; ++j) s += Kbn[SB_PM + r * NX + j] * Kb[SB_PHI + j * NX + c];
        T[c] = s;
      }
      for (int c = 0; c < NX; ++c) {
        float s = 0.0f;
        for (int j = 0; j < NX; ++j) s += T[j] * Kb[SB_PM + j * NX + c];
        Kb[SB_PL + r * NX + c] = -s;
      }
    }
  }
  __syncthreads();

  // ---- D: PCG on S lam = gamma, preconditioner P (pcg_channels) ----
  const bool skip = a.conv[b] > 0.5f;
  const float eps = a.eps[b];
  bool dead0;
  int iters = 0;
  if constexpr (kBlocks == Blocks::kGlobal) {
    if (on) {
      btd_matvec(K, Kp, k, N, E_SM, E_PHI, sLam, sAp);
      for (int i = 0; i < NX; ++i) sR[k * NX + i] = K[E_G + i] - sAp[k * NX + i];
    }
    __syncthreads();
    if (on) btd_matvec(K, Kp, k, N, E_PM, E_PL, sR, sZ);
    __syncthreads();
    bool bad_local = false;
    if (on) {
      for (int i = 0; i < NX; ++i) sP[k * NX + i] = sZ[k * NX + i];
      bad_local = !(finite_vec(sR + k * NX, NX) && finite_vec(sZ + k * NX, NX));
    }
    float rho_c = block_sum(on ? knot_dot(sR, sZ, k) : 0.0f, red);
    const bool bad = __syncthreads_or(bad_local);
    dead0 = !skip && bad;
    const float rho_init = fabsf(rho_c);
    bool active = !skip && !dead0 && fabsf(rho_c) >= PCG_ABS_TOL;
    for (int it = 0; it < a.max_pcg_iters && active; ++it) {
      ++iters;
      if (on) btd_matvec(K, Kp, k, N, E_SM, E_PHI, sP, sAp);
      __syncthreads();
      const float pAp = block_sum(on ? knot_dot(sP, sAp, k) : 0.0f, red);
      const float alpha = rho_c / (pAp == 0.0f ? 1.0f : pAp);
      if (on)
        for (int i = 0; i < NX; ++i) {
          sLam[k * NX + i] += alpha * sP[k * NX + i];
          sR[k * NX + i] -= alpha * sAp[k * NX + i];
        }
      __syncthreads();
      if (on) btd_matvec(K, Kp, k, N, E_PM, E_PL, sR, sZ);
      __syncthreads();
      const float rho_new = block_sum(on ? knot_dot(sR, sZ, k) : 0.0f, red);
      const bool converged = fabsf(rho_new) < PCG_ABS_TOL + eps * rho_init;
      const float beta = rho_new / (rho_c == 0.0f ? 1.0f : rho_c);
      if (converged) {
        active = false;
      } else {
        if (on)
          for (int i = 0; i < NX; ++i) sP[k * NX + i] = sZ[k * NX + i] + beta * sP[k * NX + i];
        rho_c = rho_new;
      }
      __syncthreads();
    }
  } else {
    // phases A-C left the four blocks in sBlk
    constexpr int R = NX / G;
    const int r0 = g * R;
    const bool in = k < N;  // every group's thread of a knot
    const bool one_warp = G == 1 && W == 32;
    float* partA = part;
    float* partB = part + G * W;
    // r and p element-major: a warp's neighbours on consecutive banks
    auto rvec = [&](int kk, int c) { return sR[c * N + kk]; };
    auto pvec = [&](int kk, int c) { return sP[c * N + kk]; };
    auto sync = [&]() {
      if (one_warp)
        __syncwarp();
      else
        __syncthreads();
    };
    float lam_r[R], r_r[R], p_r[R], z_r[R], ap_r[R];
    if (in) {
      btd_rows<NX, R>(sBlk, N, k, r0, SB_SM, SB_PHI,
                  [&](int kk, int c) { return sLam[kk * NX + c]; }, ap_r);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        lam_r[i] = sLam[k * NX + r0 + i];
        r_r[i] = K[E_G + r0 + i] - ap_r[i];
        sR[(r0 + i) * N + k] = r_r[i];
      }
    }
    sync();
    bool bad_local = false;
    if (in) {
      btd_rows<NX, R>(sBlk, N, k, r0, SB_PM, SB_PL, rvec, z_r);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        p_r[i] = z_r[i];
        sP[(r0 + i) * N + k] = p_r[i];
        bad_local = bad_local || !(isfinite(r_r[i]) && isfinite(z_r[i]));
      }
    }
    float rho_c = knot_total<G>(in ? rows_dot(r_r, z_r) : 0.0f, partB, W, N, k, g, one_warp);
    const bool bad = __syncthreads_or(bad_local);
    dead0 = !skip && bad;
    const float rho_init = fabsf(rho_c);
    bool active = !skip && !dead0 && fabsf(rho_c) >= PCG_ABS_TOL;
    for (int it = 0; it < a.max_pcg_iters && active; ++it) {
      ++iters;
      if (in) btd_rows<NX, R>(sBlk, N, k, r0, SB_SM, SB_PHI, pvec, ap_r);
      const float pAp = knot_total<G>(in ? rows_dot(p_r, ap_r) : 0.0f, partA, W, N, k, g,
                                      one_warp);
      const float alpha = rho_c / (pAp == 0.0f ? 1.0f : pAp);
      if (in)
#pragma unroll
        for (int i = 0; i < R; ++i) {
          lam_r[i] += alpha * p_r[i];
          r_r[i] -= alpha * ap_r[i];
          sR[(r0 + i) * N + k] = r_r[i];
        }
      sync();
      if (in) btd_rows<NX, R>(sBlk, N, k, r0, SB_PM, SB_PL, rvec, z_r);
      const float rho_new = knot_total<G>(in ? rows_dot(r_r, z_r) : 0.0f, partB, W, N, k, g,
                                          one_warp);
      const bool converged = fabsf(rho_new) < PCG_ABS_TOL + eps * rho_init;
      const float beta = rho_new / (rho_c == 0.0f ? 1.0f : rho_c);
      if (converged) {
        active = false;
      } else {
        if (in)
#pragma unroll
          for (int i = 0; i < R; ++i) {
            p_r[i] = z_r[i] + beta * p_r[i];
            sP[(r0 + i) * N + k] = p_r[i];
          }
        rho_c = rho_new;
      }
      sync();
    }
    if (in)
#pragma unroll
      for (int i = 0; i < R; ++i) sLam[k * NX + r0 + i] = lam_r[i];
    __syncthreads();
  }
  if (dead0) iters = a.max_pcg_iters;

  // ---- E: dz recovery (schur.compute_dz), then the step_ok scrub ----
  bool bad_step = false;
  if (on) {
    float lam_next[NX];
    for (int i = 0; i < NX; ++i) lam_next[i] = notlast ? sLam[(k + 1) * NX + i] : 0.0f;
    float res_q[NX];
    for (int r = 0; r < NX; ++r) {
      float atl = 0.0f;
      for (int i = 0; i < NX; ++i) atl += K[E_A + i * NX + r] * lam_next[i];
      res_q[r] = (K[E_QV + r] - sLam[k * NX + r]) + (notlast ? atl : 0.0f);
    }
    for (int r = 0; r < NX; ++r) {
      float v = 0.0f;
      if (r < NQ)
        for (int c = 0; c < NQ; ++c) v += K[E_IQQ + r * NQ + c] * res_q[c];
      else
        v = K[E_IDQ + r - NQ] * res_q[r];
      sDX[k * NX + r] = -v;
    }
    for (int c = 0; c < NU; ++c) {
      float btl = 0.0f;
      for (int r = 0; r < NX; ++r) btl += K[E_B + r * NU + c] * lam_next[r];
      sDU[k * NU + c] = notlast ? -(K[E_RI + c] * (K[E_RV + c] + btl)) : 0.0f;
    }
    bad_step = !(finite_vec(sDX + k * NX, NX) && finite_vec(sDU + k * NU, NU));
    for (int i = 0; i < NX; ++i) a.lam_o[((size_t)b * N + k) * NX + i] = sLam[k * NX + i];
  }
  if constexpr (!kLineSearch) {
    if (on) {
      for (int i = 0; i < NX; ++i) a.dzx_o[((size_t)b * N + k) * NX + i] = sDX[k * NX + i];
      if (notlast)
        for (int i = 0; i < NU; ++i)
          a.dzu_o[((size_t)b * (N - 1) + k) * NU + i] = sDU[k * NU + i];
    }
    if (lead) a.pcg_iters[b] = iters;
    return;
  }
  if (__syncthreads_or(bad_step) && on) {
    for (int i = 0; i < NX; ++i) sDX[k * NX + i] = 0.0f;
    for (int i = 0; i < NU; ++i) sDU[k * NU + i] = 0.0f;
  }
  __syncthreads();

  // ---- F: merit at alpha = 0 (X itself) and alpha = 2^-j ----
  const float mu = a.mu[b];
  const int A1 = a.num_alphas + 1;
  for (int j = 0; j < A1; ++j) {
    const float al = (j == 0) ? 0.0f : ldexpf(1.0f, 1 - j);
    float term = 0.0f;
    if (on) {
      float x[NX], u[NU], xn[NX], out[3];
      for (int i = 0; i < NX; ++i) {
        x[i] = j ? sX[k * NX + i] + al * sDX[k * NX + i] : sX[k * NX + i];
        xn[i] = notlast ? (j ? sX[(k + 1) * NX + i] + al * sDX[(k + 1) * NX + i]
                             : sX[(k + 1) * NX + i])
                        : 0.0f;
      }
      for (int i = 0; i < NU; ++i)
        u[i] = j ? sU[k * NU + i] + al * sDU[k * NU + i] : sU[k * NU + i];
      robot::knot_merit<float, float*>(x, x + NQ, u, xn, r3, fe, a.dt, w_track,
                                       a.w, out);
      float pen = notlast ? out[2] : 0.0f;
      if (k == 0) {
        float viol = 0.0f;
        for (int i = 0; i < NX; ++i) viol += fabsf(x[i] - xs[i]);
        pen = pen + viol;
      }
      const float knot = notlast ? out[0] + out[1] : out[0];
      term = clamp_term(knot + mu * pen);
    }
    const float m = block_sum(term, red);
    if (lead) sMerit[j] = m;
  }

  // ---- G: line search + rho schedule (line_search.cuh:12-98) ----
  if (lead) {
    float mbase, merit0;
    if (a.seeded) {
      mbase = a.mbase[b];
      merit0 = a.merit0[b];
    } else {
      mbase = sMerit[0];
      merit0 = sMerit[0];
    }
    float best = sMerit[1];
    float besta = 1.0f;
    for (int j = 2; j < A1; ++j)
      if (sMerit[j] < best) {  // strict: the first minimum wins ties
        best = sMerit[j];
        besta = ldexpf(1.0f, 1 - j);
      }
    const bool success = best < mbase;
    float rho_n = rho, drho_n = a.drho[b];
    if (a.adapt_rho) {
      drho_n = success ? fminf(drho_n / RHO_FACTOR, (float)(1.0 / 1.2))
                       : fmaxf(drho_n * RHO_FACTOR, RHO_FACTOR);
      rho_n = fminf(fmaxf(rho * drho_n, RHO_MIN), RHO_MAX);
    }
    if (!success && rho_n > RHO_MAX) rho_n = RHO_INIT;
    const float m_n = success ? best : mbase;
    const float conv_in = a.conv[b];
    a.rho_o[b] = rho_n;
    a.drho_o[b] = drho_n;
    a.mbase_o[b] = m_n;
    a.merit0_o[b] = merit0;
    a.conv_o[b] = fmaxf(conv_in, iters == 0 ? 1.0f : 0.0f);
    a.sqp_o[b] = conv_in > 0.5f ? a.sqp[b] : a.sqp[b] + 1.0f;
    a.pcg_iters[b] = iters;
    a.ls_merit[b] = m_n;
    a.ls_step[b] = success ? besta : -1.0f;
    sLS[0] = success ? 1.0f : 0.0f;
    sLS[1] = besta;
  }
  __syncthreads();
  if (on) {
    const bool take = sLS[0] > 0.5f;
    const float al = sLS[1];
    for (int i = 0; i < NX; ++i)
      a.X_o[((size_t)b * N + k) * NX + i] =
          take ? sX[k * NX + i] + al * sDX[k * NX + i] : sX[k * NX + i];
    if (notlast)
      for (int i = 0; i < NU; ++i)
        a.U_o[((size_t)b * (N - 1) + k) * NU + i] =
            take ? sU[k * NU + i] + al * sDU[k * NU + i] : sU[k * NU + i];
  }
}

// The kernel of one variant: one block per problem, G W threads.
template <bool kLineSearch, Blocks kBlocks, int G, bool kStaged>
__global__ void __launch_bounds__(G == 1 ? 128 : iter_detail::MAX_THREADS)
iteration_kernel(const IterArgs a) {
  sqp_iteration<kLineSearch, kBlocks, G, kStaged>(a);
}

using IterationKernel = void (*)(IterArgs);

// The shared layout at G threads per knot with the one-thread phase A,
// compiled where G divides the plant's NX rows and G warps fit
// MAX_THREADS; null elsewhere.
template <bool kLineSearch, int G>
inline IterationKernel shared_variant() {
  if constexpr (iter_detail::NX % G == 0 && 32 * G <= iter_detail::MAX_THREADS)
    return iteration_kernel<kLineSearch, Blocks::kShared, G, false>;
  else
    return nullptr;
}

// The compiled variants: (global, 1) and (shared, G) with the one-thread
// phase A, G in {1, 2, 4} for indy7 and {1, 2, 7} for iiwa14
// (shared_variant); (shared, 4) with the staged one, for a plant with a
// staged KKT (indy7); null for any other (layout, G, staged).
template <bool kLineSearch>
inline IterationKernel iteration_variant(int layout, int G, int staged) {
  if (staged) {
#ifdef GATO_KKT_STAGES
    return layout == (int)Blocks::kShared && G == 4
               ? iteration_kernel<kLineSearch, Blocks::kShared, 4, true>
               : nullptr;
#else
    return nullptr;
#endif
  }
  if (layout == (int)Blocks::kGlobal && G == 1)
    return iteration_kernel<kLineSearch, Blocks::kGlobal, 1, false>;
  if (layout != (int)Blocks::kShared) return nullptr;
  switch (G) {
    case 1: return shared_variant<kLineSearch, 1>();
    case 2: return shared_variant<kLineSearch, 2>();
    case 4: return shared_variant<kLineSearch, 4>();
    case 7: return shared_variant<kLineSearch, 7>();
    default: return nullptr;
  }
}

// Set a variant's dynamic shared memory for horizon N; its threads and bytes
// go to *threads, *smem. Returns a CUDA error code.
template <bool kLineSearch>
inline int prepare_variant(int N, int layout, int G, int staged, IterationKernel* kernel,
                           int* threads, size_t* smem) {
  *kernel = iteration_variant<kLineSearch>(layout, G, staged);
  if (*kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *threads = iter_detail::warp_threads(N) * G;
  *smem = iter_detail::smem_bytes(N, static_cast<Blocks>(layout), G);
  return static_cast<int>(cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem));
}

// Launch one iteration kernel: one block per problem, the variant's threads
// and dynamic shared memory. A launch that the card refuses (too much
// shared memory, too many threads) returns its error; nothing falls back.
template <bool kLineSearch>
inline int launch_iteration(const IterArgs* args, int layout, int G, int staged,
                            void* stream) {
  IterationKernel kernel;
  int threads;
  size_t smem;
  const int err =
      prepare_variant<kLineSearch>(args->N, layout, G, staged, &kernel, &threads, &smem);
  if (err != 0) return err;
  kernel<<<args->B, threads, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of a variant at horizon N
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error.
template <bool kLineSearch>
inline int blocks_per_sm(int N, int layout, int G, int staged) {
  IterationKernel kernel;
  int threads, n = 0;
  size_t smem;
  if (prepare_variant<kLineSearch>(N, layout, G, staged, &kernel, &threads, &smem) != 0)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace gato
