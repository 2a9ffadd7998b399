// One SQP iteration of the batched solve: one thread block per problem, one
// thread per knot.
//
// Replaces gato_tpu/ops/pallas_solve.py::_solve_kernel as launched by
// sqp_solve_pallas_chained (one launch per SQP iteration, the whole-batch
// exit decided between launches by the host loop,
// gato_tpu_torch/ops/cuda_solve.py::sqp_solve_chained). Phases, separated
// by __syncthreads():
//   A  KKT: thread k calls the generated knot_kkt (dynamics linearization by
//      sparse duals, defect, cost gradient/Hessian; the tracking weight is
//      N_cost on the last knot) and inverts its Q~ blocks (Cholesky of the
//      6x6 qq block + rho I, reciprocal of the diagonal qd block and of R);
//   B  Schur: theta_k, gamma_{k+1}, S_main_{k+1} = -theta_k and the SS
//      preconditioner block -(theta_k + rho I~)^-1 (12x12 Cholesky);
//   C  P_lower_k = -(P_main_{k+1} phi_k P_main_k);
//   D  block PCG on the block-tridiagonal Schur system: each thread does its
//      knot's rows of the matvec; dot products are warp shuffles plus one
//      shared-memory pass across warps;
//   E  dz recovery, then the per-problem step_ok scrub of non-finite steps;
//   F  merit at alpha = 0 (built from X itself) and alpha = 2^-j: thread k
//      evaluates the generated knot_merit, a block sum per alpha;
//   G  thread 0 runs the line search and the rho schedule; every thread
//      writes its knot back.
// The semantics follow pallas_solve.solve_channels with the internal exit
// disabled (chained mode), and the plain PyTorch version
// ops/cuda_solve.py::sqp_iter_reference.
//
// Bound: on this card the per-knot straight-line code (knot_kkt is ~13k SSA
// values, knot_merit ~3k, run 9 times) is bound by registers: it spills to
// local memory. The PCG loop is bound by reading the four 12x12 blocks per
// knot (S and P, main and lower: ~2.3 KB per knot per iteration) from the
// global scratch: at N = 128 they would not fit a block's shared memory, so
// they live in global memory in an element-major layout (consecutive knots,
// i.e. consecutive threads, read consecutive addresses), and only the PCG
// vectors live in shared memory. Occupancy, spills and tensor cores are
// left for later work.
//
// NaN containment is per block: a diverged problem cannot reach another
// one. Two behaviours still follow the TPU kernel: a problem whose
// warm-started residual is non-finite reports max_pcg_iters without
// iterating, and a non-finite step is zeroed for the whole problem
// (step_ok) so its line search fails with the trajectory untouched. Per-knot
// merit terms are clamped to 1e30 (pallas_solve._segsum) so a diverged
// problem's merit stays finite.
#include <cuda_runtime.h>

#include "generated/indy7.cuh"

namespace gato {

// Arguments of one launch (ops/cuda_solve.py::_IterArgs mirrors it).
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

}  // namespace gato

namespace {

namespace robot = gato::indy7;
constexpr int NQ = robot::NQ;
constexpr int NX = robot::NX;
constexpr int NU = NQ;
constexpr int MAX_ALPHAS = 16;
constexpr float PCG_ABS_TOL = 1e-6f;  // pcg.cuh:26
constexpr float CLAMP = 1e30f;
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
// in the order of gato_tpu's ch_chol_factor_n / ch_chol_solve_n.
template <int n, typename Get, typename Put>
__device__ void chol_inv(Get get, Put put) {
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
  for (int c = 0; c < n; ++c) {
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
__device__ float qinv(const Knot& K, int r, int c) {
  if (r < NQ && c < NQ) return K[E_IQQ + r * NQ + c];
  if (r == c) return K[E_IDQ + r - NQ];
  return 0.0f;
}

// sum of v over the block; every thread gets the result
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

__device__ float clamp_term(float t) { return fabsf(t) <= CLAMP ? t : CLAMP; }

// y_k = main_k x_k + lower_{k-1} x_{k-1} + lower_k^T x_{k+1} (pallas_pcg
// _matvec order) for the block-tridiagonal matrix stored at (em, el)
__device__ void btd_matvec(const Knot& K, const Knot& Kp, int k, int N, int em,
                           int el, const float* x, float* y) {
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

__device__ float knot_dot(const float* a, const float* b, int k) {
  float s = 0.0f;
  for (int i = 0; i < NX; ++i) s += a[k * NX + i] * b[k * NX + i];
  return clamp_term(s);
}

__device__ bool finite_vec(const float* v, int n) {
  bool ok = true;
  for (int i = 0; i < n; ++i) ok = ok && isfinite(v[i]);
  return ok;
}

__global__ void __launch_bounds__(128)
bsqp_iter_kernel(const gato::IterArgs a) {
  extern __shared__ float smem[];
  const int N = a.N;
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const bool on = k < N;
  const bool notlast = k < N - 1;

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

  const size_t stride = (size_t)a.B * N;
  const Knot K{a.scratch + (size_t)b * N + k, (int)stride};
  const Knot Kp{a.scratch + (size_t)b * N + k - 1, (int)stride};  // knot k-1
  const Knot Kn{a.scratch + (size_t)b * N + k + 1, (int)stride};  // knot k+1

  const float rho = a.rho[b];
  const float* fe = a.fe + b * 6;
  const float* xs = a.xs + b * NX;
  float r3[3] = {0.0f, 0.0f, 0.0f};
  if (on)
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
  if (on) {
    float xn[NX];
    for (int i = 0; i < NX; ++i) xn[i] = notlast ? sX[(k + 1) * NX + i] : 0.0f;
    const float* x = sX + k * NX;
    robot::knot_kkt<float, Knot>(x, x + NQ, sU + k * NU, xn, r3, fe, a.dt,
                                 w_track, a.w, K.at(E_A), K.at(E_B), K.at(E_C),
                                 K.at(E_Q), K.at(E_QV), K.at(E_RD), K.at(E_RV));
    chol_inv<NQ>(
        [&](int r, int c) { return K[E_Q + r * NX + c] + (r == c ? rho : 0.0f); },
        [&](int r, int c, float v) { K[E_IQQ + r * NQ + c] = v; });
    for (int i = 0; i < NQ; ++i) K[E_IDQ + i] = 1.0f / K[E_Q + (NQ + i) * NX + NQ + i];
    for (int i = 0; i < NU; ++i) K[E_RI + i] = 1.0f / K[E_RD + i];
    // phi_k = A_k Q~_k^-1 (right factor block-diagonal)
    for (int r = 0; r < NX; ++r) {
      for (int c = 0; c < NQ; ++c) {
        float s = 0.0f;
        for (int j = 0; j < NQ; ++j) s += K[E_A + r * NX + j] * K[E_IQQ + j * NQ + c];
        K[E_PHI + r * NX + c] = s;
      }
      for (int c = NQ; c < NX; ++c)
        K[E_PHI + r * NX + c] = K[E_A + r * NX + c] * K[E_IDQ + c - NQ];
    }
    if (k == 0) {
      // S_main_0 = -Q~_0^-1; P_main_0 = -Q~_0 (not its inverse: reference
      // quirk); gamma_0 = c_0 - Q~_0^-1 q_0 with c_0 = x_0 - x_s
      for (int r = 0; r < NX; ++r) {
        float qq = 0.0f;
        for (int c = 0; c < NX; ++c) {
          K[E_SM + r * NX + c] = -qinv(K, r, c);
          K[E_PM + r * NX + c] =
              -(K[E_Q + r * NX + c] + ((r == c && r < NQ) ? rho : 0.0f));
          if (r < NQ ? c < NQ : c == r) qq += qinv(K, r, c) * K[E_QV + c];
        }
        K[E_G + r] = (sX[r] - xs[r]) - qq;
      }
    }
  }
  __syncthreads();

  // ---- B: theta_k -> S_main_{k+1}, gamma_{k+1}, P_main_{k+1} ----
  if (notlast) {
    float theta[NX][NX];
    for (int r = 0; r < NX; ++r) {
      for (int s = r; s < NX; ++s) {
        float t = 0.0f;
        for (int c = 0; c < NX; ++c) t += K[E_PHI + r * NX + c] * K[E_A + s * NX + c];
        float u = 0.0f;
        for (int c = 0; c < NU; ++c)
          u += K[E_B + r * NU + c] * K[E_RI + c] * K[E_B + s * NU + c];
        t = t + u;
        t = t + qinv(Kn, r, s);
        theta[r][s] = theta[s][r] = t;
      }
    }
    for (int r = 0; r < NX; ++r) {
      for (int s = 0; s < NX; ++s) Kn[E_SM + r * NX + s] = -theta[r][s];
      // gamma_{k+1} = c_k - Q~_{k+1}^-1 q_{k+1} + phi_k q_k + B R^-1 r_k
      float qq = 0.0f;
      for (int c = 0; c < NX; ++c)
        if (r < NQ ? c < NQ : c == r) qq += qinv(Kn, r, c) * Kn[E_QV + c];
      float t1 = 0.0f;
      for (int c = 0; c < NX; ++c) t1 += K[E_PHI + r * NX + c] * K[E_QV + c];
      float t2 = 0.0f;
      for (int c = 0; c < NU; ++c) t2 += K[E_B + r * NU + c] * K[E_RI + c] * K[E_RV + c];
      Kn[E_G + r] = (K[E_C + r] - qq) + (t1 + t2);
    }
    chol_inv<NX>(
        [&](int r, int c) { return theta[r][c] + ((r == c && r < NQ) ? rho : 0.0f); },
        [&](int r, int c, float v) { Kn[E_PM + r * NX + c] = -v; });
  }
  __syncthreads();

  // ---- C: P_lower_k = -(P_main_{k+1} phi_k P_main_k) ----
  if (notlast) {
    for (int r = 0; r < NX; ++r) {
      float T[NX];
      for (int c = 0; c < NX; ++c) {
        float s = 0.0f;
        for (int j = 0; j < NX; ++j) s += Kn[E_PM + r * NX + j] * K[E_PHI + j * NX + c];
        T[c] = s;
      }
      for (int c = 0; c < NX; ++c) {
        float s = 0.0f;
        for (int j = 0; j < NX; ++j) s += T[j] * K[E_PM + j * NX + c];
        K[E_PL + r * NX + c] = -s;
      }
    }
  }
  __syncthreads();

  // ---- D: PCG on S lam = gamma, preconditioner P (pcg_channels) ----
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
  const bool skip = a.conv[b] > 0.5f;
  const bool dead0 = !skip && bad;
  const float rho_init = fabsf(rho_c);
  const float eps = a.eps[b];
  bool active = !skip && !dead0 && fabsf(rho_c) >= PCG_ABS_TOL;
  int iters = 0;
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
    if (k == 0) sMerit[j] = m;
  }

  // ---- G: line search + rho schedule (line_search.cuh:12-98) ----
  if (k == 0) {
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

}  // namespace

extern "C" int gato_bsqp_knot_floats() { return KNOT_FLOATS; }

extern "C" int gato_bsqp_iter_indy7(const gato::IterArgs* args, void* stream) {
  const int threads = 32 * ((args->N + 31) / 32);
  const size_t smem =
      sizeof(float) * ((size_t)args->N * (7 * NX + 2 * NU) + 32 + MAX_ALPHAS + 2);
  cudaError_t err = cudaFuncSetAttribute(
      bsqp_iter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bsqp_iter_kernel<<<args->B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}
