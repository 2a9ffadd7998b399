// RK4 plant step: x (B, 2 NQ), u (B, NQ) and an optional EE-frame wrench
// (B, 6) -> x after `substeps` RK4 steps of h = dt / substeps. Compiled
// once per plant (csrc/robot.cuh), for indy7 (NQ = 6) and iiwa14 (NQ = 7),
// and for the pendulum-augmented plants of add_pendulum (NQ = 9, 10), whose
// header is generated at first use into the build directory under a slug
// that hashes their constants: entry points gato_rk4_<plant>.
//
// Replaces gato_tpu/ops/pallas_sim.py::_rk4_kernel (body rk4_channels). The
// JAX package runs it at B = 1 (the MPC loop's plant, the rollouts' x[None]
// steps): what counts is the latency of one plant, 2 substeps x 4 forward
// dynamics in series.
//
// Two variants (ops/cuda_sim.py::rk4_step_batched):
//   one    (the default) the earlier kernel: one thread per plant runs the
//          generated fd (CRBA, bias, Cholesky) 4 x substeps times in series.
//   crba   forced only: one CTA of two warps per plant: lane 0 of warp 0
//          computes the mass matrix by the generated fd_crba (fd's own
//          CRBA) while lane 0 of warp 1 computes the RNEA bias (fd_bias,
//          the wrench included); both land in shared memory (two buffers,
//          so one barrier a stage suffices), and every thread then runs the
//          Cholesky solve fd_solve and the stage update itself, so the
//          state and the RK4 sums stay in registers. fd's own expressions:
//          the same values as the one kernel up to the multiply-adds that
//          ptxas fuses, which depend on the code around an expression
//          (with the fusion off the two are equal bit for bit, PERF.md),
//          so the closed loop's float32 trajectory moves.
//          The stage loop is not unrolled: one fd's code stays in the
//          instruction cache across the 8 stages.
//
// Bound: at B = 1 neither bytes (30 floats in, 12 out) nor the card's
// arithmetic rate: the chain of dependent operations. One fd as the crba
// variant runs it is the deeper of fd_crba and fd_bias, then fd_solve (the
// depths in csrc/generated/<plant>.cuh); a lone warp issues one
// instruction a cycle at best, so the CRBA lane's 1,521 operations a stage
// (indy7; iiwa14 1,222) weigh as much as the chain. The one variant issues
// all of fd's operations (indy7 2,596, iiwa14 2,284) from one thread.
#include <cuda_runtime.h>

#include "robot.cuh"

namespace {

namespace robot = gato::robot;
constexpr int NQ = robot::NQ;
constexpr int SPLIT_THREADS = 64;
constexpr int BIAS_THREAD = 32;  // lane 0 of warp 1

__device__ inline void load_plant(const float* x, const float* u, const float* fe, int b,
                                  float* q, float* qd, float* uu, float* f) {
  for (int i = 0; i < NQ; ++i) {
    q[i] = x[b * 2 * NQ + i];
    qd[i] = x[b * 2 * NQ + NQ + i];
    uu[i] = u[b * NQ + i];
  }
  // a zero wrench subtracts exact zeros: the same result as no wrench
  for (int i = 0; i < 6; ++i) f[i] = fe ? fe[b * 6 + i] : 0.0f;
}

__device__ inline void store_plant(float* out, int b, const float* q, const float* qd) {
  for (int i = 0; i < NQ; ++i) {
    out[b * 2 * NQ + i] = q[i];
    out[b * 2 * NQ + NQ + i] = qd[i];
  }
}

// ---------------------------------------------------------------- split --

__global__ void __launch_bounds__(SPLIT_THREADS)
    rk4_split_kernel(const float* __restrict__ x, const float* __restrict__ u,
                     const float* __restrict__ fe, float* __restrict__ out, float h,
                     int substeps) {
  __shared__ float sM[2][NQ * NQ];  // column c at [c * NQ], lower triangle read
  __shared__ float sbias[2][NQ];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  float q[NQ], qd[NQ], uu[NQ], f[6];
  load_plant(x, u, fe, b, q, qd, uu, f);

  const float hh = 0.5f * h;
  const float h6 = h / 6.0f;
  // the stage's point (tq, td) and the sums k1 + 2 k2 + 2 k3 (+ k4), in the
  // one-thread kernel's order
  float tq[NQ], td[NQ], aq[NQ], ad[NQ];
  for (int i = 0; i < NQ; ++i) {
    tq[i] = q[i];
    td[i] = qd[i];
  }
#pragma unroll 1
  for (int s = 0; s < 4 * substeps; ++s) {
    const int stage = s & 3;
    const int buf = s & 1;
    if (t == 0) {
      robot::fd_crba<float, float*>(tq, sM[buf]);
    } else if (t == BIAS_THREAD) {
      robot::fd_bias<float, float*>(tq, td, f, sbias[buf]);
    }
    __syncthreads();
    float kd[NQ];
    robot::fd_solve<float, float*>(sM[buf], uu, sbias[buf], kd);
    // this stage's derivative is (td, kd)
    for (int i = 0; i < NQ; ++i) {
      if (stage == 0) {
        aq[i] = td[i];
        ad[i] = kd[i];
      } else if (stage < 3) {
        aq[i] = aq[i] + 2.0f * td[i];
        ad[i] = ad[i] + 2.0f * kd[i];
      } else {
        aq[i] = aq[i] + td[i];
        ad[i] = ad[i] + kd[i];
      }
    }
    if (stage < 3) {
      const float c = stage == 2 ? h : hh;
      for (int i = 0; i < NQ; ++i) {
        tq[i] = q[i] + c * td[i];
        td[i] = qd[i] + c * kd[i];
      }
    } else {
      for (int i = 0; i < NQ; ++i) {
        q[i] = q[i] + h6 * aq[i];
        qd[i] = qd[i] + h6 * ad[i];
        tq[i] = q[i];
        td[i] = qd[i];
      }
    }
  }
  if (t == 0) store_plant(out, b, q, qd);
}

// ------------------------------------------------------------------ one --

__global__ void rk4_one_kernel(const float* __restrict__ x,
                               const float* __restrict__ u,
                               const float* __restrict__ fe,
                               float* __restrict__ out, int B, float h,
                               int substeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float q[NQ], qd[NQ], uu[NQ], f[6];
  load_plant(x, u, fe, b, q, qd, uu, f);

  const float hh = 0.5f * h;
  const float h6 = h / 6.0f;
  float k1q[NQ], k1d[NQ], k2q[NQ], k2d[NQ], k3q[NQ], k3d[NQ], k4q[NQ],
      k4d[NQ], tq[NQ], td[NQ];
  for (int s = 0; s < substeps; ++s) {
    for (int i = 0; i < NQ; ++i) k1q[i] = qd[i];
    robot::fd<float>(q, qd, uu, f, k1d);
    for (int i = 0; i < NQ; ++i) {
      tq[i] = q[i] + hh * k1q[i];
      td[i] = qd[i] + hh * k1d[i];
    }
    for (int i = 0; i < NQ; ++i) k2q[i] = td[i];
    robot::fd<float>(tq, td, uu, f, k2d);
    for (int i = 0; i < NQ; ++i) {
      tq[i] = q[i] + hh * k2q[i];
      td[i] = qd[i] + hh * k2d[i];
    }
    for (int i = 0; i < NQ; ++i) k3q[i] = td[i];
    robot::fd<float>(tq, td, uu, f, k3d);
    for (int i = 0; i < NQ; ++i) {
      tq[i] = q[i] + h * k3q[i];
      td[i] = qd[i] + h * k3d[i];
    }
    for (int i = 0; i < NQ; ++i) k4q[i] = td[i];
    robot::fd<float>(tq, td, uu, f, k4d);
    for (int i = 0; i < NQ; ++i) {
      q[i] = q[i] + h6 * (k1q[i] + 2.0f * k2q[i] + 2.0f * k3q[i] + k4q[i]);
      qd[i] = qd[i] + h6 * (k1d[i] + 2.0f * k2d[i] + 2.0f * k3d[i] + k4d[i]);
    }
  }
  store_plant(out, b, q, qd);
}

}  // namespace

// x (B, 2 NQ), u (B, NQ), fe (B, 6) or null, out (B, 2 NQ); float32,
// contiguous. h = dt / substeps; variant 1: crba, 0: one. Returns
// cudaGetLastError() of the launch; nothing falls back.
extern "C" int GATO_ENTRY(gato_rk4)(const float* x, const float* u, const float* fe,
                                   float* out, int B, float h, int substeps, int variant,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    rk4_split_kernel<<<B, SPLIT_THREADS, 0, st>>>(x, u, fe, out, h, substeps);
  } else if (variant == 0) {
    const int threads = 128;
    rk4_one_kernel<<<(B + threads - 1) / threads, threads, 0, st>>>(x, u, fe, out, B, h,
                                                                   substeps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
