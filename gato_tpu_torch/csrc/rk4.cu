// RK4 plant step: one thread per problem.
//
// Replaces gato_tpu/ops/pallas_sim.py::_rk4_kernel (body rk4_channels).
// Each thread runs `substeps` x 4 calls of the generated straight-line
// forward dynamics (csrc/generated/indy7.cuh: RNEA + CRBA + Cholesky with
// the robot constants folded) on its own problem; an optional EE-frame
// wrench enters every call.
//
// Bound: arithmetic and the registers of one long straight-line fd per
// thread (a few thousand flops, no memory traffic beyond 30 floats in and 12
// out). On the main path B = 1, so the launch itself dominates; at batch the
// design keeps every intermediate in registers and reads x/u/f_ext in their
// (B, .) layout with one thread per row.
#include <cuda_runtime.h>

#include "generated/indy7.cuh"

namespace {

namespace robot = gato::indy7;
constexpr int NQ = robot::NQ;

__global__ void rk4_kernel(const float* __restrict__ x,
                           const float* __restrict__ u,
                           const float* __restrict__ fe,
                           float* __restrict__ out, int B, float h,
                           int substeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float q[NQ], qd[NQ], uu[NQ], f[6];
  for (int i = 0; i < NQ; ++i) {
    q[i] = x[b * 2 * NQ + i];
    qd[i] = x[b * 2 * NQ + NQ + i];
    uu[i] = u[b * NQ + i];
  }
  // a zero wrench subtracts exact zeros: the same result as no wrench
  for (int i = 0; i < 6; ++i) f[i] = fe ? fe[b * 6 + i] : 0.0f;

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
  for (int i = 0; i < NQ; ++i) {
    out[b * 2 * NQ + i] = q[i];
    out[b * 2 * NQ + NQ + i] = qd[i];
  }
}

}  // namespace

// x (B, 2 NQ), u (B, NQ), fe (B, 6) or null, out (B, 2 NQ); float32,
// contiguous. h = dt / substeps. Returns cudaGetLastError() of the launch.
extern "C" int gato_rk4_indy7(const float* x, const float* u, const float* fe,
                              float* out, int B, float h, int substeps,
                              void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  rk4_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, u, fe, out, B, h, substeps);
  return static_cast<int>(cudaGetLastError());
}
