// The per-knot linearization and quadraticization of the batched KKT
// system: one thread per (problem, knot), over all N knots.
//
// Replaces gato_tpu/ops/pallas_kkt.py::_kkt_kernel, the staged route's KKT
// setup. Thread (b, k) calls the generated knot_kkt (forward dynamics with
// sparse dual-number derivatives, the trapezoidal integrator's A, B and
// defect, the cost gradient and Hessian) and writes its blocks straight
// into the KKTSystem tensors. The last knot runs the same function with the
// tracking weight N_cost, which yields the terminal Q and q (as bsqp_iter's
// phase A does); its A, B, defect, R and r belong to no knot and go to a
// per-problem sink. R is written whole (its diagonal from knot_kkt, zeros
// elsewhere). c_0 = x_0 - x_s is left to the wrapper. The plain PyTorch
// version is ops/kkt_fast.py::setup_kkt_batched.
//
// Bound: the straight-line knot_kkt (about 13k SSA values) in one thread:
// registers, which spill to local memory. Its outputs (about 1.7 KB per
// knot) are written by each thread as contiguous rows, so a warp's stores
// are not coalesced; L2 merges them. Occupancy and spills are left for
// later work.
#include <cuda_runtime.h>

#include "generated/indy7.cuh"

namespace gato {

// Arguments of one launch (ops/cuda_kkt.py mirrors it); a named
// namespace, so that the extern "C" entry point keeps external linkage.
struct KktArgs {
  const float* X;    // (B, N, NX)
  const float* U;    // (B, N-1, NU)
  const float* ref;  // (B, N, ref_stride), xyz first
  const float* fe;   // (B, 6)
  float* Q;          // (B, N, NX, NX)
  float* q;          // (B, N, NX)
  float* R;          // (B, N-1, NU, NU)
  float* r;          // (B, N-1, NU)
  float* A;          // (B, N-1, NX, NX)
  float* Bm;         // (B, N-1, NX, NU)
  float* c;          // (B, N, NX); row 0 is left to the wrapper
  float* sink;       // (B, SINK_FLOATS)
  int B;
  int N;
  int ref_stride;
  float dt;
  float w[7];        // CostParams order
};

}  // namespace gato

namespace {

namespace robot = gato::indy7;
constexpr int NQ = robot::NQ;
constexpr int NX = robot::NX;
constexpr int NU = NQ;
// sink of the last knot's unused outputs, per problem: A, B, c, R_diag, r
constexpr int SINK_FLOATS = NX * NX + NX * NU + NX + NU + NU;

// an output of knot_kkt: element i at p[i * s]
struct Out {
  float* p;
  int s;
  __device__ float& operator[](int i) const { return p[(size_t)i * s]; }
};

__global__ void __launch_bounds__(128) kkt_kernel(const gato::KktArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.B * a.N) return;
  const int N = a.N;
  const int b = idx / N;
  const int k = idx % N;
  const bool notlast = k < N - 1;
  const size_t row = (size_t)b * N + k;
  const size_t lrow = (size_t)b * (N - 1) + k;

  float x[NX], xn[NX], u[NU], r3[3], fe[6];
  for (int i = 0; i < NX; ++i) {
    x[i] = a.X[row * NX + i];
    xn[i] = notlast ? a.X[(row + 1) * NX + i] : 0.0f;
  }
  for (int i = 0; i < NU; ++i) u[i] = notlast ? a.U[lrow * NU + i] : 0.0f;
  for (int i = 0; i < 3; ++i) r3[i] = a.ref[row * a.ref_stride + i];
  for (int i = 0; i < 6; ++i) fe[i] = a.fe[b * 6 + i];

  Out A, Bm, c, Rd, rv;
  if (notlast) {
    A = Out{a.A + lrow * NX * NX, 1};
    Bm = Out{a.Bm + lrow * NX * NU, 1};
    c = Out{a.c + (row + 1) * NX, 1};
    float* R = a.R + lrow * NU * NU;
    for (int i = 0; i < NU * NU; ++i) R[i] = 0.0f;
    Rd = Out{R, NU + 1};
    rv = Out{a.r + lrow * NU, 1};
  } else {
    float* s = a.sink + (size_t)b * SINK_FLOATS;
    A = Out{s, 1};
    Bm = Out{s + NX * NX, 1};
    c = Out{s + NX * NX + NX * NU, 1};
    Rd = Out{s + NX * NX + NX * NU + NX, 1};
    rv = Out{s + NX * NX + NX * NU + NX + NU, 1};
  }
  const float w_track = notlast ? a.w[0] : a.w[3];
  robot::knot_kkt<float, Out>(x, x + NQ, u, xn, r3, fe, a.dt, w_track, a.w, A, Bm, c,
                              Out{a.Q + row * NX * NX, 1}, Out{a.q + row * NX, 1}, Rd,
                              rv);
}

}  // namespace

extern "C" int gato_kkt_sink_floats() { return SINK_FLOATS; }

extern "C" int gato_kkt_indy7(const gato::KktArgs* args, void* stream) {
  const int threads = 128;
  const int blocks = (args->B * args->N + threads - 1) / threads;
  kkt_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
