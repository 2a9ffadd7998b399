// The per-knot linearization and quadraticization of the batched KKT
// system over all N knots of B problems.
//
// Replaces gato_tpu/ops/pallas_kkt.py::_kkt_kernel, the staged route's KKT
// setup: forward dynamics with sparse dual-number derivatives, the
// trapezoidal integrator's A, B and defect, the cost gradient and Hessian of
// every knot, written into the KKTSystem tensors. The last knot runs with
// the tracking weight N_cost, which yields the terminal Q and q (as
// bsqp_iter's phase A does); its A, B, defect, R and r belong to no knot. R
// is written whole (its diagonal, zeros elsewhere). c_0 = x_0 - x_s is left
// to the wrapper. The plain PyTorch version is
// ops/kkt_fast.py::setup_kkt_batched.
//
// Two variants (ops/cuda_kkt.py::setup_kkt_batched_cuda):
//   staged  (the default) a CTA takes KNOTS = 32 consecutive knots of
//           the flattened (B, N) grid and G = KKT_GROUPS = 2 threads per knot,
//           part-major (warp P runs part P of the 32 knots, so no warp
//           diverges); the stages of csrc/kkt_stages.cuh, with the knots'
//           inputs, qdd and Minv and every output in shared memory (Q as
//           its nonzero blocks), then the outputs leave in coalesced stores
//           (a warp's 32 threads on 32 consecutive floats of one output
//           tensor).
//   one     the earlier kernel, taken only when forced (for measurements):
//           one thread per knot runs the whole generated knot_kkt and
//           writes its rows itself.
//
// Bound: bytes, about 1.7 KB of outputs a knot. The one-thread kernel runs
// 13.2k lines of straight-line code a thread, spills (255 registers) and
// stores uncoalesced rows. The staged one runs the 3.1k-line primal, then
// a part of the tangent columns (about 5k lines at G = 2), without spills;
// what bounds it is that critical path of straight-line code per CTA and
// the waves: at G = 2 a CTA (64 threads, 255 registers, 48 KB of shared
// memory) fits four to an SM, so 16,384 knots take one wave. G = 4 and 6
// (shorter parts, three and two CTAs an SM, two waves) were slower.
#include <cuda_runtime.h>

#include "kkt_stages.cuh"

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
  float* sink;       // (B, SINK_FLOATS), the "one" variant only
  int B;
  int N;
  int ref_stride;
  float dt;
  float w[7];        // CostParams order
};

}  // namespace gato

namespace {

namespace robot = gato::indy7;
using gato::kkt_stages::DYN_FLOATS;
constexpr int NQ = robot::NQ;
constexpr int NX = robot::NX;
constexpr int NU = NQ;
// sink of the last knot's unused outputs, per problem: A, B, c, R_diag, r
constexpr int SINK_FLOATS = NX * NX + NX * NU + NX + NU + NU;

// ---------------------------------------------------------------- "one" --

// an output of knot_kkt: element i at p[i * s]
struct Out {
  float* p;
  int s;
  __device__ float& operator[](int i) const { return p[(size_t)i * s]; }
};

__global__ void __launch_bounds__(128) kkt_one_kernel(const gato::KktArgs a) {
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

// ------------------------------------------------------------- "staged" --

constexpr int KNOTS = 32;       // knots of one CTA: one per lane of each part's warp
constexpr int KKT_GROUPS = 2;  // threads per knot (ops/cuda_kkt.py mirrors it)

// one knot's slots in shared memory (floats), each an odd stride so that a
// warp's 32 knots fall on 32 banks: inputs x, x_next, u, ref xyz, f_ext;
// qdd and Minv; the outputs A, B, c, Q, q, R's diagonal, r
constexpr int I_X = 0, I_XN = NX, I_U = 2 * NX, I_R3 = I_U + NU, I_FE = I_R3 + 3;
constexpr int IN_FLOATS = I_FE + 6;  // 39
constexpr int SA = NX * NX + 1, SB = NX * NU + 1, SC = NX + 1, SQ = NQ * NQ + NQ + 1,
              SQV = NX + 1, SRD = NU + 1, SRV = NU + 1;
// region offsets of the CTA's 32 knots, floats; then one int per knot
constexpr int O_IN = 0;
constexpr int O_DYN = O_IN + KNOTS * IN_FLOATS;
constexpr int O_A = O_DYN + KNOTS * DYN_FLOATS;
constexpr int O_B = O_A + KNOTS * SA;
constexpr int O_C = O_B + KNOTS * SB;
constexpr int O_Q = O_C + KNOTS * SC;
constexpr int O_QV = O_Q + KNOTS * SQ;
constexpr int O_RD = O_QV + KNOTS * SQV;
constexpr int O_RV = O_RD + KNOTS * SRD;
constexpr int O_ROW = O_RV + KNOTS * SRV;
constexpr size_t STAGED_SMEM = sizeof(float) * O_ROW + sizeof(int) * KNOTS;
static_assert(IN_FLOATS % 2 == 1 && DYN_FLOATS % 2 == 1, "odd strides");

// knot_cost's outputs as staged: element i at p[i], except Q (q_pack),
// staged as its dense qq block (NQ x NQ, row-major) and then the diagonal
// of its qd block; Q's other entries are structural zeros, whose stores
// land in a dummy (all of it folds away: i and q_pack are constants)
struct CostSlot {
  float* p;
  float* dump;
  bool q_pack;
  __device__ float& operator[](int i) const {
    if (!q_pack) return p[i];
    const int r = i / NX, c = i % NX;
    if (r < NQ && c < NQ) return p[r * NQ + c];
    if (r == c) return p[NQ * NQ + r - NQ];
    return *dump;
  }
};

__device__ __forceinline__ float q_entry(const float* p, int i) {
  const int r = i / NX, c = i % NX;
  if (r < NQ && c < NQ) return p[r * NQ + c];
  return r == c ? p[NQ * NQ + r - NQ] : 0.0f;
}

// out[row(s) W + col] = val(s, col) for the CTA's knots s < n with row(s) >=
// 0: consecutive threads on consecutive floats of the output
template <int W, typename Row, typename Val>
__device__ __forceinline__ void store_rows(float* out, int n, Row row, Val val) {
  for (int e = threadIdx.x; e < n * W; e += blockDim.x) {
    const int s = e / W;
    const int col = e - s * W;
    const long long r = row(s);
    if (r >= 0) out[r * W + col] = val(s, col);
  }
}

template <int G>
__global__ void __launch_bounds__(KNOTS* G) kkt_staged_kernel(const gato::KktArgs a) {
  extern __shared__ float smem[];
  int* sRow = reinterpret_cast<int*>(smem + O_ROW);  // row of A, B, R, r, or -1
  const int part = threadIdx.x / KNOTS;              // warp-uniform
  const int s = threadIdx.x % KNOTS;
  const int N = a.N;
  const long long total = (long long)a.B * N;
  const long long idx0 = (long long)blockIdx.x * KNOTS;
  const int n = (int)min((long long)KNOTS, total - idx0);  // knots of this CTA
  const long long idx = idx0 + s;
  const bool valid = s < n;
  const int b = valid ? (int)(idx / N) : 0;
  const int k = valid ? (int)(idx - (long long)b * N) : 0;
  const bool notlast = valid && k < N - 1;
  float* in = smem + O_IN + s * IN_FLOATS;
  float* dyn = smem + O_DYN + s * DYN_FLOATS;

  // inputs: element e of a knot's IN_FLOATS on part e mod G (x_next and u
  // zero on the last knot, everything zero past the batch)
  for (int e = part; e < IN_FLOATS; e += G) {
    float v = 0.0f;
    if (valid) {
      if (e < I_XN)
        v = a.X[idx * NX + e];
      else if (e < I_U)
        v = notlast ? a.X[(idx + 1) * NX + e - I_XN] : 0.0f;
      else if (e < I_R3)
        v = notlast ? a.U[(idx - b) * NU + e - I_U] : 0.0f;
      else if (e < I_FE)
        v = a.ref[idx * a.ref_stride + e - I_R3];
      else
        v = a.fe[b * 6 + e - I_FE];
    }
    in[e] = v;
  }
  if (part == 0) sRow[s] = notlast ? (int)(idx - b) : -1;
  __syncthreads();

  const float* x = in + I_X;
  const float* u = in + I_U;
  const float* fe = in + I_FE;
  // stage 1: the primal on part 0, the cost on part 1
  if (part == 0) {
    robot::knot_dyn<float, float*>(x, x + NQ, u, fe, dyn, dyn + NQ);
  } else if (part == 1) {
    float dump;
    robot::knot_cost<float, CostSlot>(
        x, x + NQ, u, in + I_R3, notlast ? a.w[0] : a.w[3], a.w,
        CostSlot{smem + O_Q + s * SQ, &dump, true}, CostSlot{smem + O_QV + s * SQV, &dump, false},
        CostSlot{smem + O_RD + s * SRD, &dump, false},
        CostSlot{smem + O_RV + s * SRV, &dump, false});
  }
  __syncthreads();
  // stage 2: every part's tangent columns; the defect on the last part
  gato::kkt_stages::tangent_part<G, float*>(part, x, x + NQ, dyn, fe, a.dt,
                                            smem + O_A + s * SA, smem + O_B + s * SB);
  if (part == G - 1)
    robot::knot_defect<float, float*>(x, x + NQ, in + I_XN, dyn, a.dt, smem + O_C + s * SC);
  __syncthreads();

  // stage 3: coalesced stores. Q, q: rows idx; c: row idx + 1 of a knot
  // that is not the last; A, B, R, r: row idx - b of such a knot (these
  // rows are consecutive)
  const float* sm = smem;
  auto all = [&](int t) { return idx0 + t; };
  auto next = [&](int t) { return sRow[t] >= 0 ? idx0 + t + 1 : -1LL; };
  auto lrow = [&](int t) { return (long long)sRow[t]; };
  store_rows<NX * NX>(a.Q, n, all, [&](int t, int j) { return q_entry(sm + O_Q + t * SQ, j); });
  store_rows<NX>(a.q, n, all, [&](int t, int j) { return sm[O_QV + t * SQV + j]; });
  store_rows<NX>(a.c, n, next, [&](int t, int j) { return sm[O_C + t * SC + j]; });
  store_rows<NX * NX>(a.A, n, lrow, [&](int t, int j) { return sm[O_A + t * SA + j]; });
  store_rows<NX * NU>(a.Bm, n, lrow, [&](int t, int j) { return sm[O_B + t * SB + j]; });
  store_rows<NU * NU>(a.R, n, lrow, [&](int t, int j) {
    return j % (NU + 1) == 0 ? sm[O_RD + t * SRD + j / (NU + 1)] : 0.0f;
  });
  store_rows<NU>(a.r, n, lrow, [&](int t, int j) { return sm[O_RV + t * SRV + j]; });
}

using KktKernel = void (*)(gato::KktArgs);

// the kernel, threads and dynamic shared memory of a variant (0: "one",
// KKT_GROUPS: staged); null for a variant not compiled
KktKernel kkt_variant(int variant, int* threads, size_t* smem) {
  *threads = variant == 0 ? 128 : KNOTS * KKT_GROUPS;
  *smem = variant == 0 ? 0 : STAGED_SMEM;
  if (variant == 0) return kkt_one_kernel;
  return variant == KKT_GROUPS ? kkt_staged_kernel<KKT_GROUPS> : nullptr;
}

int prepare(int variant, KktKernel* kernel, int* threads, size_t* smem) {
  *kernel = kkt_variant(variant, threads, smem);
  if (*kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem));
}

}  // namespace

extern "C" int gato_kkt_sink_floats() { return SINK_FLOATS; }

extern "C" long long gato_kkt_smem_bytes(int variant) {
  int threads;
  size_t smem;
  return kkt_variant(variant, &threads, &smem) ? (long long)smem : -1;
}

// resident CTAs per SM of a variant (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1
extern "C" int gato_kkt_blocks_per_sm(int variant) {
  KktKernel kernel;
  int threads, n = 0;
  size_t smem;
  if (prepare(variant, &kernel, &threads, &smem) != 0) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return -1;
  return n;
}

// Launch a variant (0: "one"; KKT_GROUPS: staged). A
// launch that the card refuses returns its error; nothing falls back.
extern "C" int gato_kkt_indy7(const gato::KktArgs* args, int variant, void* stream) {
  KktKernel kernel;
  int threads;
  size_t smem;
  const int err = prepare(variant, &kernel, &threads, &smem);
  if (err != 0) return err;
  const long long knots = (long long)args->B * args->N;
  const long long per_block = variant == 0 ? threads : KNOTS;
  const int blocks = (int)((knots + per_block - 1) / per_block);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
