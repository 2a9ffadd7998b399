// The whole preconditioned conjugate-gradient loop on an assembled
// block-tridiagonal Schur system, one launch for the batch, N <= 1024.
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
// Bound: every Krylov iteration's two matvecs read three 12x12 blocks per
// knot (S or P, main and the two lower ones), 432 floats a knot, for one
// multiply-add per float read. The blocks (2,304 bytes a knot) are read
// from device memory once by any design; what decides the time is where
// the loop re-reads them, how many threads share a knot and how many
// barriers an iteration waits at. The kernel comes in three variants
// (ops/cuda_pcg.py::pcg_variant picks one by N):
//   shared   one thread block (CTA) per problem. A coalesced, transposing
//            copy puts the problem's four blocks per knot (S_main, S_lower,
//            P_main, P_lower) into dynamic shared memory, element-major:
//            element e of the knot in slot s at e * stride + s, the stride
//            odd so that the copy's stores spread over the banks; in the
//            loop a warp's consecutive knots read consecutive banks. G
//            threads share a knot, each holding rows [12g/G, 12(g+1)/G) of
//            lam, r, p, z and Ap in registers; r and p also go to shared
//            memory for the neighbours' matvecs. Dot products sum each
//            group's rows, the G partials in order, clamp the knot's term
//            and sum the knots in one order on every warp
//            (krylov.cuh::knot_total), so alpha, beta and the exit are the
//            same in every thread. It fits 232,448 bytes up to N = 95.
//   cluster  past that, one thread-block cluster of C CTAs per problem: CTA
//            rank j holds knots [j n, (j + 1) n), n = ceil(N / C), with
//            their blocks in its own shared memory, plus a halo: the lower
//            blocks of knot j n - 1, and a slot on either side of its range
//            for the neighbouring knots' rows of r and p, so that every
//            matvec reads shared memory of its own CTA. The halo rows are
//            kept up to date without a barrier of their own: a range's edge
//            threads write their rows of Ap and z into the neighbour CTA's
//            shared memory (distributed shared memory) before the cluster
//            barrier of the dot product that follows, and after it each CTA
//            updates its halo rows of r and p with the same fused
//            multiply-adds as their owner, so they equal the owner's bit
//            for bit. A dot product: each CTA's total as above, written to
//            its own shared memory, a cluster barrier, every thread sums
//            the C totals in rank order. So an iteration waits at two
//            cluster barriers, those of its two dot products; a last one
//            keeps each CTA's shared memory alive until every remote access
//            to it is done. (Reading the edge rows remotely in the matvecs
//            instead needs two more cluster barriers an iteration and puts
//            the remote loads' latency in the loop; it measured slower.)
//   global   one CTA per problem, one thread per knot: the blocks are
//            copied into an element-major global scratch and re-read
//            through L2 in every iteration; the earlier design, kept as
//            the comparison arm.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "block_ops.cuh"
#include "krylov.cuh"

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
  float* scratch;        // (B, 4, NX * NX, N), the global variant only
  int B;
  int N;
  int max_iters;
  int layout;            // 0 global, 1 shared, 2 cluster
  int groups;            // G, threads per knot
  int cluster;           // C, CTAs per problem
};

}  // namespace gato

namespace {

namespace cg = cooperative_groups;
using gato::block_sum;
using gato::clamp_term;
// indy7's state size, the only plant pcg is built for (_build.KERNELS); the
// wrapper (ops/cuda_pcg.py) refuses another nx, and so does gato_pcg
constexpr int NX = 12;
constexpr int BLK = NX * NX;
enum Layout { kGlobal = 0, kShared = 1, kCluster = 2 };

// ---------------------------------------------------------------- global

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

using Kernel = void (*)(gato::PcgArgs);

// the global variant's instantiation for horizon N, its threads and bytes
Kernel global_kernel(int N, int* threads, size_t* smem) {
  *threads = 32 * ((N + 31) / 32);
  *smem = sizeof(float) * (3 * (size_t)N * NX + 32);
  if (N <= 128) return pcg_kernel<128>;
  if (N <= 256) return pcg_kernel<256>;
  if (N <= 512) return pcg_kernel<512>;
  return pcg_kernel<1024>;
}

// ------------------------------------------------------- shared, cluster

// the four blocks of a knot, in this order, each NX x NX element-major
constexpr int SB_SM = 0, SB_SL = BLK, SB_PM = 2 * BLK, SB_PL = 3 * BLK;
constexpr int SB_FLOATS = 4 * BLK;
constexpr int MISC_FLOATS = 8;      // a CTA's totals for the cluster sums
constexpr int SMEM_THREADS = 384;   // G W <= 4 x 96; 168 registers a thread

__host__ __device__ inline int warp_threads(int n) { return 32 * ((n + 31) / 32); }

// knots of one CTA: ceil(N / C)
__host__ __device__ inline int cta_knots(int N, int C) { return (N + C - 1) / C; }

// slots per CTA: its knots, and in a cluster a halo slot on either side
// (0 and cnt + 1), made odd
__host__ __device__ inline int slot_stride(int N, int C) {
  return (cta_knots(N, C) + (C > 1 ? 2 : 0)) | 1;
}

constexpr int HALO_FLOATS = 4 * NX;  // Ap and z rows of the two halo knots

// dynamic shared memory of one CTA (ops/cuda_pcg.py::smem_bytes mirrors
// it): the blocks and r, p in every slot, two buffers of one dot partial
// per thread, the totals and the halo rows
size_t smem_bytes(int N, int G, int C) {
  const size_t S = slot_stride(N, C);
  return sizeof(float) * ((SB_FLOATS + 2 * NX) * S + 2 * (size_t)G * warp_threads(cta_knots(N, C))
                          + MISC_FLOATS + HALO_FLOATS);
}

// Copy `knots` consecutive row-major NX x NX blocks from src into shared
// memory, element-major: element e of block j at dst[e * S + s0 + j].
// Consecutive threads read consecutive 16 bytes.
__device__ __forceinline__ void copy_blocks(const float* __restrict__ src, int knots,
                                            float* dst, int S, int s0) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int Q = BLK / 4;  // float4 per block
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int q = threadIdx.x; q < knots * Q; q += blockDim.x) {
      const float4 v = __ldg(s4 + q);
      const int j = q / Q;
      float* d = dst + (size_t)(4 * (q - j * Q)) * S + s0 + j;
      d[0] = v.x;
      d[S] = v.y;
      d[2 * S] = v.z;
      d[3 * S] = v.w;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < knots * BLK; i += blockDim.x) {
      const int j = i / BLK;
      dst[(size_t)(i - j * BLK) * S + s0 + j] = __ldg(src + i);
    }
  }
}

// The sum of a CTA total over the cluster in rank order, the same value in
// every thread of the cluster: each CTA writes its total to its own
// `slot`, a cluster barrier, every thread reads the C totals. Without a
// cluster the CTA total itself.
template <bool kCl>
__device__ __forceinline__ float cluster_sum(float v, float* slot, int C) {
  if constexpr (!kCl) {
    return v;
  } else {
    cg::cluster_group cl = cg::this_cluster();
    if (threadIdx.x == 0) *slot = v;
    cl.sync();
    float s = 0.0f;
    for (int j = 0; j < C; ++j) s += *cl.map_shared_rank(slot, j);
    return s;
  }
}

// One problem per CTA (kCl false: the shared variant) or per cluster of C
// CTAs (kCl true), G threads per knot; the layout and the halo exchange in
// the header comment.
template <int G, bool kCl>
__global__ void __launch_bounds__(SMEM_THREADS) pcg_smem_kernel(const gato::PcgArgs a) {
  using gato::krylov::btd_rows_at;
  using gato::krylov::knot_total;
  using gato::krylov::rows_dot;
  static_assert(NX % G == 0, "a group takes NX / G rows");
  constexpr int R = NX / G;
  constexpr int H = kCl ? 1 : 0;  // slot of a CTA's first knot (0: the lower halo)
  extern __shared__ float smem[];
  const int N = a.N;
  int C = 1, rank = 0;
  if constexpr (kCl) {
    C = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int b = blockIdx.x / C;
  const int n = cta_knots(N, C);
  const int k0 = rank * n;
  const int cnt = min(n, N - k0);  // this CTA's knots, >= 1 (checked at launch)
  const int S = slot_stride(N, C);
  const int W = warp_threads(n);
  const int g = G == 1 ? 0 : (int)threadIdx.x / W;
  const int kl = (int)threadIdx.x - g * W;
  const bool in = kl < cnt;
  const int k = k0 + kl;  // the global knot
  const int s = kl + H;   // its slot
  const int r0 = g * R;
  const bool one_warp = G == 1 && W == 32;  // knot_total: shuffles only
  float* blk = smem;                   // (SB_FLOATS, S)
  float* sR = blk + SB_FLOATS * S;     // (NX, S)
  float* sP = sR + NX * S;             // (NX, S)
  float* partA = sP + NX * S;          // (G, W)
  float* partB = partA + G * W;        // (G, W)
  float* misc = partB + G * W;         // this CTA's totals
  float* hAp = misc + MISC_FLOATS;     // (2, NX): Ap rows of knots k0 - 1, k0 + cnt
  float* hZ = hAp + 2 * NX;            // (2, NX): their z rows
  auto local_sync = [&]() {
    if (one_warp)
      __syncwarp();
    else
      __syncthreads();
  };

  // ---- the blocks: own knots, and the lower blocks of knot k0 - 1 ----
  const size_t bN = (size_t)b * N, bL = (size_t)b * (N - 1);
  const int lo0 = kCl ? max(k0 - 1, 0) : 0;     // first lower block held
  const int lo1 = min(k0 + cnt, N - 1);         // one past the last
  copy_blocks(a.S_main + (bN + k0) * BLK, cnt, blk + SB_SM * S, S, H);
  copy_blocks(a.P_main + (bN + k0) * BLK, cnt, blk + SB_PM * S, S, H);
  copy_blocks(a.S_lower + (bL + lo0) * BLK, lo1 - lo0, blk + SB_SL * S, S, lo0 - k0 + H);
  copy_blocks(a.P_lower + (bL + lo0) * BLK, lo1 - lo0, blk + SB_PL * S, S, lo0 - k0 + H);

  const bool prev = k > 0, next = k < N - 1;
  // A range's first and last knot, where another CTA of the cluster holds
  // the neighbour: their threads keep this CTA's halo slots (0, cnt + 1)
  // of r and p, and send their own rows to the neighbour's halo: into its
  // upper halo (its slot n + 1, halo rows 1), or its lower one (slot 0,
  // halo rows 0).
  const bool lo_edge = kCl && kl == 0 && rank > 0;
  const bool hi_edge = kCl && in && kl == cnt - 1 && rank < C - 1;
  float *toAp_lo = hAp, *toAp_hi = hAp, *toZ_lo = hZ, *toZ_hi = hZ, *toP_lo = sP, *toP_hi = sP;
  if constexpr (kCl) {
    cg::cluster_group cl = cg::this_cluster();
    if (lo_edge) {
      toAp_lo = cl.map_shared_rank(hAp, rank - 1) + NX;
      toZ_lo = cl.map_shared_rank(hZ, rank - 1) + NX;
      toP_lo = cl.map_shared_rank(sP, rank - 1) + n + 1;
    }
    if (hi_edge) {
      toAp_hi = cl.map_shared_rank(hAp, rank + 1);
      toZ_hi = cl.map_shared_rank(hZ, rank + 1);
      toP_hi = cl.map_shared_rank(sP, rank + 1);
    }
  }
  auto send = [&](float* lo, float* hi, int stride, const float (&v)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (lo_edge) lo[(r0 + i) * stride] = v[i];
      if (hi_edge) hi[(r0 + i) * stride] = v[i];
    }
  };
  // knot kk in {k - 1, k, k + 1}, column c of r or p: every read is local
  auto reader = [&](const float* v) {
    return [=](int kk, int c) -> float { return v[c * S + s + (kk - k)]; };
  };
  const auto rvec = reader(sR);
  const auto pvec = reader(sP);

  // the warm start goes through sP for the first matvec
  float lam_r[R], r_r[R], p_r[R], z_r[R], ap_r[R];
  if constexpr (kCl) cg::this_cluster().sync();  // every CTA runs before a remote write
  if (in)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      lam_r[i] = a.lam0[(bN + k) * NX + r0 + i];
      sP[(r0 + i) * S + s] = lam_r[i];
    }
  if constexpr (kCl) {
    send(toP_lo, toP_hi, S, lam_r);
    cg::this_cluster().sync();
  } else {
    local_sync();
  }
  if (in) {
    btd_rows_at<NX, R>(blk, S, s, k, prev, next, r0, SB_SM, SB_SL, pvec, ap_r);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      r_r[i] = a.gamma[(bN + k) * NX + r0 + i] - ap_r[i];
      sR[(r0 + i) * S + s] = r_r[i];
    }
  }
  if constexpr (kCl) {
    send(toAp_lo, toAp_hi, 1, ap_r);
    cg::this_cluster().sync();
    // the halo knots' r, as their own CTA computes it
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (lo_edge) sR[(r0 + i) * S] = a.gamma[(bN + k - 1) * NX + r0 + i] - hAp[r0 + i];
      if (hi_edge)
        sR[(r0 + i) * S + cnt + 1] = a.gamma[(bN + k + 1) * NX + r0 + i] - hAp[NX + r0 + i];
    }
  }
  local_sync();  // r complete; every read of the warm start in sP done
  bool bad_local = false;
  if (in) {
    btd_rows_at<NX, R>(blk, S, s, k, prev, next, r0, SB_PM, SB_PL, rvec, z_r);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      p_r[i] = z_r[i];
      sP[(r0 + i) * S + s] = p_r[i];
      bad_local = bad_local || !(isfinite(r_r[i]) && isfinite(z_r[i]));
    }
  }
  if constexpr (kCl) send(toZ_lo, toZ_hi, 1, z_r);
  float rho = cluster_sum<kCl>(
      knot_total<G>(in ? rows_dot(r_r, z_r) : 0.0f, partB, W, cnt, kl, g, one_warp),
      misc + 1, C);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (lo_edge) sP[(r0 + i) * S] = hZ[r0 + i];
    if (hi_edge) sP[(r0 + i) * S + cnt + 1] = hZ[NX + r0 + i];
  }
  const bool bad =
      cluster_sum<kCl>(__syncthreads_or(bad_local) ? 1.0f : 0.0f, misc + 2, C) > 0.0f;
  const bool skip = a.skip[b] != 0;
  const bool dead0 = !skip && bad;
  const float rho_init = fabsf(rho);
  const float eps = a.eps[b];
  bool active = !skip && !dead0 && fabsf(rho) >= gato::PCG_ABS_TOL;
  int iters = 0;
  for (int it = 0; it < a.max_iters && active; ++it) {
    ++iters;
    if (in) btd_rows_at<NX, R>(blk, S, s, k, prev, next, r0, SB_SM, SB_SL, pvec, ap_r);
    if constexpr (kCl) send(toAp_lo, toAp_hi, 1, ap_r);
    const float pAp = cluster_sum<kCl>(
        knot_total<G>(in ? rows_dot(p_r, ap_r) : 0.0f, partA, W, cnt, kl, g, one_warp),
        misc, C);
    const float alpha = rho / (pAp == 0.0f ? 1.0f : pAp);
    // the same fused multiply-adds for a knot's own rows and a halo's copy
    if (in)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        lam_r[i] = fmaf(alpha, p_r[i], lam_r[i]);
        r_r[i] = fmaf(-alpha, ap_r[i], r_r[i]);
        sR[(r0 + i) * S + s] = r_r[i];
        if (lo_edge) sR[(r0 + i) * S] = fmaf(-alpha, hAp[r0 + i], sR[(r0 + i) * S]);
        if (hi_edge)
          sR[(r0 + i) * S + cnt + 1] =
              fmaf(-alpha, hAp[NX + r0 + i], sR[(r0 + i) * S + cnt + 1]);
      }
    local_sync();
    if (in) btd_rows_at<NX, R>(blk, S, s, k, prev, next, r0, SB_PM, SB_PL, rvec, z_r);
    if constexpr (kCl) send(toZ_lo, toZ_hi, 1, z_r);
    const float rho_new = cluster_sum<kCl>(
        knot_total<G>(in ? rows_dot(r_r, z_r) : 0.0f, partB, W, cnt, kl, g, one_warp),
        misc + 1, C);
    const bool converged = fabsf(rho_new) < gato::PCG_ABS_TOL + eps * rho_init;
    const float beta = rho_new / (rho == 0.0f ? 1.0f : rho);
    if (converged) {
      active = false;
    } else {
      if (in)
#pragma unroll
        for (int i = 0; i < R; ++i) {
          p_r[i] = fmaf(beta, p_r[i], z_r[i]);
          sP[(r0 + i) * S + s] = p_r[i];
          if (lo_edge) sP[(r0 + i) * S] = fmaf(beta, sP[(r0 + i) * S], hZ[r0 + i]);
          if (hi_edge)
            sP[(r0 + i) * S + cnt + 1] = fmaf(beta, sP[(r0 + i) * S + cnt + 1], hZ[NX + r0 + i]);
        }
      rho = rho_new;
    }
    local_sync();
  }
  if (dead0) iters = a.max_iters;
  if (in)
#pragma unroll
    for (int i = 0; i < R; ++i) a.lam[(bN + k) * NX + r0 + i] = lam_r[i];
  if (threadIdx.x == 0 && rank == 0) a.iters[b] = iters;
  // a CTA's shared memory must outlive every remote access to it
  if constexpr (kCl) cg::this_cluster().sync();
}

// The compiled variants: shared and cluster at G = 1, 2, 4; null otherwise.
Kernel smem_kernel(int layout, int G) {
  const bool cl = layout == kCluster;
  if (layout != kShared && !cl) return nullptr;
  switch (G) {
    case 1: return cl ? pcg_smem_kernel<1, true> : pcg_smem_kernel<1, false>;
    case 2: return cl ? pcg_smem_kernel<2, true> : pcg_smem_kernel<2, false>;
    case 4: return cl ? pcg_smem_kernel<4, true> : pcg_smem_kernel<4, false>;
    default: return nullptr;
  }
}

// A variant's kernel, launch configuration and bytes at horizon N, batch B,
// with the kernel's shared-memory attributes set. C is 1 in the shared
// variant and 2, 4, 8 or 16 in the cluster one, where every CTA must hold
// at least one knot; 16 is not portable and is allowed explicitly. Returns
// a CUDA error code.
int configure(int N, int B, int layout, int G, int C, void* stream, Kernel* kernel,
              cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *kernel = smem_kernel(layout, G);
  const bool size_ok = layout == kShared ? C == 1 : (C == 2 || C == 4 || C == 8 || C == 16);
  if (*kernel == nullptr || !size_ok || N < 1 || (C - 1) * cta_knots(N, C) >= N)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(N, G, C);
  cudaError_t err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * C);
  cfg->blockDim = dim3(G * warp_threads(cta_knots(N, C)));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = layout == kCluster ? 1 : 0;
  return 0;
}

// Clusters of a cluster variant that the card can hold at once
// (cudaOccupancyMaxActiveClusters); 0 is an error.
int active_clusters(Kernel kernel, const cudaLaunchConfig_t* cfg, int* clusters) {
  const cudaError_t err = cudaOccupancyMaxActiveClusters(clusters, kernel, cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return *clusters > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

int launch(const gato::PcgArgs* a, void* stream) {
  if (a->layout == kGlobal) {
    if (a->groups != 1 || a->cluster != 1) return static_cast<int>(cudaErrorInvalidValue);
    int threads;
    size_t smem;
    const Kernel kernel = global_kernel(a->N, &threads, &smem);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<a->B, threads, smem, static_cast<cudaStream_t>(stream)>>>(*a);
    return static_cast<int>(cudaGetLastError());
  }
  Kernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = configure(a->N, a->B, a->layout, a->groups, a->cluster, stream, &kernel, &cfg, &attr);
  if (err == 0 && a->layout == kCluster) {
    int clusters;
    err = active_clusters(kernel, &cfg, &clusters);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, *a));
}

}  // namespace

// Another nx than NX, or a variant that is not compiled or does not fit,
// returns a CUDA error code; nothing falls back to another variant.
extern "C" int gato_pcg(const gato::PcgArgs* args, int nx, void* stream) {
  if (nx != NX) return static_cast<int>(cudaErrorInvalidValue);
  return launch(args, stream);
}

// Dynamic shared memory of one CTA of a variant at horizon N, in bytes.
extern "C" long long gato_pcg_smem_bytes(int N, int layout, int G, int C) {
  if (layout == kGlobal) {
    int threads;
    size_t smem;
    global_kernel(N, &threads, &smem);
    return (long long)smem;
  }
  return (long long)smem_bytes(N, G, C);
}

// Resident CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and,
// for the cluster variant, the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; -1 for the others) of a variant at
// horizon N, batch B. Returns a CUDA error code.
extern "C" int gato_pcg_occupancy(int N, int B, int layout, int G, int C, int* ctas_per_sm,
                                  int* clusters) {
  *clusters = -1;
  if (layout == kGlobal) {
    int threads;
    size_t smem;
    const Kernel kernel = global_kernel(N, &threads, &smem);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, threads, smem);
    return static_cast<int>(err);
  }
  Kernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = configure(N, B, layout, G, C, nullptr, &kernel, &cfg, &attr);
  if (err != 0) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel, (int)cfg.blockDim.x, cfg.dynamicSmemBytes));
  if (err == 0 && layout == kCluster) err = active_clusters(kernel, &cfg, clusters);
  return err;
}
