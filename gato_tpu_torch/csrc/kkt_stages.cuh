// The staged per-knot KKT: the generated knot_kkt cut into stages that a
// group of G threads of one knot runs (csrc/kkt.cu, and phase A of
// csrc/sqp_iter.cuh's shared layout):
//   1  part 0: knot_dyn (qdd and Minv: RNEA bias, CRBA, Cholesky, 7 solves)
//      into the knot's DYN_FLOATS of shared memory; part 1: knot_cost (FK,
//      Q, q, R, r), at the same time;
//   2  after a barrier, part P: knot_dual<G, P> (the dual RNEA at qdd, the
//      dID columns of its tangent directions, in registers) and knot_ab<G,
//      P> (those columns of A from dqdd = -Minv dID, B's columns c = P mod
//      G from Minv); part G-1 also the defect c (knot_defect).
// The split of the 12 directions (KKT_DIRS_G<G> in the generated header)
// balances the parts' straight-line code (about 2.7k lines each at G = 4
// against knot_kkt's 13.2k), so each thread's live set is a part's.
#pragma once
#include "robot.cuh"

#ifndef GATO_KKT_STAGES
#error "the staged KKT needs a plant generated with a split (dynamics/codegen.py KKT_SPLITS)"
#endif

namespace gato {
namespace kkt_stages {

constexpr int NQ = robot::NQ;
constexpr int NX = robot::NX;
// a knot's qdd (NQ) and Minv (NQ x NQ, column-major: Minv[c NQ + r]) in
// shared memory; odd, so that a warp's 32 knots fall on 32 banks
constexpr int DYN_FLOATS = NQ + NQ * NQ + 1;

// Stage 2 of part `part` (warp-uniform) of G: its dID columns, then its A
// and B columns. The runtime part picks the compile-time one.
template <int G, typename O, int P = 0>
__device__ __forceinline__ void tangent_part(int part, const float* q, const float* qd,
                                             const float* dyn, const float* fe, float dt, O A,
                                             O B) {
  if constexpr (P < G) {
    if (part == P) {
      float dID[NQ * NX];
      robot::knot_dual<G, P, float, float*>(q, qd, dyn, fe, dID);
      robot::knot_ab<G, P, float, O>(dyn + NQ, dID, dt, A, B);
    } else {
      tangent_part<G, O, P + 1>(part, q, qd, dyn, fe, dt, A, B);
    }
  }
}

}  // namespace kkt_stages
}  // namespace gato
