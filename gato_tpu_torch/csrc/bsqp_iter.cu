// One SQP iteration of the batched solve: one thread block per problem. The
// body is sqp_iter.cuh's sqp_iteration<true, layout, G>; its phases A-E are
// shared with csrc/iter.cu.
//
// Replaces gato_tpu/ops/pallas_solve.py::_solve_kernel as launched by
// sqp_solve_pallas_chained (one launch per SQP iteration, the whole-batch
// exit decided between launches by the host loop,
// gato_tpu_torch/ops/cuda_solve.py::sqp_solve_chained). Phases A-G are
// listed in sqp_iter.cuh.
// The semantics follow pallas_solve.solve_channels with the internal exit
// disabled (chained mode), and the plain PyTorch version
// ops/cuda_solve.py::sqp_iter_reference. It is compiled once per plant
// (csrc/robot.cuh), for indy7 and iiwa14: entry points
// gato_bsqp_iter_<plant>.
//
// Bound: the PCG loop (phase D) was bound by re-reading each knot's four
// 12x12 blocks (~2.3 KB per knot per iteration) from a global scratch that
// the L2 cache does not hold, with one warp per problem at N = 32. Up to
// N = 64 (they would fit up to 86), phases A-C now write the blocks into shared memory
// and the Krylov loop reads them there, as the TPU kernel keeps them in
// VMEM; G groups of threads share each knot's rows
// (ops/cuda_iter.py::iteration_variant picks the variant by N), so the
// loop's traffic (432 floats a knot per matvec) stays on the SM. What
// bounds the kernel then is phases A-C + E, the registers of the generated
// knot_kkt (it spills), run by group 0 alone; the shared memory costs
// residency (87 KB a block at N = 32: 2 problems per SM, two waves for a
// batch of 512), which they did not feel in PERF.md's measurement. Past
// N = 64 the blocks stay in the global scratch (the kGlobal layout).
//
// NaN containment is per block: a diverged problem cannot reach another
// one. Two behaviours still follow the TPU kernel: a problem whose
// warm-started residual is non-finite reports max_pcg_iters without
// iterating, and a non-finite step is zeroed for the whole problem
// (step_ok) so its line search fails with the trajectory untouched. Per-knot
// merit terms are clamped to 1e30 (pallas_solve._segsum) so a diverged
// problem's merit stays finite.
#include "sqp_iter.cuh"

extern "C" int gato_bsqp_iter_knot_floats() { return gato::iter_detail::KNOT_FLOATS; }

extern "C" long long gato_bsqp_iter_smem_bytes(int N, int layout, int G) {
  return (long long)gato::iter_detail::smem_bytes(N, static_cast<gato::Blocks>(layout), G);
}

extern "C" int gato_bsqp_iter_blocks_per_sm(int N, int layout, int G, int staged) {
  return gato::blocks_per_sm<true>(N, layout, G, staged);
}

extern "C" int GATO_ENTRY(gato_bsqp_iter)(const gato::IterArgs* args, int layout, int G,
                                          int staged, void* stream) {
  return gato::launch_iteration<true>(args, layout, G, staged, stream);
}
