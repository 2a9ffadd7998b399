// One SQP iteration of the batched solve: one thread block per problem, one
// thread per knot. The body is sqp_iter.cuh's sqp_iteration<true>; its
// phases A-E are shared with csrc/iter.cu.
//
// Replaces gato_tpu/ops/pallas_solve.py::_solve_kernel as launched by
// sqp_solve_pallas_chained (one launch per SQP iteration, the whole-batch
// exit decided between launches by the host loop,
// gato_tpu_torch/ops/cuda_solve.py::sqp_solve_chained). Phases A-G are
// listed in sqp_iter.cuh.
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
#include "sqp_iter.cuh"

namespace {

__global__ void __launch_bounds__(128)
bsqp_iter_kernel(const gato::IterArgs a) {
  gato::sqp_iteration<true>(a);
}

}  // namespace

extern "C" int gato_bsqp_iter_knot_floats() { return gato::iter_detail::KNOT_FLOATS; }

extern "C" int gato_bsqp_iter_indy7(const gato::IterArgs* args, void* stream) {
  return gato::launch_iteration(bsqp_iter_kernel, args, stream);
}
