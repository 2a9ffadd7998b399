// The core of one SQP iteration without the merit and the line search:
// KKT setup, Schur condensation, PCG and dz recovery in one launch, one
// thread block per problem and one thread per knot (N <= 128).
//
// Replaces gato_tpu/ops/pallas_iter.py::_iter_kernel (body iter_channels),
// the fused-iteration route of gato_tpu/solver/bsqp.py. The body is
// sqp_iter.cuh's sqp_iteration<false>: phases A-E of csrc/bsqp_iter.cu,
// the same code, so the two kernels cannot drift apart. The outputs are dz,
// lam and the PCG count as they come out of phase E: the step_ok scrub, the
// merit (csrc/merit.cu) and the line search follow on the host's route
// (ops/cuda_solve.py::sqp_iter_fused), as the JAX package's after_solve
// follows its kernel. The plain PyTorch version is
// ops/cuda_iter.py::sqp_iter_core_reference.
//
// Bound: as bsqp_iter's phases A-E. The generated knot_kkt spills its
// registers to local memory and the PCG loop reads the four 12x12 blocks of
// each knot from an element-major global scratch every iteration; the
// launch lasts as long as its slowest problem's Krylov loop. None of the
// TPU kernel's (8,128) channel packing or segment packing is carried over.
#include "sqp_iter.cuh"

namespace {

__global__ void __launch_bounds__(128)
iter_kernel(const gato::IterArgs a) {
  gato::sqp_iteration<false>(a);
}

}  // namespace

extern "C" int gato_iter_knot_floats() { return gato::iter_detail::KNOT_FLOATS; }

extern "C" int gato_iter_indy7(const gato::IterArgs* args, void* stream) {
  return gato::launch_iteration(iter_kernel, args, stream);
}
