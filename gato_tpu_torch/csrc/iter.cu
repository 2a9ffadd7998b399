// The core of one SQP iteration without the merit and the line search:
// KKT setup, Schur condensation, PCG and dz recovery in one launch, one
// thread block per problem (N <= 128).
//
// Replaces gato_tpu/ops/pallas_iter.py::_iter_kernel (body iter_channels),
// the fused-iteration route of gato_tpu/solver/bsqp.py. The body is
// sqp_iter.cuh's sqp_iteration<false, layout, G>: phases A-E of
// csrc/bsqp_iter.cu, the same code, so the two kernels cannot drift apart.
// The outputs are dz, lam and the PCG count as they come out of phase E:
// the step_ok scrub, the merit (csrc/merit.cu) and the line search follow
// on the host's route (ops/cuda_solve.py::sqp_iter_fused), as the JAX
// package's after_solve follows its kernel. The plain PyTorch version is
// ops/cuda_iter.py::sqp_iter_core_reference. It is compiled once per plant
// (csrc/robot.cuh), for indy7 and iiwa14: entry points gato_iter_<plant>.
//
// Bound: as bsqp_iter's phases A-E. Up to N = 64 the PCG loop reads the
// four NX x NX blocks of each knot from shared memory, G groups of threads
// sharing a knot's rows, so its traffic stays on the SM, and what bounds
// the kernel is phases A-C + E: the registers of the generated knot_kkt
// (it spills), at the residency that shared memory leaves (2 blocks per SM
// at N = 32). Past N = 64 the blocks stay in an element-major global
// scratch. None of the TPU kernel's (8,128) channel packing or segment
// packing is carried over.
#include "sqp_iter.cuh"

extern "C" int gato_iter_knot_floats() { return gato::iter_detail::KNOT_FLOATS; }

extern "C" long long gato_iter_smem_bytes(int N, int layout, int G) {
  return (long long)gato::iter_detail::smem_bytes(N, static_cast<gato::Blocks>(layout), G);
}

extern "C" int gato_iter_blocks_per_sm(int N, int layout, int G, int staged) {
  return gato::blocks_per_sm<false>(N, layout, G, staged);
}

extern "C" int GATO_ENTRY(gato_iter)(const gato::IterArgs* args, int layout, int G,
                                     int staged, void* stream) {
  return gato::launch_iteration<false>(args, layout, G, staged, stream);
}
