// The plant a kernel library is compiled for. gato_tpu_torch/_build.py
// compiles each csrc/<kernel>.cu once per plant of its row in _build.KERNELS,
// with -DGATO_ROBOT=<plant>: this header then includes that plant's
// generated header (csrc/generated/<plant>.cuh), makes gato::robot an alias
// of its namespace (NQ, NX and the generated functions), and GATO_ENTRY(fn)
// names a C entry point fn_<plant>, so that the wrapper finds the entry of
// the plant it asked for or none.
#pragma once

#ifndef GATO_ROBOT
#error "compile with -DGATO_ROBOT=<plant> (indy7, iiwa14): see gato_tpu_torch/_build.py"
#endif

#define GATO_STR_(x) #x
#define GATO_STR(x) GATO_STR_(x)
#define GATO_CAT_(a, b) a##_##b
#define GATO_CAT(a, b) GATO_CAT_(a, b)
#define GATO_ENTRY(fn) GATO_CAT(fn, GATO_ROBOT)

#include GATO_STR(generated/GATO_ROBOT.cuh)

namespace gato {
namespace robot = ::gato::GATO_ROBOT;
}  // namespace gato
