// Math helpers for the generated per-robot headers (csrc/generated/*.cuh).
// GATO_HD makes every function callable from host C++ (T = double, the
// CPU tests) and from CUDA device code (T = float, the kernels).
#pragma once
#include <cmath>

#ifdef __CUDACC__
#define GATO_HD __host__ __device__
#else
#define GATO_HD
#endif

namespace gato {

GATO_HD inline float gsqrt(float x) { return sqrtf(x); }
GATO_HD inline double gsqrt(double x) { return sqrt(x); }
GATO_HD inline float gsin(float x) { return sinf(x); }
GATO_HD inline double gsin(double x) { return sin(x); }
GATO_HD inline float gcos(float x) { return cosf(x); }
GATO_HD inline double gcos(double x) { return cos(x); }
GATO_HD inline float glog(float x) { return logf(x); }
GATO_HD inline double glog(double x) { return log(x); }
GATO_HD inline float gabs(float x) { return fabsf(x); }
GATO_HD inline double gabs(double x) { return fabs(x); }
// max(x, c) that keeps a NaN x, as torch.clamp_min and jnp.maximum do
// (fmax would return c)
template <typename T>
GATO_HD inline T gmax(T x, T c) { return (x > c || x != x) ? x : c; }

}  // namespace gato
