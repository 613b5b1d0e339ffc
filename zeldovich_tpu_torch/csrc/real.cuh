// The element type of the kernels.  Every kernel template of csrc/ takes
// its real type F (float or double) as its first template parameter; a
// .cu file instantiates its templates for ONE type, zt_real, and names its
// C entry points ZT_ENTRY(name): float and `name` as the file stands,
// double and `name_f64` when it is compiled through its *_f64.cu twin,
// which defines ZT_F64 and includes it.  One translation unit a type keeps
// the two sets of instances in separate nvcc processes (the build runs one
// per .cu, all at once).
#pragma once

#include <cuda_runtime.h>

#ifdef ZT_F64
typedef double zt_real;
#define ZT_ENTRY(name) name##_f64
#else
typedef float zt_real;
#define ZT_ENTRY(name) name
#endif

namespace zt {

template <typename F>
struct vec2_of;
template <>
struct vec2_of<float> {
  typedef float2 type;
};
template <>
struct vec2_of<double> {
  typedef double2 type;
};

// the CUDA pair of F: float2 (8-byte aligned) or double2 (16-byte aligned)
template <typename F>
using vec2 = typename vec2_of<F>::type;

template <typename F>
__host__ __device__ __forceinline__ vec2<F> make2(F x, F y) {
  vec2<F> v;
  v.x = x;
  v.y = y;
  return v;
}

// the type this translation unit instantiates, and its pair
typedef zt_real real;
typedef vec2<zt_real> real2;

// a product rounded once, never contracted into a multiply-add
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

}  // namespace zt
