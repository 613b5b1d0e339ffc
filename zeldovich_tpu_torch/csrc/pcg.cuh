// The pcg64 draw chain on the device, shared by the synthesis kernels
// (csrc/synth.cu, B1 and B3; csrc/boxmuller.cu, B4 and B5).
//
// A mode's first-draw state is one 128-bit multiply-add of its y-plane
// start state with the precomposed, pre-bumped (z, x) jump map (see
// zeldovich_tpu/ops/pcg.py); the second draw is one LCG step later.  The
// float32 draws follow the JAX package's fast semantics op for op
// (pcg_device.fast_uniform_f32 and the minimax sincos_2pi, ROADMAP C3);
// the float64 draws its exact ones (uniform_from_u64: (r + 1) 2^-64
// rounded to nearest, the all-ones draw 1.0; library log, cos and sin of
// fl(2 pi) T).  The integer stream is the same, bit for bit, for both.
#pragma once

#include "real.cuh"

namespace zt {

typedef unsigned long long u64;
typedef unsigned __int128 u128;

// pcg64 LCG constants (reference pcg_random.hpp:163,169)
__device__ __forceinline__ u128 pcg_mult() {
  return ((u128)2549297995355413924ULL << 64) | (u128)4865540595714422341ULL;
}
__device__ __forceinline__ u128 pcg_inc() {
  return ((u128)6364136223846793005ULL << 64) | (u128)1442695040888963407ULL;
}

__device__ __forceinline__ u128 load_u128(const u64* __restrict__ lo,
                                          const u64* __restrict__ hi) {
  return ((u128)__ldg(hi) << 64) | (u128)__ldg(lo);
}

// XSL-RR output permutation of a 128-bit state -> 64-bit draw.
__device__ __forceinline__ u64 xsl_rr(u128 s) {
  const u64 x = (u64)(s >> 64) ^ (u64)s;
  const unsigned rot = (unsigned)(s >> 122);
  return (x >> rot) | (x << ((64u - rot) & 63u));
}

// The JAX package's fast float32 uniform (pcg_device.fast_uniform_f32):
// ~(r + 1) * 2^-64 in (0, 1 + 2^-32], op for op.  The products are exact
// (powers of two), so contraction into FMA cannot change the result.
__device__ __forceinline__ float i32f(unsigned v) {
  return __int2float_rn((int)(v ^ 0x80000000u));
}
__device__ __forceinline__ float fast_uniform(u64 r) {
  const float a = i32f((unsigned)(r >> 32)) * 0x1p-32f + 0.5f;
  const float b = i32f((unsigned)r) * 0x1p-64f + 0x1.000002p-33f;
  return a + b;
}

// The JAX package's minimax (cos 2 pi T, sin 2 pi T) (pcg_device.sincos_2pi):
// quadrant reduction with round-half-even (rintf), then one polynomial
// pair.  Coefficients are the float64 fits rounded once to float.
__device__ __forceinline__ void sincos_2pi(float T, float* c_out, float* s_out) {
  const float t = T - rintf(T);
  const float q = rintf(t + t);
  const float r = t - q * 0.5f;
  const float u = r * r;
  float c = (float)56.240540440829314;
  float s = (float)39.535813712149924;
  c = c * u + (float)-85.24010035715638;
  s = s * u + (float)-76.54965682070578;
  c = c * u + (float)64.93458164580112;
  s = s * u + (float)81.6009981926163;
  c = c * u + (float)-19.739171322478587;
  s = s * u + (float)-41.34165492934352;
  c = c * u + (float)0.9999999532476083;
  s = s * u + (float)6.283185159611168;
  s = s * r;
  const float sign = 1.0f - (fabsf(q) + fabsf(q));
  *c_out = sign * c;
  *s_out = sign * s;
}

// The exact float64 uniform (the JAX package's uniform_from_u64, the
// reference's one_rand): (r + 1) * 2^-64 in (0, 1], r + 1 rounded to
// nearest in one convert; the all-ones draw, whose r + 1 wraps, is 1.0.
__device__ __forceinline__ double exact_uniform(u64 r) {
  return r == ~0ULL ? 1.0 : __ull2double_rn(r + 1) * 0x1p-64;
}

template <typename F>
__device__ __forceinline__ F uniform(u64 r) {
  if constexpr (sizeof(F) == 4) {
    return fast_uniform(r);
  } else {
    return exact_uniform(r);
  }
}

// A mode's two uniforms (R, T) from its first-draw state s1: the integer
// half of its work (the LCG step to the second state, two XSL-RR draws).
template <typename F>
__device__ __forceinline__ vec2<F> mode_uniforms(u128 s1) {
  const u128 s2 = s1 * pcg_mult() + pcg_inc();
  return make2<F>(uniform<F>(xsl_rr(s1)), uniform<F>(xsl_rr(s2)));
}

// The float half: D = live * cgauss(pk) from (R, T), amp = sqrt(pk) (fixed
// power) or sqrt(-pk log R), then (amp cos 2 pi T, amp sin 2 pi T), each
// product rounded as the JAX package rounds it (live * amp first, as its
// _draw_chain does).
__device__ __forceinline__ float2 mode_deviate(float2 RT, float pk, bool fixed_power,
                                               float live) {
  float amp = fixed_power ? sqrtf(pk) : sqrtf(-pk * logf(RT.x));
  amp = __fmul_rn(live, amp);
  float cv, sv;
  sincos_2pi(RT.y, &cv, &sv);
  return make_float2(__fmul_rn(amp, cv), __fmul_rn(amp, sv));
}

// The same in double: the library's log, cos and sin, the angle
// fl(2 pi) * T as the JAX package's float64 branch forms it.
__device__ __forceinline__ double2 mode_deviate(double2 RT, double pk, bool fixed_power,
                                                double live) {
  double amp = fixed_power ? sqrt(pk) : sqrt(__dmul_rn(-pk, log(RT.x)));
  amp = __dmul_rn(live, amp);
  // T is in (0, 1]: the angle never reaches sincos's large-argument
  // reduction, but the call and its 40-byte result buffer are compiled in
  // (the stack frame that ptxas reports for every double draw kernel)
  double cv, sv;
  sincos(__dmul_rn(6.283185307179586, RT.y), &sv, &cv);
  return make_double2(__dmul_rn(amp, cv), __dmul_rn(amp, sv));
}

// One mode's deviate from its first-draw state.  A kernel that walks
// several modes a thread calls the two halves itself, so that one mode's
// integer chain can run beside another's logarithm (B4).
template <typename F>
__device__ __forceinline__ vec2<F> gaussian_mode(u128 s1, F pk, bool fixed_power, F live) {
  return mode_deviate(mode_uniforms<F>(s1), pk, fixed_power, live);
}

}  // namespace zt
