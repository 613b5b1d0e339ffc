// Register-resident mixed-radix Stockham FFT for every transform of the
// port (csrc/fft_pass.cuh lays it out along columns and rows),
// unnormalized, in the FFTW sign convention of the JAX package; the sign
// is the twiddle table's: w[j] = exp(sign 2 pi i j / N), j < N/2, computed
// in double precision on the host and, for the float instances, rounded
// once to float.  Every template takes the element type F (float or
// double, real.cuh) first; the plan, the index maps and the exchanges are
// the same for both.
//
// A length-N sequence (N a power of two in [16, 2048]) is transformed in
// P <= 3 radix passes of radix 16, 8 or 4 (plan below):
//
//   N     16   32    64    128    256     512     1024     2048
//   radix 16   8,4   8,8   16,8   16,16   8,8,8   16,8,8   16,16,8
//
// T = N / E threads share one sequence, E = the largest radix of the plan,
// and each holds E elements in registers.  Pass p (radix R, Ns = the
// product of the radices before it) takes, for each of the thread's E/R
// butterflies j = t + b * T, the elements j + r * N/R (r < R), multiplies
// element r by w^(r * (j mod Ns) * N/(Ns R)) (w = the table's
// exp(sign 2 pi i / N)), runs a radix-R DFT in registers and leaves output
// r for index (j / Ns) * Ns * R + (j mod Ns) + r * Ns (Govindaraju et al.,
// SC 2008): the result is in natural order, with no bit reversal.  The
// first pass reads j + r * N/R0 with j = t, and the last writes
// j + r * N/R_last: both go straight between device memory and registers.
// Shared memory carries only the P - 1 exchanges between passes.
//
// tests/test_torch_fft.py holds a plain torch model of exactly this
// schedule (the same plan, index maps and table lookups) against torch.fft
// and the JAX package's Pallas kernels at every N.
#pragma once

#include "real.cuh"

namespace zt {
namespace reg {

__host__ __device__ constexpr int npass(int n) { return n == 16 ? 1 : n >= 512 ? 3 : 2; }

__host__ __device__ constexpr int radix(int n, int p) {
  return p >= npass(n) ? 1
         : n == 16   ? 16
         : n == 32   ? (p == 0 ? 8 : 4)
         : n == 64   ? 8
         : n == 128  ? (p == 0 ? 16 : 8)
         : n == 256  ? 16
         : n == 512  ? 8
         : n == 1024 ? (p == 0 ? 16 : 8)
                     : (p == 2 ? 8 : 16);
}

// elements a thread holds: the first (largest) radix
__host__ __device__ constexpr int elems(int n) { return radix(n, 0); }

// product of the radices of passes before p
__host__ __device__ constexpr int stride_before(int n, int p) {
  return p == 0 ? 1 : stride_before(n, p - 1) * radix(n, p - 1);
}

__host__ __device__ constexpr int log2c(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// the low `bits` bits of v reversed
__host__ __device__ constexpr int brev(int v, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((v >> i) & 1) << (bits - 1 - i);
  return r;
}

// cos(2 pi m / 16), the literals rounded once to F
template <typename F>
__host__ __device__ constexpr F cos16(int m);
template <>
__host__ __device__ constexpr float cos16<float>(int m) {
  return (m & 15) == 0   ? 1.0f
         : (m & 15) == 1 ? 0.923879532511286756f
         : (m & 15) == 2 ? 0.707106781186547524f
         : (m & 15) == 3 ? 0.382683432365089772f
         : (m & 15) == 4 ? 0.0f
         : (m & 15) < 8  ? -cos16<float>(8 - (m & 15))
                         : -cos16<float>((m & 15) - 8);
}
template <>
__host__ __device__ constexpr double cos16<double>(int m) {
  return (m & 15) == 0   ? 1.0
         : (m & 15) == 1 ? 0.923879532511286756
         : (m & 15) == 2 ? 0.707106781186547524
         : (m & 15) == 3 ? 0.382683432365089772
         : (m & 15) == 4 ? 0.0
         : (m & 15) < 8  ? -cos16<double>(8 - (m & 15))
                         : -cos16<double>((m & 15) - 8);
}

template <typename F>
__device__ __forceinline__ vec2<F> cmul(vec2<F> a, vec2<F> w) {
  return make2<F>(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// a * exp(s 2 pi i K / L), L <= 16, s = +-1
template <typename F, int L, int K>
__device__ __forceinline__ vec2<F> rot(vec2<F> a, F s) {
  constexpr int m = K * 16 / L;
  if constexpr (m == 0) {
    return a;
  } else if constexpr (m == 4) {
    return make2<F>(-s * a.y, s * a.x);
  } else {
    constexpr F c = cos16<F>(m), d = cos16<F>(m + 12);  // cos, sin
    return cmul<F>(a, make2<F>(c, s * d));
  }
}

template <typename F, int L, int I, int OFF>
__device__ __forceinline__ void dif_stage(vec2<F>* v, F s) {
  if constexpr (I < L / 2) {
    const vec2<F> a = v[OFF + I], b = v[OFF + I + L / 2];
    v[OFF + I] = make2<F>(a.x + b.x, a.y + b.y);
    v[OFF + I + L / 2] = rot<F, L, I>(make2<F>(a.x - b.x, a.y - b.y), s);
    dif_stage<F, L, I + 1, OFF>(v, s);
  }
}

template <typename F, int L, int OFF>
__device__ __forceinline__ void dif(vec2<F>* v, F s) {
  if constexpr (L > 1) {
    dif_stage<F, L, 0, OFF>(v, s);
    dif<F, L / 2, OFF>(v, s);
    dif<F, L / 2, OFF + L / 2>(v, s);
  }
}

// Swaps v[OFF + K] with v[OFF + brev(K)]: every index a compile-time
// constant, so the array stays in registers (a bit reversal computed at
// run time would index it dynamically and move it to local memory).
template <typename F, int R, int OFF, int K = 0>
__device__ __forceinline__ void unscramble(vec2<F>* v) {
  if constexpr (K < R) {
    constexpr int J = brev(K, log2c(R));
    if constexpr (K < J) {
      const vec2<F> x = v[OFF + K];
      v[OFF + K] = v[OFF + J];
      v[OFF + J] = x;
    }
    unscramble<F, R, OFF, K + 1>(v);
  }
}

// In-register DFT of v[OFF, OFF + L), natural order in and out: radix-2
// decimation in frequency, then the bit-reversal as register renaming.
template <typename F, int L, int OFF>
__device__ __forceinline__ void dft_regs(vec2<F>* v, F s) {
  dif<F, L, OFF>(v, s);
  unscramble<F, L, OFF>(v);
}

// w^k from the half table tw[j] = exp(sign 2 pi i j / N), j < N/2, k < N
template <typename F, int N>
__device__ __forceinline__ vec2<F> twiddle(const vec2<F>* __restrict__ tw, int k) {
  const vec2<F> w = __ldg(&tw[k & (N / 2 - 1)]);
  return (k & (N / 2)) ? make2<F>(-w.x, -w.y) : w;
}

// Butterfly B (and the ones after it) of pass P on the thread's
// registers v[B * R + r], for j = t + B * T, in place.
template <typename F, int N, int P, int B = 0>
__device__ __forceinline__ void butterflies(vec2<F>* v, int t,
                                            const vec2<F>* __restrict__ tw, F s) {
  constexpr int R = radix(N, P), E = elems(N), T = N / E, NS = stride_before(N, P);
  if constexpr (B < E / R) {
    if constexpr (NS > 1) {
      const int k = ((t + B * T) % NS) * (N / (NS * R));
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[B * R + r] = cmul<F>(v[B * R + r], twiddle<F, N>(tw, r * k));
    }
    dft_regs<F, R, B * R>(v, s);
    butterflies<F, N, P, B + 1>(v, t, tw, s);
  }
}

// Element offset of index i of a sequence in a shared-memory plane: one
// element of padding after every 2^S indices spreads the exchange's
// strided accesses over the banks; STRIDE is the distance of consecutive
// indices (the tile's width for columns, 1 for rows) and lane the
// sequence's own offset.
template <int S, int STRIDE>
__device__ __forceinline__ int smem_at(int lane, int i) {
  return lane + (i + (i >> S)) * STRIDE;
}

// Indices one sequence spans under smem_at<S, STRIDE> (in units of STRIDE).
__host__ __device__ constexpr int padded(int n, int s) { return n + (n >> s); }

// The exchange after pass P through the shared-memory planes sre, sim:
// each output goes to its index (j / Ns) * Ns * R + (j mod Ns) + r * Ns,
// then every thread reads the elements of pass P + 1's butterflies.  A
// thread carries C sequences of adjacent lanes (lane, lane + 1), C = 1
// or 2: v[c * E + e]; with C = 2 (lane even) each access moves the pair
// as one word of two elements (float alone: fft_pass.cuh's cols_c).
template <typename F, int N, int P, int S, int STRIDE, int C = 1>
__device__ __forceinline__ void exchange(vec2<F>* v, int t, F* sre, F* sim, int lane) {
  static_assert(C == 1 || C == 2, "one or two sequences a thread");
  constexpr int R = radix(N, P), E = elems(N), T = N / E, NS = stride_before(N, P);
  constexpr int R2 = radix(N, P + 1);
  if constexpr (P > 0) __syncthreads();  // the last exchange's reads are done
#pragma unroll
  for (int b = 0; b < E / R; ++b) {
    const int j = t + b * T;
    const int d = (j / NS) * NS * R + j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = smem_at<S, STRIDE>(lane, d + r * NS);
      const vec2<F> x = v[b * R + r];
      if constexpr (C == 2) {
        const vec2<F> y = v[E + b * R + r];
        *reinterpret_cast<vec2<F>*>(sre + a) = make2<F>(x.x, y.x);
        *reinterpret_cast<vec2<F>*>(sim + a) = make2<F>(x.y, y.y);
      } else {
        sre[a] = x.x;
        sim[a] = x.y;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < E / R2; ++b) {
#pragma unroll
    for (int r = 0; r < R2; ++r) {
      const int a = smem_at<S, STRIDE>(lane, t + b * T + r * (N / R2));
      if constexpr (C == 2) {
        const vec2<F> re = *reinterpret_cast<const vec2<F>*>(sre + a);
        const vec2<F> im = *reinterpret_cast<const vec2<F>*>(sim + a);
        v[b * R2 + r] = make2<F>(re.x, im.x);
        v[E + b * R2 + r] = make2<F>(re.y, im.y);
      } else {
        v[b * R2 + r] = make2<F>(sre[a], sim[a]);
      }
    }
  }
}

}  // namespace reg

// A kernel's dynamic shared memory as elements of F.  One untyped array
// for every instance: an extern array of the element type itself would be
// declared with two types where one file held both instances.
template <typename F>
__device__ __forceinline__ F* shared_elems() {
  extern __shared__ __align__(16) unsigned char zt_smem[];
  return reinterpret_cast<F*>(zt_smem);
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace zt
