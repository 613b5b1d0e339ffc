// Shared-memory radix-2 FFT and launch helpers for the zeldovich_tpu_torch
// kernels (csrc/synth.cu, csrc/c2r.cu, csrc/fft_axis.cu).
//
// The transforms are unnormalized (no 1/N), in the FFTW sign convention of
// the JAX package; the sign is the twiddle table's.  Lengths are powers of
// two.  Twiddles come from a table w[j] = exp(sign 2 pi i j / n), j in
// [0, n/2), computed in double precision on the host and rounded once to
// float, so the float32 error of a length-n transform stays near
// 1e-7 * log2(n).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace zt {

__device__ __forceinline__ unsigned bitrev(unsigned v, int logn) {
  return __brev(v) >> (32 - logn);
}

// Shared-memory slot of element q.  PAD leaves one float2 free after every
// 16: bit-reversed stores of consecutive row elements (multiples of 16
// apart for n >= 512) then spread over all banks instead of hitting one.
template <bool PAD>
__device__ __forceinline__ int slot(int q) {
  return PAD ? q + (q >> 4) : q;
}

// In-place DFT of `nbatch` sequences of length n = 2^logn held in
// shared memory in BIT-REVERSED order: element k of sequence b sits at
// buf[slot<PAD>(b * bstride + k * kstride)].  Iterative decimation in
// time; every thread of the block takes part, and the function ends on a
// barrier.  BATCH_FAST maps consecutive threads to consecutive sequences
// (column layouts, bstride == 1); otherwise to consecutive butterflies of
// one sequence (row layouts, kstride == 1).  nbatch is a power of two.
template <bool BATCH_FAST, bool PAD = false>
__device__ void fft_smem(float2* buf, int logn, int lognbatch, int bstride,
                         int kstride, const float2* __restrict__ tw) {
  const int lognbf = logn - 1;  // n/2 butterflies per sequence per stage
  const int total = 1 << (lognbf + lognbatch);
  for (int s = 1; s <= logn; ++s) {
    const int hm = 1 << (s - 1);
    const int twshift = logn - s;  // twiddle index = pos * n / 2^s
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      int b, j;
      if (BATCH_FAST) {
        b = t & ((1 << lognbatch) - 1);
        j = t >> lognbatch;
      } else {
        j = t & ((1 << lognbf) - 1);
        b = t >> lognbf;
      }
      const int pos = j & (hm - 1);
      const int i1 = ((j >> (s - 1)) << s) + pos;
      const float2 w = __ldg(&tw[pos << twshift]);
      const int q1 = b * bstride + i1 * kstride;
      float2* p1 = buf + slot<PAD>(q1);
      float2* p2 = buf + slot<PAD>(q1 + hm * kstride);
      const float2 a = *p1;
      const float2 c = *p2;
      const float2 wc = make_float2(w.x * c.x - w.y * c.y, w.x * c.y + w.y * c.x);
      *p1 = make_float2(a.x + wc.x, a.y + wc.y);
      *p2 = make_float2(a.x - wc.x, a.y - wc.y);
    }
    __syncthreads();
  }
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__host__ __device__ inline int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace zt
