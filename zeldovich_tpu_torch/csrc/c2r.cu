// B2: half-spectrum complex-to-real inverse DFT along y, for one H100
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   zeldovich_tpu/ops/pallas_fft.py::c2r_y_folded_pallas
// (bodies _c2r_kernel, _c2r_math).  Contract: in g (narray, 2, 2, ky, Z, X)
// float32 = (array, +/- packing, re/im, ky, z, x), z and x already
// transformed; out (narray, 2, n, Z, X) float32 with re = D and im = F of
// the two real fields packed as S+- = D~ +- i F~; unnormalized, sign +1;
// the imaginary parts of the DC and Nyquist rows are dropped.  ky is
// n/2 + 1 (Nyquist row present) or n/2 (Nyquist-free producer); n is
// given by the caller, never inferred from ky's parity.
//
// What bounds it.  It reads 4 and writes 2 float32 per (ky, z, x) and per
// (y, z, x) of each array and does ~5 log2(n) flops per output: bound by
// device-memory traffic.
//
// Design.  D and F are both real, so one complex sequence carries both:
//   Z(k) = S+(k)           for 0 < k < n/2,
//   Z(n - k) = conj(S-(k)) for 0 < k < n/2,
//   Z(0) = Re D~(0) + i Re F~(0), Z(n/2) likewise (zero if absent),
// and its unnormalized inverse DFT is D + iF exactly (for any S+-, since
// S+ e + conj(S- e) = 2 Re(D~ e) + i 2 Re(F~ e)).  One block per
// (x tile, z, array) builds the tile's y-columns in shared memory (reads
// coalesced along x), runs one length-n complex inverse FFT per column and
// writes re and im planes, coalesced along x.  A real-input FFT of half
// length would halve the flops; the bytes are the bound, so it waits.

#include "fft_smem.cuh"

namespace {

__global__ void __launch_bounds__(256) c2r_y_kernel(const float* __restrict__ g,
                                                    const float2* __restrict__ tw,
                                                    float* __restrict__ out, int n,
                                                    int logn, int rows, int has_nyq,
                                                    int tx, int logtx) {
  extern __shared__ float2 cols[];  // (n, tx), y-frequency bit-reversed
  const int x0 = blockIdx.x * tx, z = blockIdx.y, a = blockIdx.z;
  const int h = n >> 1;
  const size_t nn = (size_t)n * n;
  const size_t comp = (size_t)rows * nn;  // one (pm, reim) component
  const float* spr = g + (size_t)(4 * a) * comp + (size_t)z * n + x0;
  const float* spi = spr + comp;
  const float* smr = spr + 2 * comp;
  const float* smi = spr + 3 * comp;
  for (int t = threadIdx.x; t < n * tx; t += blockDim.x) {
    const int k = t >> logtx, xx = t & (tx - 1);
    float2 v;
    if (k == 0 || k == h) {
      if (k == h && !has_nyq) {
        v = make_float2(0.0f, 0.0f);
      } else {
        const size_t o = (size_t)k * nn + xx;
        // Re D~ = (sp_re + sm_re) / 2, Re F~ = (sp_im - sm_im) / 2
        v = make_float2(0.5f * (spr[o] + smr[o]), 0.5f * (spi[o] - smi[o]));
      }
    } else if (k < h) {
      const size_t o = (size_t)k * nn + xx;
      v = make_float2(spr[o], spi[o]);
    } else {
      const size_t o = (size_t)(n - k) * nn + xx;
      v = make_float2(smr[o], -smi[o]);
    }
    cols[zt::bitrev((unsigned)k, logn) * tx + xx] = v;
  }
  __syncthreads();
  zt::fft_smem<true>(cols, logn, logtx, 1, tx, tw);
  // out[a, reim, y, z, x]
  float* ore = out + (size_t)(2 * a) * nn * n + (size_t)z * n + x0;
  float* oim = ore + nn * n;
  for (int t = threadIdx.x; t < n * tx; t += blockDim.x) {
    const int y = t >> logtx, xx = t & (tx - 1);
    const float2 v = cols[y * tx + xx];
    const size_t o = (size_t)y * nn + xx;
    ore[o] = v.x;
    oim[o] = v.y;
  }
}

}  // namespace

extern "C" int zt_col_tile(int n);

extern "C" int zt_b2_c2r_y(const void* g, const void* tw, void* out, int n,
                           int narray, int has_nyq, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tx = zt_col_tile(n);
  const size_t smem = (size_t)n * tx * sizeof(float2);
  if ((err = zt::allow_smem(c2r_y_kernel, smem)) != cudaSuccess) return (int)err;
  const int rows = n / 2 + (has_nyq ? 1 : 0);
  c2r_y_kernel<<<dim3(n / tx, n, narray), 256, smem, (cudaStream_t)stream>>>(
      (const float*)g, (const float2*)tw, (float*)out, n, zt::ilog2(n), rows,
      has_nyq, tx, zt::ilog2(tx));
  return (int)cudaGetLastError();
}
