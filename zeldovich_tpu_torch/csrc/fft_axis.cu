// B6/B7 and B8: unnormalized complex DFTs along one axis of real-pair
// arrays, sign +1 or -1, for one H100 (sm_90a).
//
// Replace the Pallas TPU kernels
//   zeldovich_tpu/ops/pallas_fft.py::zx_folded_pallas  (B6, n <= 512)
//   zeldovich_tpu/ops/pallas_fft.py::zx_tiled_pallas   (B7, n in [1024, 2048])
//   zeldovich_tpu/ops/pallas_fft.py::y_tiled_pallas    (B8)
// (bodies _zx_kernel, _z_tile_kernel, _x_tile_kernel and y_tiled_pallas's
// inline kernel; helpers _folded_axis0, _folded_axis1, _folded_xpass).
// Contracts, element type F (float here; double through fft_axis_f64.cu,
// entry points *_f64), FFTW sign convention, no 1/N:
//   zx: (B, 2, K, n, n) = (batch, re/im, plane, z, x) -> the 2-D DFT over
//       (z, x) of every plane;
//   y:  (B, 2, n, inner) = (batch, re/im, y, (z, x) flattened) -> the DFT
//       along y of every (z, x) column (a full grid or a z-slab).
// Both may run in place (out == in): a block loads all it transforms into
// registers before its first store, and no two blocks touch the same
// elements.  Nothing is allocated: the only scratch is shared memory.
//
// What bounds them.  A pass reads and writes 8 B (double: 16 B) per
// complex element and does ~5 log2(n) flops on it: bound by device-memory
// traffic (a 2.15 GB float slab: 1.28 ms a pass at 3.35 TB/s).
//
// Design (the TPU kernels fold the DFT into cos/sin matmuls on the MXU):
// the register-resident Stockham FFT of fft_reg.cuh in the two layouts of
// fft_pass.cuh.  cols (z with stride X; y with stride Bz * X): of the
// three layouts tried at n = 2048, the 8-column tile in one block a SM;
// from n = 512 on one block of 1024 threads a SM, whose loads (all issued
// before the first butterfly: 2 E floats a thread, 128 KB a SM in flight)
// do not overlap its butterflies.  Three other designs were built, held
// against torch.fft on the card and measured slower at every path shape
// (PERF.md): a persistent block that prefetches the next tile with
// cp.async, two 512-thread blocks a SM, and at n = 2048 a 16-column tile
// over a cluster of two blocks exchanging through distributed shared
// memory.  rows (x): a block takes R rows (R * n = 4096 complex values
// where n allows, 32 KB, double 64 KB); 256-512 threads, 2-4 blocks a SM
// (double: 2, of 128 registers where a thread holds 16 elements).
// zx is cols along z (in -> out), then rows along x in place on out; y is
// cols alone.

#include "fft_pass.cuh"

namespace {

// rows of a rows block: 4096 complex values, within one plane (<= n);
// at most 512 threads
__host__ __device__ constexpr int rows_per_block(int n) { return 4096 / n < n ? 4096 / n : n; }

// Row pass over (B, 2, rows_per_item, N): row g of batch item b at
// b * bstride + g * N of the re plane, its im plane at + comp.  ROWS rows
// a block; ROWS divides rows_per_item.
template <typename F, int N, int ROWS>
__global__ void __launch_bounds__(ROWS * threads_per_seq(N),
                                  min_blocks<F>(N, ROWS * threads_per_seq(N)))
    axis_rows_kernel(const F* in, F* out, const vec2<F>* __restrict__ tw,
                     long long rows_per_item, long long bstride, long long comp) {
  constexpr int E = reg::elems(N), T = threads_per_seq(N);
  constexpr int RL = reg::radix(N, reg::npass(N) - 1);
  constexpr int ROW = extent<false>(N);
  F* sre = zt::shared_elems<F>();
  F* sim = sre + ROW * ROWS;
  const int t = threadIdx.x % T, q = threadIdx.x / T;
  const long long g = (long long)blockIdx.x * ROWS + q;
  const long long b = g / rows_per_item;
  const size_t base = (size_t)(b * bstride + (g - b * rows_per_item) * N);
  const F s = __ldg(&tw[N / 4]).y;
  vec2<F> v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const size_t o = base + t + r * T;
    v[r] = make2<F>(in[o], in[o + comp]);
  }
  transform<F, N, false, ROWS>(v, t, q * ROW, sre, sim, tw, s);
#pragma unroll
  for (int b2 = 0; b2 < E / RL; ++b2) {
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const size_t o = base + t + b2 * T + r * (N / RL);
      const vec2<F> x = v[b2 * RL + r];
      out[o] = x.x;
      out[o + comp] = x.y;
    }
  }
}

template <typename F, int N>
cudaError_t launch_rows(const F* in, F* out, const vec2<F>* tw,
                        long long rows_per_item, long long nbatch, long long bstride,
                        long long comp, cudaStream_t s) {
  constexpr int ROWS = rows_per_block(N);
  const size_t smem = 2 * (size_t)extent<false>(N) * ROWS * sizeof(F);
  cudaError_t err = zt::allow_smem(axis_rows_kernel<F, N, ROWS>, smem);
  if (err != cudaSuccess) return err;
  axis_rows_kernel<F, N, ROWS>
      <<<(unsigned)(nbatch * rows_per_item / ROWS), ROWS * threads_per_seq(N), smem, s>>>(
          in, out, tw, rows_per_item, bstride, comp);
  return cudaGetLastError();
}

template <typename F>
cudaError_t rows(int n, const F* in, F* out, const vec2<F>* tw,
                 long long rows_per_item, long long nbatch, long long bstride,
                 long long comp, cudaStream_t s) {
#define ZT_ROWS(N) launch_rows<F, N>(in, out, tw, rows_per_item, nbatch, bstride, comp, s)
  switch (n) {
    case 16: return ZT_ROWS(16);
    case 32: return ZT_ROWS(32);
    case 64: return ZT_ROWS(64);
    case 128: return ZT_ROWS(128);
    case 256: return ZT_ROWS(256);
    case 512: return ZT_ROWS(512);
    case 1024: return ZT_ROWS(1024);
    case 2048: return ZT_ROWS(2048);
    default: return cudaErrorInvalidValue;
  }
#undef ZT_ROWS
}

using zt::real;
using zt::real2;

}  // namespace

// zx: (nbatch, 2, K, n, n); z along columns (in -> out), then x along rows
// (in place on out).
extern "C" int ZT_ENTRY(zt_zx_dft)(const void* in, void* out, const void* tw, int n, int K,
                         long long nbatch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const real2* w = (const real2*)tw;
  const long long nn = (long long)n * n;
  const long long comp = (long long)K * nn;
  err = cols<real>(n, PlainLoad{}, (const real*)in, (real*)out, w, n, nbatch * K, K, nn,
                   2 * comp, comp, s);
  if (err != cudaSuccess) return (int)err;
  return (int)rows<real>(n, (const real*)out, (real*)out, w, (long long)K * n, nbatch,
                         2 * comp, comp, s);
}

// y: (nbatch, 2, n, inner), columns of stride inner (in -> out).
extern "C" int ZT_ENTRY(zt_y_dft)(const void* in, void* out, const void* tw, int n,
                        long long inner, long long nbatch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long comp = (long long)n * inner;
  return (int)cols<real>(n, PlainLoad{}, (const real*)in, (real*)out, (const real2*)tw,
                         inner, nbatch, 1, 0, 2 * comp, comp, (cudaStream_t)stream);
}

// The column pass alone, in the layout of launch_cols (B1's z pass, in
// place on its output; csrc/synth.cu).  No device switch: the caller's.
extern "C" int ZT_ENTRY(zt_cols_dft)(int n, const void* in, void* out, const void* tw,
                                     long long inner, long long nitems, int K,
                                     long long kstride, long long bstride, long long comp,
                                     void* stream) {
  return (int)cols<real>(n, PlainLoad{}, (const real*)in, (real*)out, (const real2*)tw,
                         inner, nitems, K, kstride, bstride, comp, (cudaStream_t)stream);
}
