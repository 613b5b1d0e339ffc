// B6/B7 and B8: unnormalized complex DFTs along one axis of real-pair
// arrays, sign +1 or -1, for one H100 (sm_90a).
//
// Replace the Pallas TPU kernels
//   zeldovich_tpu/ops/pallas_fft.py::zx_folded_pallas  (B6, n <= 512)
//   zeldovich_tpu/ops/pallas_fft.py::zx_tiled_pallas   (B7, n in [1024, 2048])
//   zeldovich_tpu/ops/pallas_fft.py::y_tiled_pallas    (B8)
// (bodies _zx_kernel, _z_tile_kernel, _x_tile_kernel and y_tiled_pallas's
// inline kernel; helpers _folded_axis0, _folded_axis1, _folded_xpass).
// Contracts, float32, FFTW sign convention, no 1/N:
//   zx: (B, 2, K, n, n) = (batch, re/im, plane, z, x) -> the 2-D DFT over
//       (z, x) of every plane;
//   y:  (B, 2, n, inner) = (batch, re/im, y, (z, x) flattened) -> the DFT
//       along y of every (z, x) column (a full grid or a z-slab).
// Both may run in place (out == in): every block reads all it transforms
// before it writes, and no two blocks touch the same elements.
//
// What bounds them.  A pass reads and writes 8 B per complex element and
// does ~5 log2(n) flops on it: bound by device-memory traffic.
//
// Design.  The TPU kernels fold the DFT into cos/sin matmuls on the MXU; a
// Hopper SM has a shared-memory FFT instead.  Two kernels:
//  rows: the contiguous axis (x).  One block stages R rows (R * n = 4096
//        complex values) in shared memory in bit-reversed order, reads
//        coalesced along x, transforms them and writes them back.
//  cols: a strided axis (z with stride X; y with stride Bz * X).  One
//        block stages a tile of tx consecutive columns (n * tx = 8192
//        complex values, 64 KB), reads and writes coalesced along the tile,
//        and transforms the tx sequences in shared memory.
// zx is cols along z, then rows along x in place; y is cols alone.

#include "fft_smem.cuh"

namespace {

// Row pass over (B, 2, rows_per_item, n): row g of batch item b at
// b * bstride + g * n of the re plane, its im plane at + comp.  R rows a
// block; R divides rows_per_item.  The rows sit in padded shared memory
// (zt::slot<true>) so that the bit-reversed stores do not collide in one
// bank.
__global__ void __launch_bounds__(256) dft_rows_kernel(
    const float* in, float* out, const float2* __restrict__ tw, int n, int logn,
    int logr, long long rows_per_item, long long bstride, long long comp) {
  extern __shared__ float2 rows[];  // (R, n), bit-reversed, padded
  const long long g0 = (long long)blockIdx.x << logr;
  const long long b = g0 / rows_per_item;
  const size_t base = (size_t)(b * bstride + (g0 - b * rows_per_item) * n);
  const int total = n << logr;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = t >> logn, x = t & (n - 1);
    const size_t o = base + (size_t)t;
    rows[zt::slot<true>((r << logn) + zt::bitrev((unsigned)x, logn))] =
        make_float2(in[o], in[o + comp]);
  }
  __syncthreads();
  zt::fft_smem<false, true>(rows, logn, logr, n, 1, tw);
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const size_t o = base + (size_t)t;
    const float2 v = rows[zt::slot<true>(t)];
    out[o] = v.x;
    out[o + comp] = v.y;
  }
}

// Column pass over items of shape (2, n, inner): item i = b * K + k at
// b * bstride + k * kstride of the re plane, its im plane at + comp; the
// transformed axis has stride `inner`.  One block: item i, columns
// [c0, c0 + tx) (the ragged last tile is masked).
__global__ void __launch_bounds__(256) dft_cols_kernel(
    const float* in, float* out, const float2* __restrict__ tw, int n, int logn,
    int tx, int logtx, long long inner, long long ntiles, int K,
    long long kstride, long long bstride, long long comp) {
  extern __shared__ float2 cols[];  // (n, tx), bit-reversed along n
  const long long item = blockIdx.x / ntiles;
  const long long c0 = (blockIdx.x - item * ntiles) * tx;
  const long long b = item / K;
  const size_t base = (size_t)(b * bstride + (item - b * K) * kstride + c0);
  const long long width = inner - c0 < tx ? inner - c0 : tx;
  const int total = n << logtx;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int j = t >> logtx, c = t & (tx - 1);
    float2 v = make_float2(0.0f, 0.0f);
    if (c < width) {
      const size_t o = base + (size_t)j * inner + c;
      v = make_float2(in[o], in[o + comp]);
    }
    cols[(zt::bitrev((unsigned)j, logn) << logtx) + c] = v;
  }
  __syncthreads();
  zt::fft_smem<true>(cols, logn, logtx, 1, tx, tw);
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int j = t >> logtx, c = t & (tx - 1);
    if (c < width) {
      const size_t o = base + (size_t)j * inner + c;
      const float2 v = cols[t];
      out[o] = v.x;
      out[o + comp] = v.y;
    }
  }
}

// Columns of width tx: ~8192 complex values (64 KB) a block, and no wider
// than the (power-of-two ceiling of the) inner extent.
int col_tile(int n, long long inner) {
  int tx = 8192 / n;
  if (tx < 1) tx = 1;
  while (tx > 1 && (long long)(tx / 2) >= inner) tx /= 2;
  return tx;
}

cudaError_t launch_cols(const float* in, float* out, const float2* tw, int n,
                        long long inner, long long nitems, int K, long long kstride,
                        long long bstride, long long comp, cudaStream_t s) {
  const int tx = col_tile(n, inner);
  const size_t smem = (size_t)n * tx * sizeof(float2);
  cudaError_t err = zt::allow_smem(dft_cols_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (inner + tx - 1) / tx;
  dft_cols_kernel<<<(unsigned)(nitems * ntiles), 256, smem, s>>>(
      in, out, tw, n, zt::ilog2(n), tx, zt::ilog2(tx), inner, ntiles, K, kstride,
      bstride, comp);
  return cudaGetLastError();
}

}  // namespace

// zx: (nbatch, 2, K, n, n); z along columns (in -> out), then x along rows
// (in place on out).
extern "C" int zt_zx_dft(const void* in, void* out, const void* tw, int n, int K,
                         long long nbatch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const float2* w = (const float2*)tw;
  const long long nn = (long long)n * n;
  const long long comp = (long long)K * nn;
  err = launch_cols((const float*)in, (float*)out, w, n, n, nbatch * K, K, nn,
                    2 * comp, comp, s);
  if (err != cudaSuccess) return (int)err;
  int r = 4096 / n;
  if (r < 1) r = 1;
  if (r > n) r = n;
  const int logr = zt::ilog2(r);
  const size_t smem = (size_t)(r * n + r * n / 16) * sizeof(float2);
  if ((err = zt::allow_smem(dft_rows_kernel, smem)) != cudaSuccess) return (int)err;
  const long long rows_per_item = (long long)K * n;
  dft_rows_kernel<<<(unsigned)(nbatch * rows_per_item / r), 256, smem, s>>>(
      (const float*)out, (float*)out, w, n, zt::ilog2(n), logr, rows_per_item,
      2 * comp, comp);
  return (int)cudaGetLastError();
}

// y: (nbatch, 2, n, inner), columns of stride inner (in -> out).
extern "C" int zt_y_dft(const void* in, void* out, const void* tw, int n,
                        long long inner, long long nbatch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long comp = (long long)n * inner;
  return (int)launch_cols((const float*)in, (float*)out, (const float2*)tw, n, inner,
                          nbatch, 1, 0, 2 * comp, comp, (cudaStream_t)stream);
}
