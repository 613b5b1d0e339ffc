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
// Both may run in place (out == in): a block loads all it transforms into
// registers before its first store, and no two blocks touch the same
// elements.  Nothing is allocated: the only scratch is shared memory.
//
// What bounds them.  A pass reads and writes 8 B per complex element and
// does ~5 log2(n) flops on it: bound by device-memory traffic (a 2.15 GB
// slab: 1.28 ms a pass at 3.35 TB/s).
//
// Design (the TPU kernels fold the DFT into cos/sin matmuls on the MXU):
// the register-resident Stockham FFT of fft_reg.cuh.  A thread holds 8 or
// 16 elements of a sequence and does radix-8/16 butterflies in registers;
// loads go from device memory straight into registers and stores straight
// out, and shared memory carries only the 1-2 exchanges between radix
// passes (n = 512: 8*8*8, n = 2048: 16*16*8).  Two kernels:
//  cols: a strided axis (z with stride X; y with stride Bz * X).  A block
//        takes a tile of TX consecutive columns, the warp's lanes along
//        the tile and the threads of a column along the sequence.  Every
//        plane-row access moves TX * 4 >= 32 B: TX = 32 (128 B) up to
//        n = 512, where a thread carries 2 adjacent columns (8-byte loads,
//        stores and exchanges); 16 at n = 1024; 8 at n = 2048 (of the
//        three layouts, the 8-column tile in one block a SM).  From n = 512
//        on a block is 1024 threads of 64 registers, the whole register
//        file, and 139-147 KB of shared memory: one block a SM, whose loads
//        (all issued before the first butterfly: 2 E floats a thread,
//        128 KB a SM in flight) do not overlap its butterflies.  Three
//        other designs were built, held against torch.fft on the card and
//        measured slower at every path shape (PERF.md): a persistent
//        block that prefetches the next tile with cp.async, two 512-thread
//        blocks a SM, and at n = 2048 a 16-column tile over a cluster of
//        two blocks exchanging through distributed shared memory.  The
//        ragged last tile is masked.
//  rows: the contiguous axis (x).  A block takes R rows (R * n = 4096
//        complex values where n allows, 32 KB): consecutive threads read
//        consecutive x, 128 B a warp; 256-512 threads, 2-4 blocks a SM.
// zx is cols along z (in -> out), then rows along x in place on out; y is
// cols alone.

#include "fft_reg.cuh"
#include "fft_smem.cuh"

namespace {

namespace reg = zt::reg;

// threads a cols block aims at (the tile is widened or narrowed to it)
constexpr int COLS_THREADS = 1024;

__host__ __device__ constexpr int threads_per_seq(int n) { return n / reg::elems(n); }

// rows of a rows block: 4096 complex values, within one plane (<= n);
// at most 512 threads
__host__ __device__ constexpr int rows_per_block(int n) { return 4096 / n < n ? 4096 / n : n; }

// Padding shift of the exchange after pass p (zt::reg::smem_at), chosen
// to keep that exchange's shared-memory accesses free of bank conflicts:
// columns skip one row after each R_p rows; rows one float after 32
// indices after the first pass of n >= 512 (after R_0 for smaller n),
// after 4 in the second exchange.
__host__ __device__ constexpr int cols_shift(int n, int p) { return reg::log2c(reg::radix(n, p)); }
__host__ __device__ constexpr int rows_shift(int n, int p) {
  return p > 0 ? 2 : n >= 512 ? 5 : reg::log2c(reg::radix(n, 0));
}

// the largest padded extent over a kernel's exchanges
template <bool COLS>
__host__ __device__ constexpr int extent(int n) {
  int most = 0;
  for (int p = 0; p + 1 < reg::npass(n); ++p) {
    const int e = reg::padded(n, COLS ? cols_shift(n, p) : rows_shift(n, p));
    most = e > most ? e : most;
  }
  return most;
}

// columns a cols thread carries: 2 where its 2 E elements fit the
// registers (E = 8, n in [64, 512]), else 1
__host__ __device__ constexpr int cols_c(int n) { return n >= 64 && reg::elems(n) == 8 ? 2 : 1; }

// columns of a cols tile: >= 8 (32 B runs), <= 32 (128 B), ~COLS_THREADS
// threads, and both planes' exchange tile within 227 KB of shared memory
__host__ __device__ constexpr int cols_tx(int n) {
  int tx = COLS_THREADS * cols_c(n) / threads_per_seq(n);
  tx = tx < 8 ? 8 : tx > 32 ? 32 : tx;
  while (tx > 8 && 2 * extent<true>(n) * tx * 4 > 227 * 1024) tx /= 2;
  return tx;
}

template <int N, int P, int C>
__device__ __forceinline__ void butterflies(float2* v, int t, const float2* __restrict__ tw,
                                            float s) {
  reg::butterflies<N, P>(v, t, tw, s);
  if constexpr (C == 2) reg::butterflies<N, P>(v + reg::elems(N), t, tw, s);
}

// All passes on the C sequences of v (C * E elements).
template <int N, bool COLS, int LANES, int C = 1>
__device__ __forceinline__ void transform(float2* v, int t, int lane, float* sre, float* sim,
                                          const float2* __restrict__ tw, float s) {
  constexpr int P = reg::npass(N);
  constexpr int STRIDE = COLS ? LANES : 1;
  butterflies<N, 0, C>(v, t, tw, s);
  if constexpr (P > 1) {
    reg::exchange<N, 0, COLS ? cols_shift(N, 0) : rows_shift(N, 0), STRIDE, C>(v, t, sre,
                                                                             sim, lane);
    butterflies<N, 1, C>(v, t, tw, s);
  }
  if constexpr (P > 2) {
    reg::exchange<N, 1, COLS ? cols_shift(N, 1) : rows_shift(N, 1), STRIDE, C>(v, t, sre,
                                                                             sim, lane);
    butterflies<N, 2, C>(v, t, tw, s);
  }
}

// C elements of a plane row from p (8-byte aligned when C = 2)
template <int C>
__device__ __forceinline__ float2 load_c(const float* p) {
  if constexpr (C == 2) return *reinterpret_cast<const float2*>(p);
  return make_float2(*p, 0.0f);
}

// Column pass over items of shape (2, N, inner): item i = b * K + k at
// b * bstride + k * kstride of the re plane, its im plane at + comp; the
// transformed axis has stride `inner`.  One block: item i, columns
// [c0, c0 + TX); a thread takes C adjacent columns (inner is even when
// C = 2, so a pair is live or masked whole).
template <int N, int TX, int C>
__global__ void __launch_bounds__(TX / C * threads_per_seq(N),
                                  C == 1 ? 1024 / (TX * threads_per_seq(N)) : 1)
    axis_cols_kernel(const float* in, float* out, const float2* __restrict__ tw,
                     long long inner, long long ntiles, int K, long long kstride,
                     long long bstride, long long comp) {
  constexpr int E = reg::elems(N), T = threads_per_seq(N);
  constexpr int RL = reg::radix(N, reg::npass(N) - 1);
  constexpr int PLANE = extent<true>(N) * TX;
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + PLANE;
  const int c = threadIdx.x % (TX / C) * C, t = threadIdx.x / (TX / C);
  const long long item = blockIdx.x / ntiles;
  const long long c0 = (blockIdx.x - item * ntiles) * TX;
  const long long b = item / K;
  const size_t base = (size_t)(b * bstride + (item - b * K) * kstride + c0 + c);
  const bool live = c0 + c < inner;
  const float s = __ldg(&tw[N / 4]).y;  // the table's sign: w^(N/4) = s i
  float2 v[C * E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const size_t o = base + (size_t)(t + r * T) * inner;
    float2 re = make_float2(0.0f, 0.0f), im = re;
    if (live) {
      re = load_c<C>(in + o);
      im = load_c<C>(in + o + comp);
    }
    v[r] = make_float2(re.x, im.x);
    if constexpr (C == 2) v[E + r] = make_float2(re.y, im.y);
  }
  transform<N, true, TX, C>(v, t, c, sre, sim, tw, s);
  if (!live) return;
#pragma unroll
  for (int b2 = 0; b2 < E / RL; ++b2) {
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const size_t o = base + (size_t)(t + b2 * T + r * (N / RL)) * inner;
      const float2 x = v[b2 * RL + r];
      if constexpr (C == 2) {
        const float2 y = v[E + b2 * RL + r];
        *reinterpret_cast<float2*>(out + o) = make_float2(x.x, y.x);
        *reinterpret_cast<float2*>(out + o + comp) = make_float2(x.y, y.y);
      } else {
        out[o] = x.x;
        out[o + comp] = x.y;
      }
    }
  }
}

// Row pass over (B, 2, rows_per_item, N): row g of batch item b at
// b * bstride + g * N of the re plane, its im plane at + comp.  ROWS rows
// a block; ROWS divides rows_per_item.
template <int N, int ROWS>
__global__ void __launch_bounds__(ROWS * threads_per_seq(N),
                                  1024 / (ROWS * threads_per_seq(N)))
    axis_rows_kernel(const float* in, float* out, const float2* __restrict__ tw,
                     long long rows_per_item, long long bstride, long long comp) {
  constexpr int E = reg::elems(N), T = threads_per_seq(N);
  constexpr int RL = reg::radix(N, reg::npass(N) - 1);
  constexpr int ROW = extent<false>(N);
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + ROW * ROWS;
  const int t = threadIdx.x % T, q = threadIdx.x / T;
  const long long g = (long long)blockIdx.x * ROWS + q;
  const long long b = g / rows_per_item;
  const size_t base = (size_t)(b * bstride + (g - b * rows_per_item) * N);
  const float s = __ldg(&tw[N / 4]).y;
  float2 v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const size_t o = base + t + r * T;
    v[r] = make_float2(in[o], in[o + comp]);
  }
  transform<N, false, ROWS>(v, t, q * ROW, sre, sim, tw, s);
#pragma unroll
  for (int b2 = 0; b2 < E / RL; ++b2) {
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const size_t o = base + t + b2 * T + r * (N / RL);
      const float2 x = v[b2 * RL + r];
      out[o] = x.x;
      out[o + comp] = x.y;
    }
  }
}

template <int N>
cudaError_t launch_cols(const float* in, float* out, const float2* tw, long long inner,
                        long long nitems, int K, long long kstride, long long bstride,
                        long long comp, cudaStream_t s) {
  constexpr int TX = cols_tx(N), C = cols_c(N);
  if (C == 2 && inner % 2) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)extent<true>(N) * TX * sizeof(float);
  cudaError_t err = zt::allow_smem(axis_cols_kernel<N, TX, C>, smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (inner + TX - 1) / TX;
  axis_cols_kernel<N, TX, C>
      <<<(unsigned)(nitems * ntiles), TX / C * threads_per_seq(N), smem, s>>>(
          in, out, tw, inner, ntiles, K, kstride, bstride, comp);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_rows(const float* in, float* out, const float2* tw,
                        long long rows_per_item, long long nbatch, long long bstride,
                        long long comp, cudaStream_t s) {
  constexpr int ROWS = rows_per_block(N);
  const size_t smem = 2 * (size_t)extent<false>(N) * ROWS * sizeof(float);
  cudaError_t err = zt::allow_smem(axis_rows_kernel<N, ROWS>, smem);
  if (err != cudaSuccess) return err;
  axis_rows_kernel<N, ROWS>
      <<<(unsigned)(nbatch * rows_per_item / ROWS), ROWS * threads_per_seq(N), smem, s>>>(
          in, out, tw, rows_per_item, bstride, comp);
  return cudaGetLastError();
}

cudaError_t cols(int n, const float* in, float* out, const float2* tw, long long inner,
                 long long nitems, int K, long long kstride, long long bstride,
                 long long comp, cudaStream_t s) {
#define ZT_COLS(N) launch_cols<N>(in, out, tw, inner, nitems, K, kstride, bstride, comp, s)
  switch (n) {
    case 16: return ZT_COLS(16);
    case 32: return ZT_COLS(32);
    case 64: return ZT_COLS(64);
    case 128: return ZT_COLS(128);
    case 256: return ZT_COLS(256);
    case 512: return ZT_COLS(512);
    case 1024: return ZT_COLS(1024);
    case 2048: return ZT_COLS(2048);
    default: return cudaErrorInvalidValue;
  }
#undef ZT_COLS
}

cudaError_t rows(int n, const float* in, float* out, const float2* tw,
                 long long rows_per_item, long long nbatch, long long bstride,
                 long long comp, cudaStream_t s) {
#define ZT_ROWS(N) launch_rows<N>(in, out, tw, rows_per_item, nbatch, bstride, comp, s)
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
  err = cols(n, (const float*)in, (float*)out, w, n, nbatch * K, K, nn, 2 * comp, comp, s);
  if (err != cudaSuccess) return (int)err;
  return (int)rows(n, (const float*)out, (float*)out, w, (long long)K * n, nbatch, 2 * comp,
                   comp, s);
}

// y: (nbatch, 2, n, inner), columns of stride inner (in -> out).
extern "C" int zt_y_dft(const void* in, void* out, const void* tw, int n,
                        long long inner, long long nbatch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long comp = (long long)n * inner;
  return (int)cols(n, (const float*)in, (float*)out, (const float2*)tw, inner, nbatch, 1, 0,
                   2 * comp, comp, (cudaStream_t)stream);
}
