// The two layouts of the register-resident Stockham FFT (fft_reg.cuh)
// along an axis of real-pair planes, shared by the kernels that transform:
// csrc/fft_axis.cu (zx, y), csrc/synth.cu (B1's x pass, and its z pass
// through zt_cols_dft) and csrc/c2r.cu (B2).
//
// A thread holds 8 or 16 elements of a sequence and does radix-8/16
// butterflies in registers; loads go from device memory straight into
// registers and stores straight out, and shared memory carries only the
// 1-2 exchanges between radix passes (n = 512: 8*8*8, n = 2048: 16*16*8).
//  cols: a strided axis.  A block takes a tile of TX consecutive columns,
//        the warp's lanes along the tile and the threads of a column along
//        the sequence.  Every plane-row access moves TX * 4 >= 32 B: TX = 32
//        (128 B) up to n = 512, where a thread carries 2 adjacent columns
//        (8-byte loads, stores and exchanges); 16 at n = 1024; 8 at
//        n = 2048.  From n = 512 on a block is 1024 threads of 64
//        registers, the whole register file, and 139-147 KB of shared
//        memory: one block a SM.  The ragged last tile is masked.  The
//        kernel takes its elements through a loader (PlainLoad), so a
//        kernel with its own input layout (B2's half spectrum) runs the
//        same tiles, passes and stores as y_dft.
//  rows: the contiguous axis.  T = n / E threads a row read consecutive
//        elements, 128 B a warp; the exchanges are padded rows.
//
// Everything here has internal linkage: each .cu instantiates its own
// kernels (no kernel is compiled, registered or linked twice).
#pragma once

#include "fft_reg.cuh"

namespace {

namespace reg = zt::reg;

// threads a cols block aims at (the tile is widened or narrowed to it)
constexpr int COLS_THREADS = 1024;

__host__ __device__ constexpr int threads_per_seq(int n) { return n / reg::elems(n); }

// Padding shift of the exchange after pass p (zt::reg::smem_at), chosen
// to keep that exchange's shared-memory accesses free of bank conflicts:
// columns skip one row after each R_p rows; rows one float after 32
// indices after the first pass of n >= 512 (after R_0 for smaller n),
// after 4 in the second exchange.
__host__ __device__ constexpr int cols_shift(int n, int p) { return reg::log2c(reg::radix(n, p)); }
__host__ __device__ constexpr int rows_shift(int n, int p) {
  return p > 0 ? 2 : n >= 512 ? 5 : reg::log2c(reg::radix(n, 0));
}

// the largest padded extent over a kernel's exchanges (0: no exchange)
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

__host__ __device__ constexpr int cols_threads(int n) { return cols_tx(n) / cols_c(n) * threads_per_seq(n); }

template <int N, int P, int C>
__device__ __forceinline__ void butterflies(float2* v, int t, const float2* __restrict__ tw,
                                            float s) {
  reg::butterflies<N, P>(v, t, tw, s);
  if constexpr (C == 2) reg::butterflies<N, P>(v + reg::elems(N), t, tw, s);
}

// All passes on the C sequences of v (C * E elements), loaded in pass 0's
// pattern (element t + r * T in v[r]); the output leaves in the last
// pass's (element t + b * T + r * N / R_last in v[b * R_last + r]).
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

// The plain column source, a loader: load<N, C> fills pass 0's registers
// of thread t, v[r] (and v[E + r] for C = 2) = element k = t + r * T of
// the C columns at `base` (the output's offset: input and output share
// the layout), at base + k * inner of the re plane, its im plane at
// + comp; zero where the tile's ragged edge masks the lane (!live).
struct PlainLoad {
  template <int N, int C>
  __device__ __forceinline__ void load(const float* in, bool live, long long, long long,
                                       size_t base, long long inner, long long comp, int t,
                                       float2* v) const {
    constexpr int E = reg::elems(N), T = threads_per_seq(N);
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
  }
};

// Column pass over items of shape (2, N, inner): item i = b * K + k at
// b * bstride + k * kstride of the re plane, its im plane at + comp; the
// transformed axis has stride `inner`.  One block: item i, columns
// [c0, c0 + TX); a thread takes C adjacent columns (inner is even when
// C = 2, so a pair is live or masked whole).  The elements come from
// `in` through the loader, given item i, the first column, the output's
// offset and strides (PlainLoad; B2's C2rLoad reads another layout).
// Every load is issued before the first exchange barrier and every store
// after the last, so out may be in (in place) as long as a block's loads
// read only its own columns.
template <int N, class Load>
__global__ void __launch_bounds__(cols_threads(N),
                                  cols_c(N) == 1 ? 1024 / cols_threads(N) : 1)
    axis_cols_kernel(Load load, const float* in, float* out, const float2* __restrict__ tw,
                     long long inner, long long ntiles, int K, long long kstride,
                     long long bstride, long long comp) {
  constexpr int E = reg::elems(N), T = threads_per_seq(N), TX = cols_tx(N), C = cols_c(N);
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
  load.template load<N, C>(in, live, item, c0 + c, base, inner, comp, t, v);
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

template <int N, class Load>
cudaError_t launch_cols(Load load, const float* in, float* out, const float2* tw,
                        long long inner,
                        long long nitems, int K, long long kstride, long long bstride,
                        long long comp, cudaStream_t s) {
  constexpr int TX = cols_tx(N);
  if (cols_c(N) == 2 && inner % 2) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)extent<true>(N) * TX * sizeof(float);
  cudaError_t err = zt::allow_smem(axis_cols_kernel<N, Load>, smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (inner + TX - 1) / TX;
  axis_cols_kernel<N, Load><<<(unsigned)(nitems * ntiles), cols_threads(N), smem, s>>>(
      load, in, out, tw, inner, ntiles, K, kstride, bstride, comp);
  return cudaGetLastError();
}

// launch_cols for a run-time n (a power of two in [16, 2048])
template <class Load>
cudaError_t cols(int n, Load load, const float* in, float* out, const float2* tw,
                 long long inner, long long nitems, int K, long long kstride, long long bstride,
                 long long comp, cudaStream_t s) {
#define ZT_COLS(N) \
  launch_cols<N>(load, in, out, tw, inner, nitems, K, kstride, bstride, comp, s)
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

}  // namespace
