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
//        the sequence.  The ragged last tile is masked.  The kernel takes
//        its elements through a loader (PlainLoad), so a kernel with its
//        own input layout (B2's half spectrum) runs the same tiles, passes
//        and stores as y_dft.
//        float:  every plane-row access moves TX * 4 >= 32 B: TX = 32
//        (128 B) up to n = 512, where a thread carries 2 adjacent columns
//        (8-byte loads, stores and exchanges); 16 at n = 1024; 8 at
//        n = 2048.  From n = 512 on a block is 1024 threads of 64
//        registers, the whole register file, and 139-147 KB of shared
//        memory: one block a SM.
//        double: an element is two registers a component, so a thread
//        carries one column (8-byte accesses again) and TX * 8 >= 32 B:
//        TX = 16 (128 B) up to n = 512, 8 at n = 1024, 4 at n = 2048.
//        Where E = 8 the block is float's (n = 512: 1024 threads of 64
//        registers, the same 147 KB); where E = 16 the 64 registers of
//        data alone want 128 a thread, so a block aims at 512 threads
//        (block_threads) and is again the whole register file from
//        n = 1024 on, 139-147 KB of shared memory.
//  rows: the contiguous axis.  T = n / E threads a row read consecutive
//        elements, a warp 128 B (float) or 256 B (double); the exchanges
//        are padded rows.
//
// Everything here has internal linkage: each .cu instantiates its own
// kernels (no kernel is compiled, registered or linked twice).
#pragma once

#include "fft_reg.cuh"

namespace {

namespace reg = zt::reg;
using zt::make2;
using zt::vec2;

// threads a block aims at (a cols tile is widened or narrowed to it, a
// rows block's minimum blocks a SM follow from it): 1024 of 64 registers,
// or, where a thread's 16 double elements are 64 registers of data, 512
// of 128
template <typename F>
__host__ __device__ constexpr int block_threads(int n) {
  return sizeof(F) == 8 && reg::elems(n) == 16 ? 512 : 1024;
}

__host__ __device__ constexpr int threads_per_seq(int n) { return n / reg::elems(n); }

// blocks a SM that a kernel of `threads` threads is budgeted for, so that
// block_threads threads share the register file; a double block of less
// than a warp still takes a warp's registers (n = 16: 16 threads of 16
// elements, which spilled when counted as half a warp)
template <typename F>
__host__ __device__ constexpr int min_blocks(int n, int threads) {
  return block_threads<F>(n) / (sizeof(F) == 8 && threads < 32 ? 32 : threads);
}

// Padding shift of the exchange after pass p (zt::reg::smem_at), chosen
// to keep that exchange's shared-memory accesses free of bank conflicts:
// columns skip one row after each R_p rows; rows one element after 32
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
// registers (float, E = 8, n in [64, 512]), else 1
template <typename F>
__host__ __device__ constexpr int cols_c(int n) {
  return sizeof(F) == 4 && n >= 64 && reg::elems(n) == 8 ? 2 : 1;
}

// columns of a cols tile: runs of >= 32 B and <= 128 B (8 to 32 floats, 4
// to 16 doubles), ~block_threads threads, and both planes' exchange tile
// within 227 KB of shared memory
template <typename F>
__host__ __device__ constexpr int cols_tx(int n) {
  constexpr int lo = 32 / (int)sizeof(F), hi = 128 / (int)sizeof(F);
  int tx = block_threads<F>(n) * cols_c<F>(n) / threads_per_seq(n);
  tx = tx < lo ? lo : tx > hi ? hi : tx;
  while (tx > lo && 2 * extent<true>(n) * tx * (int)sizeof(F) > 227 * 1024) tx /= 2;
  return tx;
}

template <typename F>
__host__ __device__ constexpr int cols_threads(int n) {
  return cols_tx<F>(n) / cols_c<F>(n) * threads_per_seq(n);
}

// blocks a SM the cols kernel's registers are budgeted for
template <typename F>
__host__ __device__ constexpr int cols_min_blocks(int n) {
  return cols_c<F>(n) == 1 ? min_blocks<F>(n, cols_threads<F>(n)) : 1;
}

template <typename F, int N, int P, int C>
__device__ __forceinline__ void butterflies(vec2<F>* v, int t,
                                            const vec2<F>* __restrict__ tw, F s) {
  reg::butterflies<F, N, P>(v, t, tw, s);
  if constexpr (C == 2) reg::butterflies<F, N, P>(v + reg::elems(N), t, tw, s);
}

// All passes on the C sequences of v (C * E elements), loaded in pass 0's
// pattern (element t + r * T in v[r]); the output leaves in the last
// pass's (element t + b * T + r * N / R_last in v[b * R_last + r]).
template <typename F, int N, bool COLS, int LANES, int C = 1>
__device__ __forceinline__ void transform(vec2<F>* v, int t, int lane, F* sre, F* sim,
                                          const vec2<F>* __restrict__ tw, F s) {
  constexpr int P = reg::npass(N);
  constexpr int STRIDE = COLS ? LANES : 1;
  butterflies<F, N, 0, C>(v, t, tw, s);
  if constexpr (P > 1) {
    reg::exchange<F, N, 0, COLS ? cols_shift(N, 0) : rows_shift(N, 0), STRIDE, C>(
        v, t, sre, sim, lane);
    butterflies<F, N, 1, C>(v, t, tw, s);
  }
  if constexpr (P > 2) {
    reg::exchange<F, N, 1, COLS ? cols_shift(N, 1) : rows_shift(N, 1), STRIDE, C>(
        v, t, sre, sim, lane);
    butterflies<F, N, 2, C>(v, t, tw, s);
  }
}

// C elements of a plane row from p (aligned to 2 elements when C = 2)
template <typename F, int C>
__device__ __forceinline__ vec2<F> load_c(const F* p) {
  if constexpr (C == 2) return *reinterpret_cast<const vec2<F>*>(p);
  return make2<F>(*p, F(0));
}

// The plain column source, a loader: load<F, N, C> fills pass 0's
// registers of thread t, v[r] (and v[E + r] for C = 2) = element
// k = t + r * T of the C columns at `base` (the output's offset: input
// and output share the layout), at base + k * inner of the re plane, its
// im plane at + comp; zero where the tile's ragged edge masks the lane
// (!live).
struct PlainLoad {
  template <typename F, int N, int C>
  __device__ __forceinline__ void load(const F* in, bool live, long long, long long,
                                       size_t base, long long inner, long long comp, int t,
                                       vec2<F>* v) const {
    constexpr int E = reg::elems(N), T = threads_per_seq(N);
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const size_t o = base + (size_t)(t + r * T) * inner;
      vec2<F> re = make2<F>(F(0), F(0)), im = re;
      if (live) {
        re = load_c<F, C>(in + o);
        im = load_c<F, C>(in + o + comp);
      }
      v[r] = make2<F>(re.x, im.x);
      if constexpr (C == 2) v[E + r] = make2<F>(re.y, im.y);
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
template <typename F, int N, class Load>
__global__ void __launch_bounds__(cols_threads<F>(N), cols_min_blocks<F>(N))
    axis_cols_kernel(Load load, const F* in, F* out, const vec2<F>* __restrict__ tw,
                     long long inner, long long ntiles, int K, long long kstride,
                     long long bstride, long long comp) {
  constexpr int E = reg::elems(N), T = threads_per_seq(N), TX = cols_tx<F>(N);
  constexpr int C = cols_c<F>(N);
  constexpr int RL = reg::radix(N, reg::npass(N) - 1);
  constexpr int PLANE = extent<true>(N) * TX;
  F* sre = zt::shared_elems<F>();
  F* sim = sre + PLANE;
  const int c = threadIdx.x % (TX / C) * C, t = threadIdx.x / (TX / C);
  const long long item = blockIdx.x / ntiles;
  const long long c0 = (blockIdx.x - item * ntiles) * TX;
  const long long b = item / K;
  const size_t base = (size_t)(b * bstride + (item - b * K) * kstride + c0 + c);
  const bool live = c0 + c < inner;
  const F s = __ldg(&tw[N / 4]).y;  // the table's sign: w^(N/4) = s i
  vec2<F> v[C * E];
  load.template load<F, N, C>(in, live, item, c0 + c, base, inner, comp, t, v);
  transform<F, N, true, TX, C>(v, t, c, sre, sim, tw, s);
  if (!live) return;
#pragma unroll
  for (int b2 = 0; b2 < E / RL; ++b2) {
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const size_t o = base + (size_t)(t + b2 * T + r * (N / RL)) * inner;
      const vec2<F> x = v[b2 * RL + r];
      if constexpr (C == 2) {
        const vec2<F> y = v[E + b2 * RL + r];
        *reinterpret_cast<vec2<F>*>(out + o) = make2<F>(x.x, y.x);
        *reinterpret_cast<vec2<F>*>(out + o + comp) = make2<F>(x.y, y.y);
      } else {
        out[o] = x.x;
        out[o + comp] = x.y;
      }
    }
  }
}

template <typename F, int N, class Load>
cudaError_t launch_cols(Load load, const F* in, F* out, const vec2<F>* tw, long long inner,
                        long long nitems, int K, long long kstride, long long bstride,
                        long long comp, cudaStream_t s) {
  constexpr int TX = cols_tx<F>(N);
  if (cols_c<F>(N) == 2 && inner % 2) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)extent<true>(N) * TX * sizeof(F);
  cudaError_t err = zt::allow_smem(axis_cols_kernel<F, N, Load>, smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (inner + TX - 1) / TX;
  axis_cols_kernel<F, N, Load>
      <<<(unsigned)(nitems * ntiles), cols_threads<F>(N), smem, s>>>(
          load, in, out, tw, inner, ntiles, K, kstride, bstride, comp);
  return cudaGetLastError();
}

// launch_cols for a run-time n (a power of two in [16, 2048])
template <typename F, class Load>
cudaError_t cols(int n, Load load, const F* in, F* out, const vec2<F>* tw, long long inner,
                 long long nitems, int K, long long kstride, long long bstride,
                 long long comp, cudaStream_t s) {
#define ZT_COLS(N) \
  launch_cols<F, N>(load, in, out, tw, inner, nitems, K, kstride, bstride, comp, s)
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
