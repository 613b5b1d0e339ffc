// B4 and B5: Gaussian deviates from the pcg64 stream, for one H100 (sm_90a).
//
// B4 (zt_b4_boxmuller) covers the generated half space; B5
// (zt_b5_boxmuller_at) the modes of an out-of-core slab, each at its
// source index in the generated half space.
//
// B4 replaces the Pallas TPU kernel
//   zeldovich_tpu/ops/pallas_synth.py::halfspace_boxmuller_pallas
// (body _grid_kernel; helpers _madd128, _draw_chain).  Contract: for every
// mode (y, z, x) of the generated half space y in [0, half), the
// first-draw state planes[y] * mzx[z, x] + czx[z, x], two draws and
// Box-Muller: D = live * (amp cos 2 pi T, amp sin 2 pi T) with
// amp = sqrt(pk) (fixed power) or sqrt(-pk log R); out D_re, D_im
// (half, Z, X) of the element type F, pk's and live's (float here, the
// fast float32 draws; double through boxmuller_f64.cu, entry points
// *_f64, the exact float64 draws of pcg.cuh).  live is optional (zero
// rules folded into pk when absent: sqrt(-0 log R) == 0).
//
// What bounds it.  Issue slots, then bytes.  Device memory: pk (and live)
// read and two floats written, 12-16 B a mode, 0.8 GB at 512^3 and 6.4 GB
// at 1024^3.  Per mode two 128-bit multiply-adds (each ten 32-bit
// multiplies with their carries), two XSL-RR permutations, four
// int-to-float conversions, a logarithm, a correctly rounded square root
// and the sine/cosine polynomial: a SASS count of 151 a mode.  Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6,
// scripts/torch_b4_floor.py): 0.41 ms at 512^3 and 3.23 ms at 1024^3, 59%
// and 60% of the bytes bound; the same loads and stores without the draw
// arithmetic take 0.30 and 2.61 ms, the arithmetic without the table
// loads 0.43 and 3.36 ms, so the draws' issue slots set the floor (0.73
// and 0.78 of the warp instructions the 132 SMs' four schedulers can
// issue at the SM clock read under load, 1.98 and 1.89 GHz).  The
// (z, x) jump maps are 32 B a (z, x).  The first design, a thread a mode,
// read them once for every y plane and counted on L2 to keep them: 2.7
// times the device-memory bytes through L2, 0.53 ms at 512^3, and 7.26 ms
// at 1024^3, where the 33.5 MB of maps no longer stay in L2.
//
// Design.  A thread owns one (z, x) column, threads consecutive along the
// flat (z, x) index (x fastest), so every pk load and D store of a warp is
// one 128-byte run at any n.  It loads its column's jump map once into
// registers (8 registers) and walks a tile of B4_TY consecutive y planes,
// whose start states the block has put into shared memory; map traffic
// falls by B4_TY.  The walk goes B4_U planes at a time: every pk (and
// live) load of the group first, then the group's integer chains, then
// its float halves, so that independent chains overlap inside a thread as
// well as between warps.  pk, live and D are touched once and go around
// the caches' keep order (__ldcs / __stcs).  Fixed power and "has live"
// are template parameters: no branch sits between a load and its use.
// The 128-bit arithmetic is native unsigned __int128 (pcg.cuh), not the
// TPU kernel's 16-bit limb columns.
//
// double.  The same kernel with 8-byte pk, live and D (24-32 B a mode) and
// the library's double log, sqrt, sin and cos after the same integer
// chain: its instances are budgeted two blocks a SM (128 registers,
// B4_MIN_BLOCKS_F64) where float's fit four of 64.

#include "pcg.cuh"

namespace {

using zt::u128;
using zt::u64;

// Tile constants.  tests/torch_b4_model.py models this schedule with the
// same numbers, read from these lines.
constexpr int B4_THREADS = 256;
constexpr int B4_TY = 32;         // y planes a block walks
constexpr int B4_U = 4;           // planes whose loads are issued together
constexpr int B4_MIN_BLOCKS = 4;  // blocks a SM the register budget allows
constexpr int B4_MIN_BLOCKS_F64 = 2;  // the same for the double instances

template <typename F>
constexpr int b4_min_blocks() {
  return sizeof(F) == 8 ? B4_MIN_BLOCKS_F64 : B4_MIN_BLOCKS;
}

template <typename F, bool FIXED, bool LIVE>
__global__ void __launch_bounds__(B4_THREADS, b4_min_blocks<F>()) boxmuller_kernel(
    const u64* __restrict__ planes, const u64* __restrict__ mzx,
    const u64* __restrict__ czx, const F* __restrict__ pk,
    const F* __restrict__ live, F* __restrict__ re,
    F* __restrict__ im, int n, int half) {
  __shared__ u64 sp[2 * B4_TY];  // the tile's plane states, (lo, hi) each
  const int y0 = blockIdx.y * B4_TY;
  const int rows = min(B4_TY, half - y0);
  for (int i = threadIdx.x; i < 2 * rows; i += B4_THREADS)
    sp[i] = __ldg(planes + 2 * (size_t)y0 + i);
  __syncthreads();
  const size_t nn = (size_t)n * n;
  const size_t zx = (size_t)blockIdx.x * B4_THREADS + threadIdx.x;
  if (zx >= nn) return;
  const u128 m = zt::load_u128(mzx + zx, mzx + nn + zx);
  const u128 c = zt::load_u128(czx + zx, czx + nn + zx);
  size_t idx = (size_t)y0 * nn + zx;
  int j = 0;
  for (; j + B4_U <= rows; j += B4_U, idx += B4_U * nn) {
    F p[B4_U], l[B4_U];
    zt::vec2<F> rt[B4_U];
#pragma unroll
    for (int u = 0; u < B4_U; ++u) {
      p[u] = __ldcs(pk + idx + u * nn);
      l[u] = LIVE ? __ldcs(live + idx + u * nn) : F(1);
    }
#pragma unroll
    for (int u = 0; u < B4_U; ++u) {
      const u128 st = ((u128)sp[2 * (j + u) + 1] << 64) | (u128)sp[2 * (j + u)];
      rt[u] = zt::mode_uniforms<F>(m * st + c);
    }
#pragma unroll
    for (int u = 0; u < B4_U; ++u) {
      const zt::vec2<F> D = zt::mode_deviate(rt[u], p[u], FIXED, l[u]);
      __stcs(re + idx + u * nn, D.x);
      __stcs(im + idx + u * nn, D.y);
    }
  }
  for (; j < rows; ++j, idx += nn) {  // the ragged end of the last tile
    const F pv = __ldcs(pk + idx);
    const F lv = LIVE ? __ldcs(live + idx) : F(1);
    const u128 st = ((u128)sp[2 * j + 1] << 64) | (u128)sp[2 * j];
    const zt::vec2<F> D = zt::gaussian_mode<F>(m * st + c, pv, FIXED, lv);
    __stcs(re + idx, D.x);
    __stcs(im + idx, D.y);
  }
}

template <typename F, bool FIXED, bool LIVE>
cudaError_t launch_b4(const void* planes, const void* mzx, const void* czx,
                      const void* pk, const void* live, void* re, void* im, int n,
                      int half, cudaStream_t stream) {
  const size_t nn = (size_t)n * n;
  const dim3 grid((unsigned)((nn + B4_THREADS - 1) / B4_THREADS),
                  (unsigned)((half + B4_TY - 1) / B4_TY));
  boxmuller_kernel<F, FIXED, LIVE><<<grid, B4_THREADS, 0, stream>>>(
      (const u64*)planes, (const u64*)mzx, (const u64*)czx, (const F*)pk,
      (const F*)live, (F*)re, (F*)im, n, half);
  return cudaGetLastError();
}

// B5: the same deviates at per-mode source indices.
//
// Replaces the Pallas TPU kernel
//   zeldovich_tpu/ops/pallas_synth.py::boxmuller_pallas
// (body _kernel).  The TPU kernel takes the jumped states as four u32
// limb planes, formed beforehand by XLA from per-mode gathers of the jump
// tables (modes_real.py:161-171, 230-233).  Here the kernel forms each
// state itself from the source indices: state = planes[sy] * mzx[sz, sx]
// + czx[sz, sx], one native 128-bit multiply-add, then gaussian_mode as
// B4 and B1 do.  Contract: sy, sz, sx int32 (sy < half), pk and live of
// F, all of `count` modes; out D_re, D_im of F and that count.
//
// What bounds it.  Per mode it reads 12 B of indices, 4 B of pk and 4 B
// of live and writes 8 B: 28 B of device memory (double: 44 B).  The jump-table reads
// (32 B a mode) come from a (2, Z, X) table: a slab's rows read the same
// table, in order along x in the generated half and in reversed runs in
// the mirror half, so they mostly hit L2.
//
// Design.  One thread per mode over the flat index, consecutive threads
// on consecutive modes (x fastest), so the index, pk, live and output
// accesses are coalesced.
template <typename F>
__global__ void __launch_bounds__(256) boxmuller_at_kernel(
    const int* __restrict__ sy, const int* __restrict__ sz,
    const int* __restrict__ sx, const u64* __restrict__ planes,
    const u64* __restrict__ mzx, const u64* __restrict__ czx,
    const F* __restrict__ pk, const F* __restrict__ live,
    F* __restrict__ re, F* __restrict__ im, long long count, int n,
    int fixed_power) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const size_t nn = (size_t)n * n;
  const int y = __ldg(sy + i);
  const size_t zx = (size_t)__ldg(sz + i) * n + __ldg(sx + i);
  const u128 m = zt::load_u128(mzx + zx, mzx + nn + zx);
  const u128 c = zt::load_u128(czx + zx, czx + nn + zx);
  const u128 st = zt::load_u128(planes + 2 * y, planes + 2 * y + 1);
  const zt::vec2<F> D = zt::gaussian_mode<F>(m * st + c, __ldg(pk + i), fixed_power,
                                             __ldg(live + i));
  re[i] = D.x;
  im[i] = D.y;
}

}  // namespace

extern "C" int ZT_ENTRY(zt_b5_boxmuller_at)(const void* sy, const void* sz, const void* sx,
                                  const void* planes, const void* mzx,
                                  const void* czx, const void* pk, const void* live,
                                  void* re, void* im, long long count, int n,
                                  int fixed_power, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (count <= 0) return 0;
  const int threads = 256;
  const long long blocks = (count + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  boxmuller_at_kernel<zt::real><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)sy, (const int*)sz, (const int*)sx, (const u64*)planes,
      (const u64*)mzx, (const u64*)czx, (const zt::real*)pk, (const zt::real*)live,
      (zt::real*)re, (zt::real*)im, count, n, fixed_power);
  return (int)cudaGetLastError();
}

// planes: the start states of the `half` planes to generate (the caller
// offsets the table to its first plane); pk, live, re, im: (half, n, n).
extern "C" int ZT_ENTRY(zt_b4_boxmuller)(const void* planes, const void* mzx, const void* czx,
                               const void* pk, const void* live, void* re, void* im,
                               int n, int half, int fixed_power, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (half <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (fixed_power)
    err = live ? launch_b4<zt::real, true, true>(planes, mzx, czx, pk, live, re, im, n, half, s)
               : launch_b4<zt::real, true, false>(planes, mzx, czx, pk, live, re, im, n, half, s);
  else
    err = live ? launch_b4<zt::real, false, true>(planes, mzx, czx, pk, live, re, im, n, half, s)
               : launch_b4<zt::real, false, false>(planes, mzx, czx, pk, live, re, im, n, half, s);
  return (int)err;
}
