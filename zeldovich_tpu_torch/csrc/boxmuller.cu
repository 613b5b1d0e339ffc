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
// (half, Z, X) float32.  live is optional (zero rules folded into pk when
// absent: sqrt(-0 log R) == 0).
//
// What bounds it.  It reads pk (and live) and writes two floats: 12-16 B
// per mode of device memory, 0.8 GB at 512^3.  The (z, x) jump maps
// (32 B per (z, x)) are read once per y plane, 8 MB at 512^2, and stay in
// the 50 MB L2.  Per mode it does two 128-bit multiplies, two XSL-RR
// permutations, a log and a short polynomial: a few hundred integer and
// float operations, about as much time as the bytes take.
//
// Design.  One thread per mode, threads consecutive along x so that every
// load and store is coalesced; one block row of x per (z, y).  The 128-bit
// arithmetic is native unsigned __int128 (pcg.cuh), not the TPU kernel's
// 16-bit limb columns.

#include "pcg.cuh"

namespace {

using zt::u128;
using zt::u64;

__global__ void __launch_bounds__(256) boxmuller_kernel(
    const u64* __restrict__ planes, const u64* __restrict__ mzx,
    const u64* __restrict__ czx, const float* __restrict__ pk,
    const float* __restrict__ live, float* __restrict__ re,
    float* __restrict__ im, int n, int fixed_power) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y, y = blockIdx.z;
  if (x >= n) return;
  const size_t nn = (size_t)n * n;
  const size_t zx = (size_t)z * n + x;
  const size_t idx = (size_t)y * nn + zx;
  const u128 m = zt::load_u128(mzx + zx, mzx + nn + zx);
  const u128 c = zt::load_u128(czx + zx, czx + nn + zx);
  const u128 st = zt::load_u128(planes + 2 * y, planes + 2 * y + 1);
  const float l = live == nullptr ? 1.0f : __ldg(live + idx);
  const float2 D = zt::gaussian_mode(m * st + c, __ldg(pk + idx), fixed_power, l);
  re[idx] = D.x;
  im[idx] = D.y;
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
// B4 and B1 do.  Contract: sy, sz, sx int32 (sy < half), pk and live
// float32, all of `count` modes; out D_re, D_im float32 of that count.
//
// What bounds it.  Per mode it reads 12 B of indices, 4 B of pk and 4 B
// of live and writes 8 B: 28 B of device memory.  The jump-table reads
// (32 B a mode) come from a (2, Z, X) table: a slab's rows read the same
// table, in order along x in the generated half and in reversed runs in
// the mirror half, so they mostly hit L2.
//
// Design.  One thread per mode over the flat index, consecutive threads
// on consecutive modes (x fastest), so the index, pk, live and output
// accesses are coalesced.
__global__ void __launch_bounds__(256) boxmuller_at_kernel(
    const int* __restrict__ sy, const int* __restrict__ sz,
    const int* __restrict__ sx, const u64* __restrict__ planes,
    const u64* __restrict__ mzx, const u64* __restrict__ czx,
    const float* __restrict__ pk, const float* __restrict__ live,
    float* __restrict__ re, float* __restrict__ im, long long count, int n,
    int fixed_power) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const size_t nn = (size_t)n * n;
  const int y = __ldg(sy + i);
  const size_t zx = (size_t)__ldg(sz + i) * n + __ldg(sx + i);
  const u128 m = zt::load_u128(mzx + zx, mzx + nn + zx);
  const u128 c = zt::load_u128(czx + zx, czx + nn + zx);
  const u128 st = zt::load_u128(planes + 2 * y, planes + 2 * y + 1);
  const float2 D = zt::gaussian_mode(m * st + c, __ldg(pk + i), fixed_power,
                                     __ldg(live + i));
  re[i] = D.x;
  im[i] = D.y;
}

}  // namespace

extern "C" int zt_b5_boxmuller_at(const void* sy, const void* sz, const void* sx,
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
  boxmuller_at_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)sy, (const int*)sz, (const int*)sx, (const u64*)planes,
      (const u64*)mzx, (const u64*)czx, (const float*)pk, (const float*)live,
      (float*)re, (float*)im, count, n, fixed_power);
  return (int)cudaGetLastError();
}

extern "C" int zt_b4_boxmuller(const void* planes, const void* mzx, const void* czx,
                               const void* pk, const void* live, void* re, void* im,
                               int n, int half, int fixed_power, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = n < 256 ? n : 256;
  boxmuller_kernel<<<dim3((n + threads - 1) / threads, n, half), threads, 0,
                     (cudaStream_t)stream>>>(
      (const u64*)planes, (const u64*)mzx, (const u64*)czx, (const float*)pk,
      (const float*)live, (float*)re, (float*)im, n, fixed_power);
  return (int)cudaGetLastError();
}
