// B4: Gaussian deviates over the generated half space, for one H100 (sm_90a).
//
// Replaces the Pallas TPU kernel
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

}  // namespace

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
