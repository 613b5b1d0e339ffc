// B1: half-spectrum mode synthesis + packing + ky=0 fixup + inverse DFTs
// along z and x, for one H100 (sm_90a); and B3 (zt_b3_pack, below), the
// same synthesis and packing alone.
//
// Replaces the Pallas TPU kernel
//   zeldovich_tpu/ops/pallas_synth.py::halfspace_pack_zx_pallas
// (bodies _pack_zx_kernel / _pack_zx_pair_kernel / _pack_zx_pipe_kernel;
// helpers _row_draws, _draw_chain, _row_pack, _row_fix, _row_dots).
// Contract: out (narray, 2, 2, half, Z, X) float32 =
// (array, +/- packing, re/im, ky, z, x), the always-zero y-Nyquist row
// omitted (the pair form), unnormalized sign +1 transforms.
//
// What bounds it.  Per mode the work is one 128-bit multiply-add, one LCG
// step, two XSL-RR permutations, a log, a short polynomial sincos and a
// dozen multiplies: a few hundred integer and float operations, small
// against the bytes.  The output is 16 (plain) or 32 (PLT) float32 per
// mode of the half grid, 4.3 GB at 512^3 PLT, so the kernel is bound by
// device-memory traffic.
//
// Design.  Two launches:
//  (a) pack_x: one block per (ky, z) row.  Each thread synthesizes modes
//      of the row straight from the counter-based stream (native
//      unsigned __int128, no limb arithmetic), packs S+ = D + iF and
//      S- = D - iF for every array into shared memory in bit-reversed
//      order, then the block runs the length-X inverse FFTs in shared
//      memory and writes the rows once, coalesced along x.
//      The ky=0 self-conjugate fixup is index-pure: a thread at ky=0 in
//      the in-plane mirror half recomputes its source mode
//      (0, (n-z)%n, (n-x)%n) itself and stores the conjugates of the
//      source's opposite packing; the origin is stored as zero.  No pass
//      over the ky=0 plane and no cross-block dependence.
//  (b) fft_z: in place, one block per (x tile, ky, packed plane).  A tile
//      of x columns is staged in shared memory (reads coalesced along x),
//      transformed along z and written back.
// So the output is written once by (a) and read and written once by (b):
// three passes over the output's bytes.  Fusing (b) into (a) needs a
// whole (Z, X) plane per block, which does not fit shared memory at 512^2;
// that and wgmma/TMA staging are later work.

#include "fft_smem.cuh"
#include "pcg.cuh"

namespace {

using zt::u128;
using zt::u64;

enum { FIXED_POWER = 1, JUST_DENSITY = 2, QPLT = 4 };

struct Params {
  const u64* planes;   // (half, 2) [lo, hi] per-y-plane start states
  const u64* mzx;      // (2, Z, X) precomposed pre-bumped multipliers
  const u64* czx;      // (2, Z, X) increments
  const float* pk;     // (half, Z, X) pk_effective
  const float* coefs;  // (4, half, Z, X) PLT cx, cy, cz, f (QPLT only)
  const float2* tw;    // (n/2) twiddles exp(+2 pi i j / n)
  float* out;          // (narray, 2, 2, half, Z, X)
  int n, logn, narray, flags;
  float fund, fund2;   // fundamental and fl(fund * fund) in float32
};

// Both packings (S+, S-) of every array for mode (ky, z, x) of the
// generated half-space: P[2a] = S+ of array a, P[2a+1] = S-.
__device__ void mode_packings(const Params& p, int ky, int z, int x, float2* P) {
  const int n = p.n, half = n >> 1;
  const size_t nn = (size_t)n * n;
  const size_t zx = (size_t)z * n + x;
  const size_t idx = (size_t)ky * nn + zx;
  const u128 m = zt::load_u128(p.mzx + zx, p.mzx + nn + zx);
  const u128 c = zt::load_u128(p.czx + zx, p.czx + nn + zx);
  const u128 st = zt::load_u128(p.planes + 2 * ky, p.planes + 2 * ky + 1);
  // the tables are pre-bumped: m * st + c is the state at the first draw
  const float2 D = zt::gaussian_mode(m * st + c, __ldg(p.pk + idx),
                                     p.flags & FIXED_POWER, 1.0f);
  const float Dr = D.x, Di = D.y;

  if (p.flags & JUST_DENSITY) {
    P[0] = make_float2(Dr - 0.0f, Di + 0.0f);
    P[1] = make_float2(Dr + 0.0f, Di - 0.0f);
    return;
  }
  float cx, cy, cz, f = 1.0f;
  if (p.flags & QPLT) {
    const size_t plane = (size_t)half * nn;
    cx = __ldg(p.coefs + idx);
    cy = __ldg(p.coefs + plane + idx);
    cz = __ldg(p.coefs + 2 * plane + idx);
    f = __ldg(p.coefs + 3 * plane + idx);
  } else {
    // the JAX package's expressions: k2 = n2 * fund^2, scale = fund / k2
    const int kz = z > half ? z - n : z;
    const int kx = x > half ? x - n : x;
    const int n2 = kx * kx + ky * ky + kz * kz;
    const float k2 = __fmul_rn((float)n2, p.fund2);
    const float ik2 = n2 == 0 ? 0.0f : __fdiv_rn(1.0f, k2);
    const float scale = __fmul_rn(p.fund, ik2);
    cx = __fmul_rn((float)kx, scale);
    cy = __fmul_rn((float)ky, scale);
    cz = __fmul_rn((float)kz, scale);
  }
  // F_j = c_j * (i D): re = -c_j * D_im, im = c_j * D_re
  const float2 F = make_float2(__fmul_rn(-cx, Di), __fmul_rn(cx, Dr));
  const float2 G = make_float2(__fmul_rn(-cy, Di), __fmul_rn(cy, Dr));
  const float2 H = make_float2(__fmul_rn(-cz, Di), __fmul_rn(cz, Dr));
  P[0] = make_float2(Dr - F.y, Di + F.x);   // A = D + iF
  P[1] = make_float2(Dr + F.y, Di - F.x);
  P[2] = make_float2(G.x - H.y, G.y + H.x); // B = G + iH
  P[3] = make_float2(G.x + H.y, G.y - H.x);
  if (p.flags & QPLT) {
    const float2 Ff = make_float2(__fmul_rn(F.x, f), __fmul_rn(F.y, f));
    const float2 Gf = make_float2(__fmul_rn(G.x, f), __fmul_rn(G.y, f));
    const float2 Hf = make_float2(__fmul_rn(H.x, f), __fmul_rn(H.y, f));
    P[4] = make_float2(0.0f - Ff.y, 0.0f + Ff.x);  // A2 = 0 + i f F
    P[5] = make_float2(0.0f + Ff.y, 0.0f - Ff.x);
    P[6] = make_float2(Gf.x - Hf.y, Gf.y + Hf.x);  // B2 = f G + i f H
    P[7] = make_float2(Gf.x + Hf.y, Gf.y - Hf.x);
  }
}

// (a) one block per (z, ky) row: synthesize, pack, fix, inverse FFT along x.
__global__ void __launch_bounds__(256) pack_x_kernel(Params p) {
  extern __shared__ float2 rows[];  // (2 * narray, n), bit-reversed
  const int z = blockIdx.x, ky = blockIdx.y;
  const int n = p.n, half = n >> 1, mask = n - 1;
  const int nrow = 2 * p.narray;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    float2 P[8];
    const bool mirror = ky == 0 && (z > half || (z == 0 && x > half));
    const bool origin = ky == 0 && z == 0 && x == 0;
    if (origin) {
      for (int r = 0; r < nrow; ++r) P[r] = make_float2(0.0f, 0.0f);
    } else if (mirror) {
      // ky=0 fixup: S+ = conj(S-) and S- = conj(S+) of the source mode
      float2 S[8];
      mode_packings(p, 0, (n - z) & mask, (n - x) & mask, S);
      for (int r = 0; r < nrow; r += 2) {
        P[r] = make_float2(S[r + 1].x, -S[r + 1].y);
        P[r + 1] = make_float2(S[r].x, -S[r].y);
      }
    } else {
      mode_packings(p, ky, z, x, P);
    }
    const unsigned xr = zt::bitrev((unsigned)x, p.logn);
    for (int r = 0; r < nrow; ++r) rows[r * n + xr] = P[r];
  }
  __syncthreads();
  zt::fft_smem<false>(rows, p.logn, zt::ilog2(nrow), n, 1, p.tw);
  // out[a, pm, reim, ky, z, x]: row r = 2a + pm, re plane then im plane
  const size_t nn = (size_t)n * n;
  const size_t reim_stride = (size_t)half * nn;
  for (int t = threadIdx.x; t < nrow * n; t += blockDim.x) {
    const int r = t / n, x = t - r * n;
    const float2 v = rows[r * n + x];
    float* base = p.out + (size_t)(2 * r) * reim_stride + (size_t)ky * nn
                  + (size_t)z * n + x;
    base[0] = v.x;
    base[reim_stride] = v.y;
  }
}

// (b) in-place inverse FFT along z of every packed (array, pm, ky) plane;
// one block per (x tile, ky, plane), tile of tx columns in shared memory.
__global__ void __launch_bounds__(256) fft_z_kernel(float* out, const float2* tw,
                                                    int n, int logn, int half,
                                                    int tx, int logtx) {
  extern __shared__ float2 cols[];  // (n, tx), z bit-reversed
  const int x0 = blockIdx.x * tx, ky = blockIdx.y, r = blockIdx.z;
  const size_t nn = (size_t)n * n;
  const size_t reim_stride = (size_t)half * nn;
  float* re = out + (size_t)(2 * r) * reim_stride + (size_t)ky * nn + x0;
  float* im = re + reim_stride;
  for (int t = threadIdx.x; t < n * tx; t += blockDim.x) {
    const int z = t >> logtx, xx = t & (tx - 1);
    const size_t o = (size_t)z * n + xx;
    cols[zt::bitrev((unsigned)z, logn) * tx + xx] = make_float2(re[o], im[o]);
  }
  __syncthreads();
  zt::fft_smem<true>(cols, logn, logtx, 1, tx, tw);
  for (int t = threadIdx.x; t < n * tx; t += blockDim.x) {
    const int z = t >> logtx, xx = t & (tx - 1);
    const size_t o = (size_t)z * n + xx;
    const float2 v = cols[z * tx + xx];
    re[o] = v.x;
    im[o] = v.y;
  }
}

// B3: the packed half spectrum, untransformed.
//
// Replaces the Pallas TPU kernel
//   zeldovich_tpu/ops/pallas_synth.py::halfspace_pack_pallas
// (body _pack_grid_kernel).  Contract: out (narray, 2, 2, half+1, Z, X)
// float32 = (array, +/- packing, re/im, ky, z, x), every mode of the
// generated half packed as in B1 (mode_packings), the ky=0 plane RAW (the
// caller applies the self-conjugate fixup) and the y-Nyquist row zero.
//
// What bounds it.  B1's per-mode work without its transforms: it reads
// pk (and the four PLT planes) and writes 16 (32 under PLT) float32 per
// mode, 2.2 GB at 512^3 plain: device-memory bytes.
//
// Design.  One thread per mode, consecutive threads along x, so each of
// the 2 * narray * 2 output planes is written coalesced; one block row of
// x per (z, ky).  The ky = half blocks write the zero row.
__global__ void __launch_bounds__(256) pack_kernel(Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y, ky = blockIdx.z;
  const int n = p.n, half = n >> 1, nrow = 2 * p.narray;
  if (x >= n) return;
  const size_t nn = (size_t)n * n;
  const size_t plane = (size_t)(half + 1) * nn;  // one (array, pm, reim) stack
  float* base = p.out + (size_t)ky * nn + (size_t)z * n + x;
  float2 P[8];
  if (ky == half) {
    for (int r = 0; r < nrow; ++r) P[r] = make_float2(0.0f, 0.0f);
  } else {
    mode_packings(p, ky, z, x, P);
  }
  // row r = 2a + pm: its re plane is stack 2r, its im plane 2r + 1
  for (int r = 0; r < nrow; ++r) {
    base[(size_t)(2 * r) * plane] = P[r].x;
    base[(size_t)(2 * r + 1) * plane] = P[r].y;
  }
}

}  // namespace

extern "C" int zt_b3_pack(const void* planes, const void* mzx, const void* czx,
                          const void* pk, const void* coefs, void* out, int n,
                          int narray, int flags, float fund, float fund2,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.planes = (const u64*)planes;
  p.mzx = (const u64*)mzx;
  p.czx = (const u64*)czx;
  p.pk = (const float*)pk;
  p.coefs = (const float*)coefs;
  p.tw = nullptr;
  p.out = (float*)out;
  p.n = n;
  p.logn = zt::ilog2(n);
  p.narray = narray;
  p.flags = flags;
  p.fund = fund;
  p.fund2 = fund2;
  const int threads = n < 256 ? n : 256;
  pack_kernel<<<dim3((n + threads - 1) / threads, n, n / 2 + 1), threads, 0,
                (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Column tile width of the strided passes: ~64 KB of shared memory.
extern "C" int zt_col_tile(int n) {
  int tx = 8192 / n;
  if (tx < 1) tx = 1;
  if (tx > n) tx = n;
  return tx;
}

extern "C" int zt_b1_pack_zx(const void* planes, const void* mzx, const void* czx,
                             const void* pk, const void* coefs, const void* tw,
                             void* out, int n, int narray, int flags, float fund,
                             float fund2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.planes = (const u64*)planes;
  p.mzx = (const u64*)mzx;
  p.czx = (const u64*)czx;
  p.pk = (const float*)pk;
  p.coefs = (const float*)coefs;
  p.tw = (const float2*)tw;
  p.out = (float*)out;
  p.n = n;
  p.logn = zt::ilog2(n);
  p.narray = narray;
  p.flags = flags;
  p.fund = fund;
  p.fund2 = fund2;
  const int half = n / 2;
  cudaStream_t s = (cudaStream_t)stream;

  const size_t smem_a = (size_t)2 * narray * n * sizeof(float2);
  if ((err = zt::allow_smem(pack_x_kernel, smem_a)) != cudaSuccess) return (int)err;
  pack_x_kernel<<<dim3(n, half), 256, smem_a, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int tx = zt_col_tile(n);
  const size_t smem_b = (size_t)n * tx * sizeof(float2);
  if ((err = zt::allow_smem(fft_z_kernel, smem_b)) != cudaSuccess) return (int)err;
  fft_z_kernel<<<dim3(n / tx, half, 2 * narray), 256, smem_b, s>>>(
      p.out, p.tw, n, p.logn, half, tx, zt::ilog2(tx));
  return (int)cudaGetLastError();
}

extern "C" const char* zt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
