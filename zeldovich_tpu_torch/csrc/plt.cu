// The PLT coefficient planes: for every mode of the generated planes
// [y0, y0 + rows) of the half space, the eigenmode lookup, its
// k^2 / (k . e) up-weighting, fund / k^2 and the PLT growth factor f,
// written as the four planes (4, rows, Z, X) = (cx, cy, cz, f) that B1
// and B3 read, for one H100 (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes these planes with XLA
// ops (zeldovich_tpu/ops/modes_real.py::plt_coef_fields).  It replaces the
// port's chunked torch version (ops/modes_real.py::plt_coef_fields_plain):
// ~100 launches a chunk of 32 planes, each gather a (.., 4) temporary.
// Contract: plt_coef_fields_plain's expressions in its order (the direct
// gather where n divides the table's E, else the trilinear interpolation
// with the Nyquist fix, the ix/iy wrap and the iz clamp, the kz fold and
// the ez flip, the normalisation, the up-weighting and its zero rules,
// fund / k^2, f and the optional rescaling), every product rounded on its
// own (mul_rn), so that no multiply-add is contracted; the float64 table
// rounded to the element type F as it is loaded (table.to(F)).  float
// here; double through plt_f64.cu (entry zt_plt_coefs_f64).
//
// What bounds it.  The output: 4 * rows * n^2 elements written once, 2.147
// GB at 512^3 float64 (0.641 ms at 3.35 TB/s; float32 0.320 ms).  The
// table (34.1 MB at E = 128) is read once and stays in the 50 MB L2; ~170
// operations a mode (two square roots, five divisions, the trilinear sums)
// take ~0.35 ms at 33.5 TFLOP/s.  Bytes.
//
// Design.  A block of `threads` threads covers a tile of threads * VEC
// consecutive x of one plane ky and walks a tile of `zt` z rows; a thread
// computes VEC consecutive x and writes each plane with one 16-byte store
// (8 bytes in float where n % 4 != 0).  What decides the speed is the
// table's reuse: at 512^3 on the 128 table each table entry feeds 64 modes
// at 8 corners, and a 32-byte load a corner and mode would move ~17 GB
// through L2, eight times the output.  So where the lookup interpolates,
// the block stages in shared memory, rounded to F, the entries its tile
// needs: every ix from its first x's lower neighbour to its last x's upper
// one (at most `cap`, the most any tile needs, which the host computes),
// at the plane's two iy and the row's two iz, as 16 arrays of `cap`
// (corner and component major, ix fastest: a warp reads neighbouring
// words, no bank conflicts).  Neighbouring z rows with the same lower iz
// reuse the stage; it is loaded again only where iz moves (every 4 rows at
// 512 on 128).  Where the grids coincide (the direct gather) a mode reads
// one 32-byte entry that no other mode of its tile reads: no stage.

#include "real.cuh"

namespace {

using zt::div_rn;
using zt::mul_rn;
using zt::sqrt_rn;

// threads a block at most (the host's kernels.PLT_THREADS)
constexpr int PLT_THREADS = 128;

template <typename F>
struct PltParams {
  const double* table;  // (E, E, E/2 + 1, 4) float64: eigenvector, eigenvalue
  F* out;               // (4, rows, n, n): cx, cy, cz, f
  int n, E, y0, rows;
  int step;  // E / n where n divides E (the direct gather), else 0
  int cap;   // staged ix a block holds (interpolation)
  int zt;    // z rows a block walks
  F scale;   // fl(E / n)
  F fund, fund2, fcl, base, target;  // fundamental, fl(fund^2), f_cluster, rescaling
  int rescale;
};

__device__ __forceinline__ float floor_of(float a) { return floorf(a); }
__device__ __forceinline__ double floor_of(double a) { return floor(a); }
__device__ __forceinline__ float pow_of(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double pow_of(double a, double b) { return pow(a, b); }

// don't interpolate across the +Nyquist / -Nyquist discontinuity
template <typename F>
__device__ __forceinline__ F nyquist_fix(F f, int E) {
  return (f > F(E / 2) && f < F(E / 2 + 1)) ? floor_of(f + F(1)) : f;
}

// a mode's (cx, cy, cz, f) from its looked-up eigenvector and eigenvalue
template <typename F>
__device__ __forceinline__ void finish(const PltParams<F>& p, F ex, F ey, F ez, F ev,
                                       int kx, int ky, int kz, F c[4]) {
  if (kz < 0) ez = -ez;  // the table holds the +kz half space
  F mag = sqrt_rn(mul_rn(ex, ex) + mul_rn(ey, ey) + mul_rn(ez, ez));
  if (mag == F(0)) mag = F(1);
  ex = div_rn(ex, mag);
  ey = div_rn(ey, mag);
  ez = div_rn(ez, mag);
  const long long n2 = (long long)kx * kx + (long long)ky * ky + (long long)kz * kz;
  const F k2 = (F)n2;
  const F dot = mul_rn((F)kx, ex) + mul_rn((F)ky, ey) + mul_rn((F)kz, ez);
  F norm = div_rn(k2, dot == F(0) ? F(1) : dot);
  if (n2 == 0 || dot == F(0) || !isfinite(norm)) norm = F(0);
  const F ik2 = n2 == 0 ? F(0) : div_rn(F(1), mul_rn(k2, p.fund2));
  const F f = mul_rn(sqrt_rn(F(1) + mul_rn(mul_rn(ev, F(24)), p.fcl)) - F(1), F(0.25));
  const F scale =
      mul_rn(p.rescale ? mul_rn(pow_of(p.base, p.target - f), p.fund) : p.fund, ik2);
  c[0] = mul_rn(mul_rn(norm, ex), scale);
  c[1] = mul_rn(mul_rn(norm, ey), scale);
  c[2] = mul_rn(mul_rn(norm, ez), scale);
  c[3] = f;
}

__device__ __forceinline__ void store(float* o, const float (&v)[2]) {
  *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store(float* o, const float (&v)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(double* o, const double (&v)[2]) {
  *reinterpret_cast<double2*>(o) = make_double2(v[0], v[1]);
}

// the 4 float64 of the table entry at offset e (in entries), rounded to F
template <typename F>
__device__ __forceinline__ void entry(const double* table, long long e, F t[4]) {
  const double2* q = reinterpret_cast<const double2*>(table + 4 * e);
  const double2 a = __ldg(q), b = __ldg(q + 1);
  t[0] = (F)a.x;
  t[1] = (F)a.y;
  t[2] = (F)b.x;
  t[3] = (F)b.y;
}

template <typename F, int VEC>
__global__ void __launch_bounds__(PLT_THREADS) plt_coefs_kernel(const PltParams<F> p) {
  extern __shared__ __align__(16) unsigned char plt_smem[];
  F* const sm = reinterpret_cast<F*>(plt_smem);
  const int n = p.n, half = n >> 1, E = p.E, tz = E / 2 + 1;  // tz: the table's iz extent
  const int xt = blockDim.x * VEC, x0 = blockIdx.x * xt;
  const int xs = x0 + threadIdx.x * VEC;  // this thread's first x
  const bool live = xs < n;
  const int ky = p.y0 + blockIdx.z;
  const int z0 = blockIdx.y * p.zt, z1 = min(z0 + p.zt, n);
  const long long nn = (long long)n * n, plane = (long long)p.rows * nn;
  F* const row = p.out + (long long)blockIdx.z * nn + xs;
  F c[4][VEC];

  if (p.step) {  // the direct gather: table[x step, ky step, iz step]
    if (!live) return;
    const long long sy = (long long)ky * p.step;
    for (int z = z0; z < z1; ++z) {
      const int kz = z > half ? z - n : z, iz = z > half ? n - z : z;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int x = xs + v;
        F t[4], cv[4];
        entry<F>(p.table, ((long long)x * p.step * E + sy) * tz + (long long)iz * p.step, t);
        finish<F>(p, t[0], t[1], t[2], t[3], x > half ? x - n : x, ky, kz, cv);
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j][v] = cv[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) store(row + (long long)z * n + j * plane, c[j]);
    }
    return;
  }

  // trilinear: the plane's two iy and their weight
  const F fy = nyquist_fix<F>(mul_rn(p.scale, (F)ky), E);
  const int iyl = (int)fy, iyh = iyl + 1 == E ? 0 : iyl + 1;
  const F wy = fy - (F)iyl, ay = F(1) - wy;
  // the tile's staged ix: [ixa, ixa + R), E standing for 0 (the wrap)
  const int xl = min(x0 + xt, n) - 1;
  const int ixa = (int)nyquist_fix<F>(mul_rn(p.scale, (F)x0), E);
  const int R = (int)nyquist_fix<F>(mul_rn(p.scale, (F)xl), E) + 2 - ixa;
  if (R > p.cap) __trap();  // the host's cap is the most any tile needs
  const int cap = p.cap;
  int staged = -1;  // the lower iz the stage holds
  for (int z = z0; z < z1; ++z) {
    const int kz = z > half ? z - n : z, iz = z > half ? n - z : z;
    const F fz = nyquist_fix<F>(mul_rn(p.scale, (F)iz), E);
    const int izl = (int)fz, izh = min(izl + 1 == E ? 0 : izl + 1, tz - 1);
    const F wz = fz - (F)izl, az = F(1) - wz;
    if (izl != staged) {
      __syncthreads();  // every read of the old stage is done
      // item i: slot s = i / 4 (ix = ixa + s), corner (iy, iz) = i % 4
      for (int i = threadIdx.x; i < 4 * R; i += blockDim.x) {
        const int s = i >> 2, ix = ixa + s == E ? 0 : ixa + s;
        F t[4];
        entry<F>(p.table, ((long long)ix * E + (i & 2 ? iyh : iyl)) * tz + (i & 1 ? izh : izl),
                 t);
        F* d = sm + (i & 3) * 4 * cap + s;
#pragma unroll
        for (int k = 0; k < 4; ++k) d[k * cap] = t[k];
      }
      __syncthreads();
      staged = izl;
    }
    if (!live) continue;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int x = xs + v;
      const F fx = nyquist_fix<F>(mul_rn(p.scale, (F)x), E);
      const int sl = (int)fx - ixa;  // the slot of ixl; ixh's is sl + 1
      const F wx = fx - (F)(int)fx, ax = F(1) - wx;
      // weights of the corners (x, y, z) = lll, llh, lhl, lhh, hll, hlh,
      // hhl, hhh: the plain version's products, left to right
      const F xy[4] = {mul_rn(ax, ay), mul_rn(ax, wy), mul_rn(wx, ay), mul_rn(wx, wy)};
      F w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) w[q] = mul_rn(xy[q >> 1], q & 1 ? wz : az);
      F e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // corner q reads stage corner (iy, iz) = q % 4 at slot sl + q / 4
        F acc = mul_rn(w[0], sm[k * cap + sl]);
#pragma unroll
        for (int q = 1; q < 8; ++q)
          acc = acc + mul_rn(w[q], sm[((q & 3) * 4 + k) * cap + sl + (q >> 2)]);
        e[k] = acc;
      }
      F cv[4];
      finish<F>(p, e[0], e[1], e[2], e[3], x > half ? x - n : x, ky, kz, cv);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j][v] = cv[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) store(row + (long long)z * n + j * plane, c[j]);
  }
}

using zt::real;

template <int VEC>
cudaError_t launch(const PltParams<real>& p, int threads, cudaStream_t stream) {
  const int xt = threads * VEC;
  const int smem = p.step ? 0 : 16 * p.cap * (int)sizeof(real);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        plt_coefs_kernel<real, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  plt_coefs_kernel<real, VEC><<<dim3((p.n + xt - 1) / xt, (p.n + p.zt - 1) / p.zt, p.rows),
                                threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The planes [y0, y0 + rows) into out (4, rows, n, n), from the float64
// table (E, E, E/2 + 1, 4); the launch geometry (threads, vec, zt, cap,
// step, scale) is kernels.plt_geometry's.
extern "C" int ZT_ENTRY(zt_plt_coefs)(const void* table, void* out, int n, int E, int y0,
                                      int rows, int step, int cap, int threads, int vec,
                                      int zt, real scale, real fund, real fund2, real fcl,
                                      real base, real target, int rescale, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (threads < 1 || threads > PLT_THREADS || zt < 1) return (int)cudaErrorInvalidValue;
  PltParams<real> p;
  p.table = (const double*)table;
  p.out = (real*)out;
  p.n = n;
  p.E = E;
  p.y0 = y0;
  p.rows = rows;
  p.step = step;
  p.cap = cap;
  p.zt = zt;
  p.scale = scale;
  p.fund = fund;
  p.fund2 = fund2;
  p.fcl = fcl;
  p.base = base;
  p.target = target;
  p.rescale = rescale;
  if (vec == 2) return (int)launch<2>(p, threads, (cudaStream_t)stream);
#ifndef ZT_F64
  if (vec == 4) return (int)launch<4>(p, threads, (cudaStream_t)stream);
#endif
  return (int)cudaErrorInvalidValue;
}
