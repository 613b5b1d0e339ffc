// B1: half-spectrum mode synthesis + packing + ky=0 fixup + inverse DFTs
// along x and z, for one H100 (sm_90a); and B3 (zt_b3_pack, below), the
// same synthesis and packing alone.
//
// Replaces the Pallas TPU kernel
//   zeldovich_tpu/ops/pallas_synth.py::halfspace_pack_zx_pallas
// (bodies _pack_zx_kernel / _pack_zx_pair_kernel / _pack_zx_pipe_kernel;
// helpers _row_draws, _draw_chain, _row_pack, _row_fix, _row_dots).
// Contract: out (narray, 2, 2, nky, Z, X) of the element type F (float
// here; double through synth_f64.cu, entry points *_f64: the exact
// float64 draws and the field math from fund and fund * fund in double) =
// (array, +/- packing, re/im, ky, z, x) for the generated planes
// ky in [ky0, ky0 + nky) (the main path: all half of them), the
// always-zero y-Nyquist row omitted (the pair form), unnormalized sign +1
// transforms.
//
// What bounds it.  Per mode the synthesis is one 128-bit multiply-add,
// one LCG step, two XSL-RR permutations, a log, a short polynomial sincos
// and a dozen multiplies; each of the 2 * narray packed sequences then
// takes ~5 log2(n) flops a element in each of the two transforms.  The
// output is 16 (plain) or 32 (PLT) float32 per mode of the half grid,
// 2.15 GB at 512^3 plain, written once: bound by device-memory traffic
// (0.64 ms at 3.35 TB/s), with the synthesis and the x pass's butterflies
// of the same order of issue slots.  The design moves the output three
// times (launch (a) writes it, (b) reads and writes it).
//
// Design: two launches of fft_pass.cuh's layouts.
//  (a) pack_rows_kernel, synthesis + packing + the x pass: a (ky, z) row
//      is one sequence of the rows layout, T = n / E threads.  Thread t
//      synthesizes the E modes it loads in pass 0's pattern, x = t + r T
//      (reads of pk, mzx, czx and the PLT planes coalesced along x), and
//      keeps their deviates D (and, without PLT, each mode's fund / k^2)
//      in its own shared-memory slots (12 B a mode, 24-48 KB a block).
//      Then the row's 2 * narray packed sequences, one after another: form
//      the sequence's values from D, transform them in registers with the
//      1-2 padded exchanges, store them in natural order, coalesced along
//      x.  Registers hold one sequence, indexed by compile-time constants
//      only (no stack frame, no spills: chip_smoke.py checks ptxas; D and
//      the scales in registers as well spilled at E = 16).  256 threads a
//      block, three blocks a SM at E = 8 (b1_min_blocks).  double: the
//      slots are 24 B a mode (48 KB a block), a sequence is twice the
//      registers: 256 threads of 128 registers at E = 8, 128 threads of
//      255 at E = 16, two blocks a SM.
//      The ky=0 self-conjugate fixup is index-pure: a thread at ky=0 in
//      the in-plane mirror half synthesizes its source mode
//      (0, (n-z)%n, (n-x)%n) itself and forms the conjugate of the
//      source's opposite packing (JAX's fixm rule, _row_fix); the origin
//      is zero.  No pass over the ky=0 plane, no cross-block dependence.
//  (b) the z pass: the column kernel of csrc/fft_axis.cu (zt_cols_dft),
//      in place on out, exactly zx's z pass with K = nky planes.

#include "fft_pass.cuh"
#include "pcg.cuh"

extern "C" int ZT_ENTRY(zt_cols_dft)(int n, const void* in, void* out, const void* tw,
                                     long long inner, long long nitems, int K,
                                     long long kstride, long long bstride, long long comp,
                                     void* stream);

namespace {

using zt::u128;
using zt::u64;

enum { FIXED_POWER = 1, JUST_DENSITY = 2, QPLT = 4 };

template <typename F>
struct Params {
  const u64* planes;   // (half, 2) [lo, hi] per-y-plane start states
  const u64* mzx;      // (2, Z, X) precomposed pre-bumped multipliers
  const u64* czx;      // (2, Z, X) increments
  const F* pk;         // (nky, Z, X) pk_effective of planes [ky0, ky0 + nky)
  const F* coefs;      // (4, nky, Z, X) PLT cx, cy, cz, f (QPLT only)
  const vec2<F>* tw;   // (n/2) twiddles exp(+2 pi i j / n) (B1)
  F* out;
  int n, narray, flags, ky0, nky;
  F fund, fund2;       // fundamental and fl(fund * fund), rounded to F
};

// c * (i D): re = -c * D_im, im = c * D_re
template <typename F>
__device__ __forceinline__ vec2<F> times_i(F c, vec2<F> D) {
  return make2<F>(zt::mul_rn(-c, D.y), zt::mul_rn(c, D.x));
}

template <typename F>
__device__ __forceinline__ vec2<F> scaled(vec2<F> a, F f) {
  return make2<F>(zt::mul_rn(a.x, f), zt::mul_rn(a.y, f));
}

// Array A of a mode with deviate D as P + iQ of two real fields: (D, F),
// (G, H), (0, fF), (fG, fH) with (F, G, H) = (cx, cy, cz) * (i D).
// coef(j) gives cx, cy, cz, f (j = 0..3) and is asked only for what array
// A uses; density only, coef(0) = 0 and the array is D.  The JAX
// package's expressions and rounding (_row_pack, _finish_fields).
template <typename F, int A, class Coef>
__device__ __forceinline__ void array_fields(vec2<F> D, const Coef& coef, vec2<F>& P,
                                             vec2<F>& Q) {
  if constexpr (A == 0) {
    P = D;
    Q = times_i<F>(coef(0), D);
  } else if constexpr (A == 1) {
    P = times_i<F>(coef(1), D);
    Q = times_i<F>(coef(2), D);
  } else if constexpr (A == 2) {
    P = make2<F>(F(0), F(0));
    Q = scaled<F>(times_i<F>(coef(0), D), coef(3));
  } else {
    const F f = coef(3);
    P = scaled<F>(times_i<F>(coef(1), D), f);
    Q = scaled<F>(times_i<F>(coef(2), D), f);
  }
}

// S+ = P + iQ, or S- = P - iQ (minus)
template <typename F>
__device__ __forceinline__ vec2<F> packed(vec2<F> P, vec2<F> Q, bool minus) {
  return minus ? make2<F>(P.x + Q.y, P.y - Q.x) : make2<F>(P.x - Q.y, P.y + Q.x);
}

// The deviate D of mode (ky, z, x) (ky absolute).
template <typename F>
__device__ __forceinline__ vec2<F> mode_deviate(const Params<F>& p, int ky, int z, int x) {
  const size_t nn = (size_t)p.n * p.n;
  const size_t zx = (size_t)z * p.n + x;
  const u128 m = zt::load_u128(p.mzx + zx, p.mzx + nn + zx);
  const u128 c = zt::load_u128(p.czx + zx, p.czx + nn + zx);
  const u128 st = zt::load_u128(p.planes + 2 * ky, p.planes + 2 * ky + 1);
  // the tables are pre-bumped: m * st + c is the state at the first draw
  return zt::gaussian_mode<F>(m * st + c, __ldg(p.pk + (size_t)(ky - p.ky0) * nn + zx),
                              p.flags & FIXED_POWER, F(1));
}

// The signed wavenumber of index i
__device__ __forceinline__ int wavenumber(int i, int n) { return i > n / 2 ? i - n : i; }

// fund / k^2 of mode (ky, z, x) (0 at the origin): the JAX package's
// expressions, k2 = n2 * fund^2, scale = fund / k2
template <typename F>
__device__ __forceinline__ F field_scale(const Params<F>& p, int ky, int z, int x) {
  const int kz = wavenumber(z, p.n), kx = wavenumber(x, p.n);
  const int n2 = kx * kx + ky * ky + kz * kz;
  const F k2 = zt::mul_rn((F)n2, p.fund2);
  const F ik2 = n2 == 0 ? F(0) : zt::div_rn(F(1), k2);
  return zt::mul_rn(p.fund, ik2);
}

// The packing configuration, fixed for a run: MODE = QPLT, JUST_DENSITY
// or 0 (the Zel'dovich fields of the wavevector)
template <typename F>
__device__ __forceinline__ int packing_mode(const Params<F>& p) {
  return p.flags & QPLT ? QPLT : p.flags & JUST_DENSITY ? JUST_DENSITY : 0;
}

// coefficient j (cx, cy, cz, f) of mode (ky, z, x): a PLT plane, or
// k_j * scale (scale = field_scale) and f = 1; 0 for density only
template <typename F, int MODE>
__device__ __forceinline__ F field_coef(const Params<F>& p, int j, int ky, int z, int x,
                                        F scale) {
  if constexpr (MODE == JUST_DENSITY) {
    return F(0);
  } else if constexpr (MODE == QPLT) {
    const size_t nn = (size_t)p.n * p.n;
    return __ldg(p.coefs + ((size_t)j * p.nky + (ky - p.ky0)) * nn + (size_t)z * p.n + x);
  } else {
    if (j == 3) return F(1);
    const int k = j == 0 ? wavenumber(x, p.n) : j == 1 ? ky : wavenumber(z, p.n);
    return zt::mul_rn((F)k, scale);
  }
}

template <typename F, int A, class Coef>
__device__ __forceinline__ void both_packings(vec2<F> D, const Coef& coef, vec2<F>* P) {
  vec2<F> U, V;
  array_fields<F, A>(D, coef, U, V);
  P[2 * A] = packed<F>(U, V, false);
  P[2 * A + 1] = packed<F>(U, V, true);
}

template <typename F, int MODE>
__device__ __forceinline__ void mode_packings_of(const Params<F>& p, int ky, int z, int x,
                                                 vec2<F>* P) {
  const vec2<F> D = mode_deviate<F>(p, ky, z, x);
  const F scale = MODE == 0 ? field_scale<F>(p, ky, z, x) : F(0);
  const auto coef = [&](int j) { return field_coef<F, MODE>(p, j, ky, z, x, scale); };
  both_packings<F, 0>(D, coef, P);
  if constexpr (MODE != JUST_DENSITY) both_packings<F, 1>(D, coef, P);
  if constexpr (MODE == QPLT) {
    both_packings<F, 2>(D, coef, P);
    both_packings<F, 3>(D, coef, P);
  }
}

// Both packings (S+, S-) of every array for mode (ky, z, x) of the
// generated half-space: P[2a] = S+ of array a, P[2a+1] = S-.
template <typename F>
__device__ __forceinline__ void mode_packings(const Params<F>& p, int ky, int z, int x,
                                              vec2<F>* P) {
  switch (packing_mode(p)) {
    case QPLT: mode_packings_of<F, QPLT>(p, ky, z, x, P); break;
    case JUST_DENSITY: mode_packings_of<F, JUST_DENSITY>(p, ky, z, x, P); break;
    default: mode_packings_of<F, 0>(p, ky, z, x, P);
  }
}

// Sequence 2 A + pm of a pack_rows thread's E elements into v: element r
// is x = t + r T of row (ky, z); on the ky = 0 mirror half (bit r of
// mirror) it is the conjugate of the source mode's opposite packing, the
// source (ky, zs, (n - x) % n).  D[r * NT] and scale[r * NT] hold the
// modes' deviates and field scales (of the source on the mirror half).
// No branch inside: every element's loads can issue before the first use.
template <typename F, int A, int N, int NT, int MODE>
__device__ __forceinline__ void sequence(const Params<F>& p, int pm, int t, int ky, int zs,
                                         unsigned mirror, const vec2<F>* D, const F* scale,
                                         vec2<F>* v) {
  constexpr int E = reg::elems(N), T = N / E;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const bool m = (mirror >> r) & 1;
    const int xs = m ? (N - (t + r * T)) & (N - 1) : t + r * T;
    const F sc = scale[r * NT];
    const auto coef = [&](int j) { return field_coef<F, MODE>(p, j, ky, zs, xs, sc); };
    vec2<F> P, Q;
    array_fields<F, A>(D[r * NT], coef, P, Q);
    const vec2<F> w = packed<F>(P, Q, pm ^ m);
    v[r] = make2<F>(w.x, m ? -w.y : w.y);
  }
}

// sequence<A> in the run's packing mode (density only has array 0 alone,
// arrays 2 and 3 exist under PLT alone: only those are instantiated)
template <typename F, int A, int N, int NT>
__device__ __forceinline__ void sequence_in(int mode, const Params<F>& p, int pm, int t,
                                            int ky, int zs, unsigned mirror, const vec2<F>* D,
                                            const F* scale, vec2<F>* v) {
  if (mode == QPLT) {
    sequence<F, A, N, NT, QPLT>(p, pm, t, ky, zs, mirror, D, scale, v);
  } else if constexpr (A < 2) {
    if (A == 0 && mode == JUST_DENSITY)
      sequence<F, 0, N, NT, JUST_DENSITY>(p, pm, t, ky, zs, mirror, D, scale, v);
    else
      sequence<F, A, N, NT, 0>(p, pm, t, ky, zs, mirror, D, scale, v);
  }
}

// threads of a pack_rows block and the blocks a SM its registers allow
// (measured at 512^3: three blocks of 80 registers take 1.69 ms, two of
// 128 2.03 ms, four of 64 spill): 256 threads of at most 80 registers at
// E = 8, of 128 at E = 16; at n = 2048 (radix-16 passes and the PLT
// sequences spill at 128) 128 threads of at most 168.  double: a sequence
// is twice the registers, so two blocks a SM: 256 threads of at most 128
// at E = 8, 128 threads of at most 255 at E = 16
template <typename F>
__host__ __device__ constexpr int b1_threads(int n) {
  return sizeof(F) == 8 ? (reg::elems(n) == 16 ? 128 : 256) : n == 2048 ? 128 : 256;
}
template <typename F>
__host__ __device__ constexpr int b1_min_blocks(int n) {
  return sizeof(F) == 8 ? 2 : n == 2048 ? 3 : reg::elems(n) == 8 ? 3 : 2;
}

// rows of a pack_rows block, within one z-plane
template <typename F>
__host__ __device__ constexpr int b1_rows(int n) {
  return b1_threads<F>(n) / threads_per_seq(n) < n ? b1_threads<F>(n) / threads_per_seq(n)
                                                    : n;
}

// shared memory of a pack_rows block: the exchange planes, then each
// thread's deviates and field scales
template <typename F, int N>
__host__ __device__ constexpr size_t pack_rows_smem() {
  return (2 * (size_t)extent<false>(N) * b1_rows<F>(N) + 3 * (size_t)b1_rows<F>(N) * N) *
         sizeof(F);
}

// (a) ROWS (ky, z) rows a block: synthesize, pack, fix, inverse FFT along x.
template <typename F, int N>
__global__ void __launch_bounds__(b1_rows<F>(N) * threads_per_seq(N), b1_min_blocks<F>(N))
    pack_rows_kernel(Params<F> p) {
  constexpr int E = reg::elems(N), T = threads_per_seq(N), ROWS = b1_rows<F>(N);
  constexpr int NT = ROWS * T;  // threads
  constexpr int RL = reg::radix(N, reg::npass(N) - 1);
  constexpr int ROW = extent<false>(N), HALF = N / 2;
  F* smem = zt::shared_elems<F>();
  F* sre = smem;
  F* sim = smem + ROW * ROWS;
  // the thread's own slots, element r at [r * NT]: only it reads them
  vec2<F>* D = reinterpret_cast<vec2<F>*>(smem + 2 * ROW * ROWS) + threadIdx.x;
  F* scale = smem + 2 * ROW * ROWS + 2 * E * NT + threadIdx.x;
  const int t = threadIdx.x % T, q = threadIdx.x / T;
  const int g = blockIdx.x * ROWS + q;  // row of the output's (nky, Z)
  const int ky = p.ky0 + g / N, z = g % N;
  const bool plane0 = ky == 0;
  // the source plane row of the mirror half's modes: (n - z) % n
  const int zs = plane0 && z > HALF ? N - z : z;
  const int mode = packing_mode(p);
  unsigned mirror = 0;  // bit r: element r is on the ky = 0 mirror half
  // four modes' draws in flight at a time (all E at once hold E sets of
  // 128-bit table entries and spill)
#pragma unroll 4
  for (int r = 0; r < E; ++r) {
    const int x = t + r * T;
    const bool m = plane0 && (z > HALF || (z == 0 && x > HALF));
    const int xs = m ? (N - x) & (N - 1) : x;
    mirror |= (unsigned)m << r;
    D[r * NT] = mode_deviate<F>(p, ky, zs, xs);
    scale[r * NT] = mode == 0 ? field_scale<F>(p, ky, zs, xs) : F(0);
  }
  const F s = __ldg(&p.tw[N / 4]).y;  // the table's sign
  const size_t nn = (size_t)N * N, comp = (size_t)p.nky * nn;
  const bool origin = plane0 && z == 0 && t == 0;  // element 0
#pragma unroll 1
  for (int seq = 0; seq < 2 * p.narray; ++seq) {
    if (seq > 0) __syncthreads();  // the last sequence's exchange reads are done
    // t and mirror as the loop sees them: keeps each element's indices,
    // coefficients and PLT loads inside the loop (hoisted out of it, E of
    // each would not fit the registers)
    int tl = t;
    unsigned ml = mirror;
    asm volatile("" : "+r"(tl), "+r"(ml));
    vec2<F> v[E];
    const int pm = seq & 1;
    switch (seq >> 1) {
      case 0: sequence_in<F, 0, N, NT>(mode, p, pm, tl, ky, zs, ml, D, scale, v); break;
      case 1: sequence_in<F, 1, N, NT>(mode, p, pm, tl, ky, zs, ml, D, scale, v); break;
      case 2: sequence_in<F, 2, N, NT>(mode, p, pm, tl, ky, zs, ml, D, scale, v); break;
      default: sequence_in<F, 3, N, NT>(mode, p, pm, tl, ky, zs, ml, D, scale, v);
    }
    if (origin) v[0] = make2<F>(F(0), F(0));
    transform<F, N, false, ROWS>(v, t, q * ROW, sre, sim, p.tw, s);
    // out[a, pm, reim, ky, z, x]: sequence 2a + pm, re plane then im plane
    F* row = p.out + 2 * seq * comp + (size_t)g * N + t;
#pragma unroll
    for (int b2 = 0; b2 < E / RL; ++b2) {
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int o = b2 * T + r * (N / RL);
        const vec2<F> x = v[b2 * RL + r];
        row[o] = x.x;
        row[o + comp] = x.y;
      }
    }
  }
}

template <typename F, int N>
cudaError_t launch_pack_rows(const Params<F>& p, cudaStream_t s) {
  constexpr int ROWS = b1_rows<F>(N);
  constexpr size_t smem = pack_rows_smem<F, N>();
  cudaError_t err = zt::allow_smem(pack_rows_kernel<F, N>, smem);
  if (err != cudaSuccess) return err;
  pack_rows_kernel<F, N>
      <<<(unsigned)((long long)p.nky * N / ROWS), ROWS * threads_per_seq(N), smem, s>>>(p);
  return cudaGetLastError();
}

template <typename F>
cudaError_t pack_rows(const Params<F>& p, cudaStream_t s) {
  switch (p.n) {
    case 16: return launch_pack_rows<F, 16>(p, s);
    case 32: return launch_pack_rows<F, 32>(p, s);
    case 64: return launch_pack_rows<F, 64>(p, s);
    case 128: return launch_pack_rows<F, 128>(p, s);
    case 256: return launch_pack_rows<F, 256>(p, s);
    case 512: return launch_pack_rows<F, 512>(p, s);
    case 1024: return launch_pack_rows<F, 1024>(p, s);
    case 2048: return launch_pack_rows<F, 2048>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// B3: the packed half spectrum, untransformed.
//
// Replaces the Pallas TPU kernel
//   zeldovich_tpu/ops/pallas_synth.py::halfspace_pack_pallas
// (body _pack_grid_kernel).  Contract: out (narray, 2, 2, half+1, Z, X)
// of F = (array, +/- packing, re/im, ky, z, x), every mode of the
// generated half packed as in B1 (mode_packings), the ky=0 plane RAW (the
// caller applies the self-conjugate fixup) and the y-Nyquist row zero.
//
// What bounds it.  B1's per-mode work without its transforms: it reads
// pk (and the four PLT planes) and writes 16 (32 under PLT) elements per
// mode, 2.2 GB at 512^3 plain float (double 4.3 GB): device-memory bytes.
//
// Design.  One thread per mode, consecutive threads along x, so each of
// the 2 * narray * 2 output planes is written coalesced; one block row of
// x per (z, ky).  The ky = half blocks write the zero row.
template <typename F>
__global__ void __launch_bounds__(256) pack_kernel(Params<F> p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y, ky = blockIdx.z;
  const int n = p.n, half = n >> 1, nrow = 2 * p.narray;
  if (x >= n) return;
  const size_t nn = (size_t)n * n;
  const size_t plane = (size_t)(half + 1) * nn;  // one (array, pm, reim) stack
  F* base = p.out + (size_t)ky * nn + (size_t)z * n + x;
  // P is indexed by compile-time constants only (the loops below are
  // unrolled over all 8 rows and guarded), so it stays in registers: with
  // run-time bounds the double instance kept it on the stack
  vec2<F> P[8];
  if (ky == half) {
#pragma unroll
    for (int r = 0; r < 8; ++r) P[r] = make2<F>(F(0), F(0));
  } else {
    mode_packings<F>(p, ky, z, x, P);
  }
  // row r = 2a + pm: its re plane is stack 2r, its im plane 2r + 1
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r < nrow) {
      base[(size_t)(2 * r) * plane] = P[r].x;
      base[(size_t)(2 * r + 1) * plane] = P[r].y;
    }
  }
}

}  // namespace

namespace {

using zt::real;

Params<real> make_params(const void* planes, const void* mzx, const void* czx,
                         const void* pk, const void* coefs, const void* tw, void* out, int n,
                         int narray, int flags, real fund, real fund2, int ky0, int nky) {
  Params<real> p;
  p.planes = (const u64*)planes;
  p.mzx = (const u64*)mzx;
  p.czx = (const u64*)czx;
  p.pk = (const real*)pk;
  p.coefs = (const real*)coefs;
  p.tw = (const zt::real2*)tw;
  p.out = (real*)out;
  p.n = n;
  p.narray = narray;
  p.flags = flags;
  p.ky0 = ky0;
  p.nky = nky;
  p.fund = fund;
  p.fund2 = fund2;
  return p;
}

}  // namespace

extern "C" int ZT_ENTRY(zt_b3_pack)(const void* planes, const void* mzx, const void* czx,
                                    const void* pk, const void* coefs, void* out, int n,
                                    int narray, int flags, real fund, real fund2,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params<real> p = make_params(planes, mzx, czx, pk, coefs, nullptr, out, n, narray,
                                     flags, fund, fund2, 0, n / 2);
  const int threads = n < 256 ? n : 256;
  pack_kernel<real><<<dim3((n + threads - 1) / threads, n, n / 2 + 1), threads, 0,
                      (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// B1 over the generated planes [ky0, ky0 + nky): pk (nky, Z, X), coefs
// (4, nky, Z, X) or null, out (narray, 2, 2, nky, Z, X).
extern "C" int ZT_ENTRY(zt_b1_pack_zx)(const void* planes, const void* mzx, const void* czx,
                                       const void* pk, const void* coefs, const void* tw,
                                       void* out, int n, int narray, int flags, real fund,
                                       real fund2, int ky0, int nky, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params<real> p = make_params(planes, mzx, czx, pk, coefs, tw, out, n, narray, flags,
                                     fund, fund2, ky0, nky);
  if ((err = pack_rows(p, (cudaStream_t)stream)) != cudaSuccess) return (int)err;
  // z: items (array, pm) x nky planes, columns x of stride X, re/im nky * n^2 apart
  const long long nn = (long long)n * n, comp = (long long)nky * nn;
  return ZT_ENTRY(zt_cols_dft)(n, out, out, tw, n, 2LL * narray * nky, nky, nn, 2 * comp,
                               comp, stream);
}

#ifndef ZT_F64
extern "C" const char* zt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
#endif
