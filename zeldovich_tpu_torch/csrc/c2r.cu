// B2: half-spectrum complex-to-real inverse DFT along y, for one H100
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   zeldovich_tpu/ops/pallas_fft.py::c2r_y_folded_pallas
// (bodies _c2r_kernel, _c2r_math).  Contract: in g (narray, 2, 2, ky, Bz, X)
// of F (float here; double through c2r_f64.cu, zt_b2_c2r_y_f64) =
// (array, +/- packing, re/im, ky, z, x), z and x already transformed, a
// full grid (Bz = Z) or a z-slab, Bz * X even for float; out
// (narray, 2, n, Bz, X) of F with re = D and im = F of
// the two real fields packed as S+- = D~ +- i F~; unnormalized, sign +1;
// the imaginary parts of the DC and Nyquist rows are dropped.  ky is
// n/2 + 1 (Nyquist row present) or n/2 (Nyquist-free producer); n is
// given by the caller, never inferred from ky's parity.  With ky = n/2,
// out may be g itself (in place): for one (z, x) column the input's four
// components x n/2 rows occupy exactly the addresses of the output's two
// components x n rows.
//
// What bounds it.  It reads 4 and writes 2 elements per (ky, z, x) and per
// (y, z, x) of each array and does ~5 log2(n) flops per output: bound by
// device-memory traffic (float: 1.28 ms at 512^3 and 3.35 TB/s; double
// twice the bytes).
//
// Design.  D and F are both real, so one complex sequence carries both:
//   Z(k) = S+(k)           for 0 < k < n/2,
//   Z(n - k) = conj(S-(k)) for 0 < k < n/2,
//   Z(0) = Re D~(0) + i Re F~(0), Z(n/2) likewise (zero if absent),
// and its unnormalized inverse DFT is D + iF exactly (for any S+-, since
// S+ e + conj(S- e) = 2 Re(D~ e) + i 2 Re(F~ e)).  That is y_dft's column
// pass (fft_pass.cuh: the same tiles of 32/16/8 columns, double 16/8/4,
// register-resident Stockham passes, stores to the re and im planes) with
// its own loader,
// C2rLoad, forming Z(k) from the rows of g: every read is one row of TX
// consecutive x, the same 128-byte runs as y_dft.  A block loads all of
// its columns before its first exchange barrier and no other block
// touches them, so in place is safe.  A real-input FFT of half length
// would halve the flops; the bytes are the bound, so it waits.

#include "fft_pass.cuh"

namespace {

// The column loader of Z (fft_pass.cuh's PlainLoad interface): element
// k = t + r T of a (z, x) column from the packed rows of g; inner =
// Bz * X, the kernel's column count, strides g's rows too.  r < E/2 is
// k < n/2 (S+), r >= E/2 is k >= n/2 (conj S-), both known at compile
// time; thread t = 0's k = 0 and k = n/2 read a second pair of rows.
// Every element's loads are issued before any arithmetic on a loaded
// value: an operation on one inside the lane's branch on the ragged edge
// waited for it there (2.15 ms instead of 1.72 at 512^3).  An absent
// Nyquist row (rows = n/2) reads nothing and is zero.
struct C2rLoad {
  int rows;  // ky of g (narray, 2, 2, ky, Bz, X): n/2 + 1 or n/2
  template <typename F, int N, int C>
  __device__ __forceinline__ void load(const F* g, bool live, long long a, long long col,
                                       size_t, long long inner, long long, int t,
                                       vec2<F>* v) const {
    constexpr int E = reg::elems(N), T = N / E, H = N / 2;
    const long long comp = rows * inner;  // one (pm, re/im) component
    const F* spr = g + (size_t)(4 * a) * comp + col;
    const F* spi = spr + comp;
    const F* smr = spr + 2 * comp;
    const F* smi = spr + 3 * comp;
    // the loads, straight into v: S+ (re, im) of row k for k < n/2, S-
    // (re, im) of row n - k for k >= n/2 (none at an absent Nyquist row)
#pragma unroll
    for (int r = 0; r < E; ++r) {
      vec2<F> re = make2<F>(F(0), F(0)), im = re;
      const size_t o = (size_t)(r < E / 2 ? t + r * T : N - t - r * T) * inner;
      const F* pre = r < E / 2 ? spr : smr;
      const F* pim = r < E / 2 ? spi : smi;
      if (live && (r != E / 2 || t != 0 || rows > H)) {
        re = load_c<F, C>(pre + o);
        im = load_c<F, C>(pim + o);
      }
      v[r] = make2<F>(re.x, im.x);
      if constexpr (C == 2) v[E + r] = make2<F>(re.y, im.y);
    }
    // then the arithmetic: conj S- for k > n/2
#pragma unroll
    for (int r = E / 2; r < E; ++r) {
      v[r].y = -v[r].y;
      if constexpr (C == 2) v[E + r].y = -v[E + r].y;
    }
    // and thread 0's k = 0 and k = n/2, one after the other (both pairs of
    // extra rows at once spill at n = 512):
    // (Re D~, Re F~) = ((S+re + S-re) / 2, (S+im - S-im) / 2)
    if (live && t == 0) {
      const vec2<F> mr = load_c<F, C>(smr), mi = load_c<F, C>(smi);  // S- row 0
      v[0] = make2<F>(F(0.5) * (v[0].x + mr.x), F(0.5) * (v[0].y - mi.x));
      if constexpr (C == 2)
        v[E] = make2<F>(F(0.5) * (v[E].x + mr.y), F(0.5) * (v[E].y - mi.y));
    }
    if (live && t == 0 && rows > H) {  // v[E/2] holds conj S-(n/2)
      const size_t o = (size_t)H * inner;
      const vec2<F> pr = load_c<F, C>(spr + o), pi = load_c<F, C>(spi + o);  // S+ row n/2
      v[E / 2] = make2<F>(F(0.5) * (pr.x + v[E / 2].x), F(0.5) * (pi.x + v[E / 2].y));
      if constexpr (C == 2)
        v[E + E / 2] = make2<F>(F(0.5) * (pr.y + v[E + E / 2].x),
                                F(0.5) * (pi.y + v[E + E / 2].y));
    }
  }
};

}  // namespace

extern "C" int ZT_ENTRY(zt_b2_c2r_y)(const void* g, const void* tw, void* out, int n, long long nn,
                           int narray, int has_nyq, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // items: the arrays; columns (z, x) of stride Bz * X; re/im n Bz X apart
  return (int)cols<zt::real>(n, C2rLoad{n / 2 + (has_nyq ? 1 : 0)}, (const zt::real*)g,
                             (zt::real*)out, (const zt::real2*)tw, nn, narray, 1, 0,
                             2 * n * nn, n * nn, (cudaStream_t)stream);
}
