// Native particle serialization + IO for zeldovich-tpu.
//
// The device hands back inverse-FFT'd complex slabs; turning them into
// Abacus's packed particle records (and streaming them to disk) is the
// host-side hot path at scale (a 4096^3 RVZel run serializes 2 TB of
// records).  This module does the decode+pack in one multithreaded pass
// with fused statistics, replacing several numpy temporaries per slab,
// and offers an O_DIRECT file append for the AllowDirectIO option.
//
// Record layouts match include/output.h:19-42 of the reference (verified
// against a compiled struct oracle): RVZel 32 B (u16 i,j,k @0/2/4, f32
// displ[3] @8, f32 vel[3] @20), RVdoubleZel 56 B (@8/@32 doubles),
// Zeldovich 32 B, ZelSimple 12 B.  Decode per output.cpp:86-206:
// pos = (Im A, Re B, Im B), vel from the PLT arrays or vnorm*pos, fields
// stored in (z,y,x) component order, (i,j,k) = (z,y,x) lattice coords.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

enum Format { RVZEL = 0, RVDOUBLEZEL = 1, ZEL = 2, ZELSIMPLE = 3 };

struct Stats {
    double sumsq = 0.0;
    double max_disp[3] = {0.0, 0.0, 0.0};
    void absorb(const Stats &o) {
        sumsq += o.sumsq;
        for (int j = 0; j < 3; j++)
            if (std::fabs(o.max_disp[j]) > std::fabs(max_disp[j]))
                max_disp[j] = o.max_disp[j];
    }
};

// complex arrays are interleaved (re, im) doubles, row-major [y][x]
inline double re(const double *a, long i) { return a[2 * i]; }
inline double im(const double *a, long i) { return a[2 * i + 1]; }

template <typename FD, typename FV, bool KEEP_IJK>
inline void pack_rows(
    int z, long ppd, long y0, long y1, const double *A, const double *B,
    const double *V1, const double *V2, int qplt, double vnorm, char *out,
    long itemsize, long off_displ, long off_vel, bool has_vel, Stats *st
) {
    for (long y = y0; y < y1; y++) {
        for (long x = 0; x < ppd; x++) {
            const long i = y * ppd + x;
            char *rec = out + i * itemsize;
            const double dens = re(A, i);
            st->sumsq += dens * dens;
            double pos[3] = {im(A, i), re(B, i), im(B, i)};
            double vel[3];
            if (qplt) {
                vel[0] = im(V1, i);
                vel[1] = re(V2, i);
                vel[2] = im(V2, i);
            } else {
                vel[0] = pos[0] * vnorm;
                vel[1] = pos[1] * vnorm;
                vel[2] = pos[2] * vnorm;
            }
            for (int j = 0; j < 3; j++)
                if (std::fabs(pos[j]) > std::fabs(st->max_disp[j]))
                    st->max_disp[j] = pos[j];
            if (KEEP_IJK) {
                uint16_t ijk[3] = {(uint16_t) z, (uint16_t) y, (uint16_t) x};
                std::memcpy(rec, ijk, 6);
            }
            // (z, y, x) component order
            FD d = {(typename FD::value_type) pos[2],
                    (typename FD::value_type) pos[1],
                    (typename FD::value_type) pos[0]};
            std::memcpy(rec + off_displ, &d, sizeof(d));
            if (has_vel) {
                FV v = {(typename FV::value_type) vel[2],
                        (typename FV::value_type) vel[1],
                        (typename FV::value_type) vel[0]};
                std::memcpy(rec + off_vel, &v, sizeof(v));
            }
        }
    }
}

template <typename T>
struct Triple {
    using value_type = T;
    T a, b, c;
};

}  // namespace

extern "C" {

// Decode one z-slab into packed records. A,B,V1,V2: interleaved complex
// doubles [ppd][ppd] (V1/V2 may be null when !qplt).  out must hold
// ppd*ppd*itemsize bytes.  stats[4] (in/out): {sumsq, max_x, max_y, max_z}
// accumulated with the signed-max rule.  Returns the record size in bytes,
// or -1 on bad format.
long zt_pack_slab(
    int format, int z, long ppd, const double *A, const double *B,
    const double *V1, const double *V2, int qplt, double vnorm, char *out,
    double *stats, int nthreads
) {
    long itemsize, off_displ = 8, off_vel = 0;
    switch (format) {
        case RVZEL: itemsize = 32; off_vel = 20; break;
        case RVDOUBLEZEL: itemsize = 56; off_vel = 32; break;
        case ZEL: itemsize = 32; break;
        case ZELSIMPLE: itemsize = 12; off_displ = 0; break;
        default: return -1;
    }
    if (nthreads < 1) nthreads = 1;
    if (nthreads > ppd) nthreads = (int) ppd;

    std::vector<Stats> st((size_t) nthreads);
    std::vector<std::thread> threads;
    const long rows = (ppd + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        const long y0 = t * rows;
        const long y1 = std::min<long>(ppd, y0 + rows);
        if (y0 >= y1) break;
        threads.emplace_back([=, &st]() {
            Stats *s = &st[t];
            switch (format) {
                case RVZEL:
                    pack_rows<Triple<float>, Triple<float>, true>(
                        z, ppd, y0, y1, A, B, V1, V2, qplt, vnorm, out,
                        itemsize, off_displ, off_vel, true, s);
                    break;
                case RVDOUBLEZEL:
                    pack_rows<Triple<double>, Triple<double>, true>(
                        z, ppd, y0, y1, A, B, V1, V2, qplt, vnorm, out,
                        itemsize, off_displ, off_vel, true, s);
                    break;
                case ZEL:
                    pack_rows<Triple<double>, Triple<double>, true>(
                        z, ppd, y0, y1, A, B, V1, V2, qplt, vnorm, out,
                        itemsize, off_displ, off_vel, false, s);
                    break;
                case ZELSIMPLE:
                    pack_rows<Triple<float>, Triple<float>, false>(
                        z, ppd, y0, y1, A, B, V1, V2, qplt, vnorm, out,
                        itemsize, off_displ, off_vel, false, s);
                    break;
            }
        });
    }
    for (auto &th : threads) th.join();
    Stats total;
    for (auto &s : st) total.absorb(s);
    stats[0] += total.sumsq;
    for (int j = 0; j < 3; j++)
        if (std::fabs(total.max_disp[j]) > std::fabs(stats[1 + j]))
            stats[1 + j] = total.max_disp[j];
    return itemsize;
}

// Zero the padding bytes of a fresh record buffer (the C++ structs carry
// 2 padding bytes after the u16 triple for RVZel/Zel/RVdoubleZel).
void zt_zero_buffer(char *out, long nbytes) { std::memset(out, 0, nbytes); }

// Append a buffer to a file (optionally O_DIRECT for AllowDirectIO).
// Returns bytes written or -errno.
long zt_append(const char *path, const char *buf, long nbytes, int direct) {
    int flags = O_WRONLY | O_CREAT | O_APPEND;
#ifdef O_DIRECT
    // O_DIRECT demands sector-aligned buffer/length; only attempt it when
    // the request qualifies, else silently use the page cache (the
    // reference's DIRECTIO path is likewise best-effort and was disabled,
    // block_array.h:73-81)
    if (direct && nbytes % 4096 == 0 && ((uintptr_t) buf % 4096) == 0)
        flags |= O_DIRECT;
#endif
    int fd = open(path, flags, 0644);
    if (fd < 0 && direct) {
        flags &= ~O_DIRECT;
        fd = open(path, flags, 0644);
    }
    if (fd < 0) return -1;
    long done = 0;
    while (done < nbytes) {
        ssize_t w = write(fd, buf + done, (size_t) (nbytes - done));
        if (w < 0) {
#ifdef O_DIRECT
            if (flags & O_DIRECT) {  // e.g. fs without O_DIRECT support
                close(fd);
                flags &= ~O_DIRECT;
                fd = open(path, flags, 0644);
                if (fd < 0) return -1;
                continue;
            }
#endif
            close(fd);
            return -1;
        }
        done += w;
    }
    close(fd);
    return done;
}
}
