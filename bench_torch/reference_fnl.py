"""Plain PyTorch reference of the Zel'dovich / PLT initial conditions with
local primordial non-Gaussianity (f_NL), the full-grid route.

What ``correct`` is held against in a configuration that names it
(``"reference": "reference_fnl"``).  It imports nothing of the program,
no JAX and nothing of the JAX package; from the sibling ``reference``
module it takes the P(k) spline (``Spectrum``), the pcg64 draws
(``Draws``), the eigenmode table read and its vectors (``load_eigmodes``,
``plt_vectors``).  It computes the x-space fields from zeldovich-PLT's
definition, step by step (the C++ lines as SURVEY.md section 3.4 and
layer 9 record them):

1. P(k) as ``reference.py``: the spline of log P(log k), normalised to
   sigma(R) and divided by the box volume (power_spectrum.cpp:130-223).
2. The primordial power ``P_prim(k) = A k^n_s``, A set so that P_prim
   equals P at the table's smallest k > 0 (power_spectrum.cpp:263-266),
   and ``T(k) = sqrt(P / P_prim)``, 1 at k = 0 (power_spectrum.cpp:268-274).
3. ``M(k, a) = 2 D(a) c^2 T(k) k^2 / (3 Omega_M H0^2)``, D = a = 1/(1+z)
   (EdS), c = 299792.458 km/s, H0 = 100 km/s/(Mpc/h); arXiv:1108.5512
   eq. 50 (zeldovich.cpp:377-383).
4. D(k) on the generated half space ky in [0, ppd/2) from the same draws
   and zero rules as ``reference.py`` (power_spectrum.cpp:338-359,
   zeldovich.cpp:349-358), and ``phi(k) = D / M``, 0 at the origin
   (zeldovich.cpp:385-391).
5. The full grid by its reflection (zeldovich.cpp:460-469, 485-503,
   644-650): plane ky takes the generated value S+, plane ppd - ky the
   conjugate of S- at (-kz, -kx); on the ky = 0 plane the mirror half
   (kz < 0, or kz = 0 and kx < 0) takes that conjugate too and the
   origin is 0; the ky = ppd/2 plane is 0.  For phi, S+ = S- = phi.
6. The unnormalised inverse DFT of phi, then
   ``phi_NL = (Re phi + f_NL (Re phi)^2) / ppd^3`` (the round trip's
   1/ppd^3 folded in), then the forward DFT (zeldovich.cpp:699-790,
   :749-759).
7. ``D = phi_NL M`` on the generated half space, zeroed at the origin
   alone: the mode coupling fills the Nyquist planes and the modes past
   the sphere, and they are kept (zeldovich.cpp:393-400).
8. The fields ``F_j = i c_j D``: ``c_j = k_j fund / k^2`` or, with PLT, the
   eigenmode vector's ``e_j k^2 / (k . e)`` times ``fund / k^2``, and the
   velocity ``f F_j``, ``f = (sqrt(1 + 24 lambda f_cluster) - 1) / 4``
   (zeldovich.cpp:404-451), as ``reference.py``.  A wavenumber index i
   stands for ``i - ppd`` above ppd/2, so the Nyquist index ppd/2 is +ppd/2.
9. Two real fields packed into one complex array, ``S+ = P + i Q`` and
   ``S- = P - i Q``: (density, disp_x), (disp_y, disp_z) and with PLT
   (0, vel_x), (vel_y, vel_z) (zeldovich.cpp:440-466); each array's full
   grid as in step 5, and its unnormalised inverse DFT, whose real and
   imaginary parts are the two fields (zeldovich.cpp:653-682).

Departures from the C++: the transforms are ``torch.fft``'s, not FFTW's,
and the non-linear map takes the real part of phi(x), whose imaginary
part is rounding (phi's grid is Hermitian).  The fields are read from the
packed arrays as the C++ writes them: under f_NL the grid is not
Hermitian on the Nyquist modes (an i k_j at index +ppd/2 on both sides
of the reflection), so a field's own inverse DFT would not give the
C++'s value there.  The real part of the (0, vel_x) array is not a
field; it is not yielded.  Refused (NotImplementedError): CornerModes,
ZD_Version 1, k_cutoff != 1, PLT rescaling, one-mode and density-only
runs.

Under f_NL the Nyquist planes carry power, and an eigenmode table
interpolated at a ppd that does not divide its size (``plt_vectors``) has
vectors there nearly orthogonal to k, so ``e k^2 / (k . e)`` reaches
~1e16 |k| on a few dozen modes: at 512^3 on the 128^3 table a few
particles' displacements reach ~6e7.  That is the definition with that
table, and it is kept.

``fields(par, root, dtype, device)`` yields what ``reference.fields``
yields: ``(name, (Y, Z, X) tensor)`` in ``reference.FIELDS`` order, the
velocities with PLT only.  The check runs it in float64;
``dtype=torch.float32`` computes every float in float32.  On the card
at 512^3 float64 it holds the half-space D and two full complex grids at
a time.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import reference as base  # noqa: E402

SUPPORTED = dict(ZD_Version=2, ZD_k_cutoff=1, ZD_CornerModes=0, ZD_qonemode=0,
                 ZD_qdensity=0, ZD_qPLT_rescale=0)
FIELDS = base.FIELDS
#: km/s, and km/s/(Mpc/h)
C_KMS, H0 = 299792.458, 100.0


def kmin(path, scale: float) -> float:
    """The table's smallest k > 0, times ``Pk_scale``."""
    ks = []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if line.startswith("#") or len(parts) < 2:
            continue
        k = float(parts[0]) * scale
        if k > 0.0:
            ks.append(k)
    return min(ks)


def m_of_n2(spec, n2s, fund: float, par, k_min: float, n_s: float) -> torch.Tensor:
    """M(k, a) at k^2 = n2 fund^2 (steps 2-3), float64."""
    k = torch.sqrt(n2s) * fund
    P = spec.power_of(k)
    amp = spec.power(k_min) / math.exp(math.log(k_min) * n_s)
    prim = amp * torch.exp(torch.log(torch.where(k > 0, k, 1.0)) * n_s)
    T = torch.where(k > 0, torch.sqrt(P / prim), 1.0)
    a = 1.0 / (1.0 + base._num(par, "InitialRedshift"))
    omega_m = base._num(par, "Omega_M", 1.0)
    return 2.0 * a * C_KMS * C_KMS * T * (n2s * fund * fund) / (3.0 * omega_m * H0 * H0)


class Grid:
    """The index arithmetic of a ppd^3 grid [y, z, x] on ``device``."""

    def __init__(self, ppd: int, device):
        self.ppd, self.half, self.device = ppd, ppd // 2, device
        i = torch.arange(ppd, device=device)
        self.k = torch.where(i > self.half, i - ppd, i)  # index -> wavenumber
        self.refl = (ppd - i) % ppd
        z, x = i[:, None], i[None, :]
        self.mirror0 = (z > self.half) | ((z == 0) & (x > self.half))

    def planes(self, cy: int):
        """Each chunk of generated planes: (y0, y1, ky, kz, kx, n2)."""
        kz, kx = self.k[None, :, None], self.k[None, None, :]
        for y0 in range(0, self.half, cy):
            y1 = min(self.half, y0 + cy)
            ky = torch.arange(y0, y1, device=self.device)[:, None, None]
            yield y0, y1, ky, kz, kx, kx * kx + ky * ky + kz * kz

    def full(self, sp, sm):
        """The (ppd, ppd, ppd) grid of the generated half spaces S+ and S-
        (each (ppd/2, ppd, ppd) complex): step 5."""
        n, h, r = self.ppd, self.half, self.refl
        g = torch.zeros((n, n, n), dtype=sp.dtype, device=sp.device)
        g[:h] = sp
        g[h + 1:] = sm[1:].flip(0)[:, r[:, None], r[None, :]].conj()
        g[0] = torch.where(self.mirror0, sm[0][r[:, None], r[None, :]].conj(), sp[0])
        g[0, 0, 0] = 0
        return g


def fields(par: dict, root, dtype=torch.float64, device="cuda", chunk_modes=1 << 22):
    """The configuration's x-space fields one at a time, ``(name, (Y, Z, X)
    tensor of dtype on device)`` in FIELDS order (the velocities with PLT
    only); ``par`` holds the .par keys, relative file names resolved
    against ``root``.  A field's tensor is dropped when the next is asked
    for, so the caller should drop it too."""
    for k, v in SUPPORTED.items():
        if base._num(par, k, v) != v:
            raise NotImplementedError(f"the f_NL reference computes {k} = {v} only")
    ppd = round(base._num(par, "NP") ** (1 / 3))
    if ppd ** 3 != int(base._num(par, "NP")) or ppd % 2:
        raise ValueError("NP must be the cube of an even ppd")
    half, box = ppd // 2, base._num(par, "BoxSize")
    fund = 2.0 * math.pi / box
    nyq = math.pi * ppd / box
    pk_path, scale = base._path(par, "ZD_Pk_filename", root), base._num(par, "ZD_Pk_scale", 1.0)
    spec = base.Spectrum(pk_path, box, base._num(par, "ZD_Pk_norm"),
                         base._num(par, "ZD_Pk_sigma"), base._num(par, "ZD_Pk_smooth"), scale)
    f_nl = base._num(par, "ZD_f_NL")
    fixed = bool(base._num(par, "ZD_qPk_fix_to_mean"))
    plt = bool(base._num(par, "ZD_qPLT"))
    f_cluster = base._num(par, "ZD_f_cluster", 1.0)
    table = None
    if plt:
        table = torch.from_numpy(
            base.load_eigmodes(base._path(par, "ZD_PLT_filename", root)).copy()).to(device)
    npf = np.float32 if dtype == torch.float32 else np.float64
    fund_d, fund2 = float(npf(fund)), float(npf(fund) ** 2)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128

    # P and M by the integer n2 = |k|^2 / fund^2, and the sphere
    n2s = torch.arange(3 * half * half + 1, dtype=torch.float64, device=device)
    pk_n2 = spec.power_of(torch.sqrt(n2s) * fund)
    M_n2 = m_of_n2(spec, n2s, fund, par, kmin(pk_path, scale), base._num(par, "ZD_n_s", 1.0))
    outside = n2s * (fund * fund) >= nyq * nyq
    draws = base.Draws(int(base._num(par, "ZD_Seed")), ppd, device)
    grid = Grid(ppd, device)
    cy = max(1, min(half, chunk_modes // (ppd * ppd)))

    # step 4: phi(k) = D / M on the generated half space
    phi = torch.empty((half, ppd, ppd), dtype=cdt, device=device)
    for y0, y1, ky, kz, kx, n2 in grid.planes(cy):
        zero = (kx.abs() == half) | (ky.abs() == half) | (kz.abs() == half) | outside[n2]
        pk = torch.where(zero, 0.0, pk_n2[n2]).to(dtype)
        R, T = draws.uniforms(y0, y1, dtype)
        amp = torch.sqrt(pk) if fixed else torch.sqrt(-pk * torch.log(R))
        theta = (2 * math.pi) * T
        M = M_n2[n2].to(dtype)
        inv_m = torch.where(n2 == 0, 0.0, 1.0 / torch.where(n2 == 0, 1.0, M))
        phi[y0:y1] = torch.complex(amp * torch.cos(theta) * inv_m,
                                   amp * torch.sin(theta) * inv_m)
    # steps 5-6: the round trip, and phi_NL(k) on ky in [0, ppd/2]
    x = torch.fft.ifftn(grid.full(phi, phi), dim=(0, 1, 2), norm="forward").real
    del phi
    x = (x + f_nl * x * x) / float(ppd) ** 3
    phi_nl = torch.fft.rfftn(x, dim=(1, 2, 0), norm="backward")  # [ky, z, x], ky halved
    del x

    # step 7: D = phi_NL M, zeroed at the origin alone
    D = torch.empty((half, ppd, ppd), dtype=cdt, device=device)
    for y0, y1, ky, kz, kx, n2 in grid.planes(cy):
        D[y0:y1] = phi_nl[y0:y1].to(cdt) * M_n2[n2].to(dtype)
    D[0, 0, 0] = 0
    del phi_nl

    def coefs(ky, kz, kx, n2):
        """(c_x, c_y, c_z, f) of a chunk (f None without PLT): step 8."""
        k2 = n2.to(dtype) * fund2
        ik2 = torch.where(n2 == 0, 0.0, 1.0 / torch.where(n2 == 0, 1.0, k2))
        if not plt:
            return (*(k.to(dtype) * (fund_d * ik2) for k in (kx, ky, kz)), None)
        vec, lam = base.plt_vectors(kx, ky, kz, ppd, table, dtype)
        f = (torch.sqrt(1.0 + 24.0 * lam * float(npf(f_cluster))) - 1.0) * 0.25
        return (*(v * (fund_d * ik2) for v in vec), f)

    def packed(parts):
        """The x-space transform of the array P + i Q, where ``parts(D, c)``
        gives (P, Q) of a chunk, each complex or None: step 9."""
        sp = torch.empty((half, ppd, ppd), dtype=cdt, device=device)
        sm = torch.empty_like(sp)
        for y0, y1, ky, kz, kx, n2 in grid.planes(cy):
            P, Q = parts(D[y0:y1], coefs(ky, kz, kx, n2))
            P = torch.zeros_like(Q) if P is None else P
            sp[y0:y1], sm[y0:y1] = P + 1j * Q, P - 1j * Q
        g = grid.full(sp, sm)
        del sp, sm
        return torch.fft.ifftn(g, dim=(0, 1, 2), norm="forward")

    def field(d, c, j):
        return 1j * c[j] * d

    def vel(d, c, j):
        return c[3] * field(d, c, j)

    arrays = [(("density", "disp_x"), lambda d, c: (d, field(d, c, 0))),
              (("disp_y", "disp_z"), lambda d, c: (field(d, c, 1), field(d, c, 2)))]
    if plt:
        arrays += [((None, "vel_x"), lambda d, c: (None, vel(d, c, 0))),
                   (("vel_y", "vel_z"), lambda d, c: (vel(d, c, 1), vel(d, c, 2)))]
    for names, parts in arrays:
        out = packed(parts)
        for name, part in zip(names, (out.real, out.imag)):
            if name is not None:
                yield name, part.contiguous()
        del out
