"""Plain PyTorch reference of the Zel'dovich / PLT initial conditions.

What ``correct`` is held against.  It imports nothing of the program and
takes nothing the program made: it reads the same data files (the P(k)
table, the PLT eigenmode table) and the configuration's keys, and computes
the x-space fields from the published definition (zeldovich-PLT,
Garrison et al. 2016, and its README's RNG layout):

* P(k): a natural cubic spline of log P(log k), normalised to ``sigma(R)``
  of a top-hat by Romberg integration over k in [0, 10] to 1e-6, divided by
  the box volume (the unnormalised inverse DFT);
* one pcg64 stream (setseq_xsl_rr_128_64, default increment) laid out over
  a virtual 65536^3 cube, two draws a mode: mode (ky, kz, kx) of the
  generated half space ky in [0, ppd/2) starts after
  ``2 (ky 65536^2 + slot(kz) 65536 + slot(kx))`` draws, slot(i) = i up to
  ppd/2 and 65536 - ppd + i above; its draws R, T give
  ``D = sqrt(-P log R) exp(2 pi i T)`` with ``R = (r + 1) 2^-64``;
* modes on a Nyquist index and outside the sphere k^2 >= k_nyquist^2 are
  zero, the ky = 0 plane is made Hermitian from its non-mirror half, the
  origin and the ky = Nyquist plane are zero;
* displacement ``i k_j / k^2 D`` (PLT: the eigenmode vector's
  ``e_j k^2 / (k . e)`` over k^2, eigenmodes trilinearly interpolated in
  index space) and, with PLT, velocity ``f`` times it, per mode
  ``f = (sqrt(1 + 24 lambda f_cluster) - 1) / 4`` (without PLT the
  velocity is that growth rate at lambda = 1 times the displacement);
* each field's unnormalised inverse DFT (``torch.fft.irfftn``).

The 128-bit arithmetic is done on int64 tensors of eight 16-bit digits,
so every partial product and column sum stays far below 2^63.
The check runs it in float64; ``dtype=torch.float32`` computes every
float in float32.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

MAX_PPD = 65536
MASK128 = (1 << 128) - 1
MULT = (2549297995355413924 << 64) | 4865540595714422341
INC = (6364136223846793005 << 64) | 1442695040888963407
DIGITS = 8  # a 128-bit value as eight 16-bit digits, least significant first


# -- the power spectrum ------------------------------------------------------
class Spectrum:
    """P(k) of a two-column (k, P) table, normalised as the configuration
    states (keys ZD_Pk_norm, ZD_Pk_sigma, ZD_Pk_smooth, ZD_Pk_scale)."""

    def __init__(self, path, boxsize, Pk_norm, Pk_sigma, Pk_smooth=0.0, Pk_scale=1.0):
        xs, ys = [], []
        for line in Path(path).read_text().splitlines():
            if line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            k, P = float(parts[0]) * Pk_scale, float(parts[1])
            if k <= 0.0 or P <= 0.0:
                raise ValueError(f"{path}: the reference takes k > 0 and P > 0 only")
            xs.append(math.log(k))
            ys.append(math.log(P))
        order = sorted(range(len(xs)), key=xs.__getitem__)
        self.x = [xs[i] for i in order]
        self.y = [ys[i] for i in order]
        self.y2 = _natural_spline(self.x, self.y)
        self.norm = 1.0
        self.smooth2 = 0.0
        if Pk_norm > 0.0:
            self.norm = (Pk_sigma / self.sigma(Pk_norm)) ** 2
        self.norm /= boxsize ** 3
        self.smooth2 = Pk_smooth ** 2

    def _val(self, v):
        x, y, y2 = self.x, self.y, self.y2
        lo, hi = 0, len(x) - 1
        while hi - lo > 1:
            mid = (hi + lo) >> 1
            if x[mid] > v:
                hi = mid
            else:
                lo = mid
        h = x[hi] - x[lo]
        a = (x[hi] - v) / h
        b = (v - x[lo]) / h
        return a * y[lo] + b * y[hi] + ((a**3 - a) * y2[lo] + (b**3 - b) * y2[hi]) * (h * h) / 6.0

    def power(self, k: float) -> float:
        if k <= 0.0:
            return 0.0
        return math.exp(self._val(math.log(k)) - k * k * self.smooth2) * self.norm

    def power_of(self, k: torch.Tensor) -> torch.Tensor:
        """P at float64 wavenumbers (0 at k = 0)."""
        x = torch.tensor(self.x, dtype=torch.float64, device=k.device)
        y = torch.tensor(self.y, dtype=torch.float64, device=k.device)
        y2 = torch.tensor(self.y2, dtype=torch.float64, device=k.device)
        v = torch.log(torch.where(k > 0, k, 1.0))
        hi = torch.searchsorted(x, v, right=True).clamp(1, len(self.x) - 1)
        lo = hi - 1
        h = x[hi] - x[lo]
        a = (x[hi] - v) / h
        b = (v - x[lo]) / h
        s = a * y[lo] + b * y[hi] + ((a**3 - a) * y2[lo] + (b**3 - b) * y2[hi]) * (h * h) / 6.0
        return torch.where(k > 0, torch.exp(s - k * k * self.smooth2) * self.norm, 0.0)

    def sigma(self, R: float) -> float:
        """sigma(R) of a top-hat: Romberg over [0, 10] to 1e-6."""
        def f(k):
            x = k * R
            w = 1 - x * x / 10.0 if x <= 1e-3 else 3.0 * (math.sin(x) - x * math.cos(x)) / x / x / x
            return 0.5 / math.pi / math.pi * k * k * w * w * self.power(k)

        val, prec = _romberg(f, 0.0, 10.0, 1e-6)
        if abs(prec) > 1e-6:
            raise RuntimeError(f"Romberg reached {prec:g}, not 1e-6")
        return math.sqrt(val)


def _natural_spline(x, y):
    """Second derivatives of the natural cubic spline through (x, y)."""
    n = len(x)
    y2, u = [0.0] * n, [0.0] * n
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        d = (y[i + 1] - y[i]) / (x[i + 1] - x[i]) - (y[i] - y[i - 1]) / (x[i] - x[i - 1])
        u[i] = (6.0 * d / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    for k in range(n - 2, -1, -1):
        y2[k] = y2[k] * y2[k + 1] + u[k]
    return y2


def _romberg(f, a, b, prec, maxiter=32):
    """Romberg's method; returns (value, relative change of the last step)."""
    h = 0.5 * (b - a)
    rows = [[h * (f(a) + f(b))]]
    j = 0
    while True:
        j += 1
        s = sum(f(a + (2 * k - 1) * h) for k in range(1, (1 << (j - 1)) + 1))
        row = [0.5 * rows[-1][0] + h * s]
        four = 1.0
        for k in range(1, j + 1):
            four *= 4
            row.append(row[k - 1] + (row[k - 1] - rows[-1][k - 1]) / (four - 1))
        rows.append(row)
        h *= 0.5
        if j > 1 and abs(row[j] - rows[-2][j - 1]) < prec * abs(row[j]):
            break
        if j >= maxiter:
            break
    return rows[-1][j], (rows[-1][j] - rows[-2][j - 1]) / rows[-1][j]


# -- pcg64 on 16-bit digits ----------------------------------------------------
def _advance(delta: int):
    """(m, c) with advance(s, delta) = m s + c mod 2^128 (Brown 1994)."""
    cm, cp, am, ap = MULT, INC, 1, 0
    while delta > 0:
        if delta & 1:
            am, ap = (am * cm) & MASK128, (ap * cm + cp) & MASK128
        cp, cm = ((cm + 1) * cp) & MASK128, (cm * cm) & MASK128
        delta >>= 1
    return am, ap


def _digits(values, device):
    """128-bit Python ints -> (8, len) int64 tensor of 16-bit digits."""
    a = np.array([[(v >> (16 * d)) & 0xFFFF for d in range(DIGITS)] for v in values],
                 dtype=np.int64).reshape(-1, DIGITS)
    return torch.from_numpy(a.T.copy()).to(device)


def _madd(m, s, c):
    """(m s + c) mod 2^128 of digit tensors (each (8, ...), broadcasting)."""
    cols = [c[k] + 0 for k in range(DIGITS)]
    for i in range(DIGITS):
        for j in range(DIGITS - i):
            cols[i + j] = cols[i + j] + m[i] * s[j]  # < 2^32 a product, < 2^36 a column
    out, carry = [], 0
    for k in range(DIGITS):
        t = cols[k] + carry
        out.append(t & 0xFFFF)
        carry = t >> 16
    return torch.stack(out)


def _output(s):
    """XSL-RR: rotate (hi64 ^ lo64) right by the state's top 6 bits; returns
    the 64-bit draw as (hi32, lo32) int64 tensors."""
    x = [s[k] ^ s[k + 4] for k in range(4)]  # four 16-bit digits of hi ^ lo
    rot = s[7] >> 10
    q, r = rot >> 4, rot & 15
    # digit k of the rotation by 16 q: x[(k + q) % 4]
    xq = [sum(torch.where(q == t, x[(k + t) % 4], 0) for t in range(4)) for k in range(4)]
    y = [((xq[k] >> r) | (xq[(k + 1) % 4] << (16 - r))) & 0xFFFF for k in range(4)]
    return y[3] * 65536 + y[2], y[1] * 65536 + y[0]


def _uniform(s, dtype):
    """(r + 1) 2^-64 of the draw r, correctly rounded in float64."""
    hi, lo = _output(s)
    u = (hi.to(torch.float64) * 2.0**32 + (lo + 1).to(torch.float64)) * 2.0**-64
    return u.to(dtype)


def _slot(i: int, ppd: int) -> int:
    return i if i <= ppd // 2 else MAX_PPD - ppd + i


class Draws:
    """The two uniforms of every mode of planes [y0, y1) of a seed's stream."""

    def __init__(self, seed: int, ppd: int, device):
        self.ppd, self.device = ppd, device
        s0 = (((seed + INC) & MASK128) * MULT + INC) & MASK128  # pcg64(seed)
        mp, cp = _advance(2 * MAX_PPD * MAX_PPD)
        planes = [s0]
        for _ in range(ppd // 2 - 1):
            planes.append((mp * planes[-1] + cp) & MASK128)
        zs = [_advance(2 * MAX_PPD * _slot(z, ppd)) for z in range(ppd)]
        # row states: plane y advanced to z's first mode
        self.rows = [[(m * p + c) & MASK128 for m, c in zs] for p in planes]
        # x's advance, then the step pcg64 takes before its first output
        xs = [_advance(2 * _slot(x, ppd)) for x in range(ppd)]
        self.mx = _digits([(MULT * m) & MASK128 for m, _ in xs], device)
        self.cx = _digits([(MULT * c + INC) & MASK128 for _, c in xs], device)
        self.step = (_digits([MULT], device), _digits([INC], device))

    def uniforms(self, y0: int, y1: int, dtype):
        """(R, T), each (y1 - y0, ppd, ppd) [y, z, x]."""
        rows = _digits([v for r in self.rows[y0:y1] for v in r], self.device)
        rows = rows.view(DIGITS, y1 - y0, self.ppd, 1)
        s1 = _madd(self.mx[:, None, None, :], rows, self.cx[:, None, None, :])
        s2 = _madd(self.step[0][:, :, None, None], s1, self.step[1][:, :, None, None])
        return _uniform(s1, dtype), _uniform(s2, dtype)


# -- PLT eigenmodes ------------------------------------------------------------
def load_eigmodes(path):
    raw = Path(path).read_bytes()
    n = int(np.frombuffer(raw[:4], "<i4")[0])
    return np.frombuffer(raw[4:], "<f8").reshape(n, n, n // 2 + 1, 4)


def _interp(ikx, iky, ikz, ppd, table, dt):
    """The table's (e_x, e_y, e_z, lambda) at index-space wavevectors:
    trilinear in k-index space, not across the +/- Nyquist jump."""
    n = table.shape[0]
    if n % ppd == 0:
        st = n // ppd
        return table[ikx * st, iky * st, ikz * st].to(dt)
    top, half = n // 2 + 1, n // 2
    scale = float((np.float32 if dt == torch.float32 else np.float64)(n)
                  / (np.float32 if dt == torch.float32 else np.float64)(ppd))
    f = [scale * i.to(dt) for i in (ikx, iky, ikz)]
    f = [torch.where((v > half) & (v < top), torch.floor(v + 1), v) for v in f]
    lo = [v.to(torch.int64) for v in f]
    hi = [torch.where(v + 1 == n, 0, v + 1) for v in lo]
    hi[2] = torch.clamp(hi[2], max=top - 1)
    fx, fy, fz = (v - l for v, l in zip(f, lo))
    t = table.to(dt)
    (xl, yl, zl), (xh, yh, zh) = lo, hi
    w = lambda a: a[..., None]
    return (w((1 - fx) * (1 - fy) * (1 - fz)) * t[xl, yl, zl]
            + w((1 - fx) * (1 - fy) * fz) * t[xl, yl, zh]
            + w((1 - fx) * fy * (1 - fz)) * t[xl, yh, zl]
            + w((1 - fx) * fy * fz) * t[xl, yh, zh]
            + w(fx * (1 - fy) * (1 - fz)) * t[xh, yl, zl]
            + w(fx * (1 - fy) * fz) * t[xh, yl, zh]
            + w(fx * fy * (1 - fz)) * t[xh, yh, zl]
            + w(fx * fy * fz) * t[xh, yh, zh])


def plt_vectors(kx, ky, kz, ppd, table, dt):
    """PLT displacement vectors e k^2 / (k . e) (index units) and lambda."""
    kx, ky, kz = torch.broadcast_tensors(kx, ky, kz)
    ix, iy, iz = (torch.where(k < 0, ppd + k, k) for k in (kx, ky, kz))
    iz = torch.where(iz > ppd // 2, ppd - iz, iz)
    e = _interp(ix, iy, iz, ppd, table, dt)
    ex, ey, ez, lam = e[..., 0], e[..., 1], e[..., 2], e[..., 3]
    ez = ez * torch.where(kz < 0, -1.0, 1.0).to(dt)
    mag = torch.sqrt(ex * ex + ey * ey + ez * ez)
    mag = torch.where(mag == 0, 1.0, mag)
    ex, ey, ez = ex / mag, ey / mag, ez / mag
    k2 = (kx * kx + ky * ky + kz * kz).to(dt)
    dot = kx.to(dt) * ex + ky.to(dt) * ey + kz.to(dt) * ez
    norm = k2 / torch.where(dot == 0, 1.0, dot)
    norm = torch.where((k2 == 0) | (dot == 0) | ~torch.isfinite(norm), 0.0, norm)
    return (norm * ex, norm * ey, norm * ez), lam


# -- the fields ----------------------------------------------------------------
SUPPORTED = dict(ZD_Version=2, ZD_f_NL=0, ZD_k_cutoff=1, ZD_CornerModes=0,
                 ZD_qonemode=0, ZD_qdensity=0, ZD_qPLT_rescale=0)

#: what each x-space field is: (name, source): the density, the three
#: displacements and the three velocities
FIELDS = ("density", "disp_x", "disp_y", "disp_z", "vel_x", "vel_y", "vel_z")


def _num(par, key, default=0.0):
    v = par.get(key, default)
    return float(v.strip('"')) if isinstance(v, str) else float(v)


def _path(par, key, root):
    p = Path(str(par[key]).strip('"'))
    return p if p.is_absolute() else Path(root) / p


def fields(par: dict, root, dtype=torch.float64, device="cuda", chunk_modes=1 << 22):
    """The configuration's x-space fields one at a time, ``(name, (Y, Z, X)
    tensor of dtype on device)`` in FIELDS order (the velocities with PLT
    only: without, each is one growth rate times its displacement).
    ``par`` holds the .par keys; relative file names resolve against
    ``root``.

    One spectrum is on the device at a time: D, the density's, is kept on
    the host (pinned beside a card) as it is made, and every other field is
    its coefficient times i D, read back a chunk at a time.  A field's
    tensor is dropped when the next is asked for, so the caller should
    drop it too."""
    for k, v in SUPPORTED.items():
        if _num(par, k, v) != v:
            raise NotImplementedError(f"the reference computes {k} = {v} only")
    ppd = round(_num(par, "NP") ** (1 / 3))
    if ppd ** 3 != int(_num(par, "NP")) or ppd % 2:
        raise ValueError("NP must be the cube of an even ppd")
    half, box = ppd // 2, _num(par, "BoxSize")
    fund = 2.0 * math.pi / box
    nyq = math.pi * ppd / box
    spec = Spectrum(_path(par, "ZD_Pk_filename", root), box, _num(par, "ZD_Pk_norm"),
                    _num(par, "ZD_Pk_sigma"), _num(par, "ZD_Pk_smooth"),
                    _num(par, "ZD_Pk_scale", 1.0))
    fixed = bool(_num(par, "ZD_qPk_fix_to_mean"))
    plt = bool(_num(par, "ZD_qPLT"))
    f_cluster = _num(par, "ZD_f_cluster", 1.0)
    table = None
    if plt:
        table = torch.from_numpy(load_eigmodes(_path(par, "ZD_PLT_filename", root)).copy()).to(device)
    npf = np.float32 if dtype == torch.float32 else np.float64
    fund_d = float(npf(fund))
    fund2 = float(npf(fund) ** 2)
    # P by the integer n2 = |k|^2 / fund^2 of every mode, and the sphere
    n2s = torch.arange(3 * half * half + 1, dtype=torch.float64, device=device)
    pk_n2 = spec.power_of(torch.sqrt(n2s) * fund)
    outside = n2s * (fund * fund) >= nyq * nyq
    draws = Draws(int(_num(par, "ZD_Seed")), ppd, device)

    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    names = FIELDS if plt else FIELDS[:4]
    z = torch.arange(ppd, device=device)
    kz = torch.where(z > half, z - ppd, z)[None, :, None]
    kx = torch.where(z > half, z - ppd, z)[None, None, :]
    cy = max(1, min(half, chunk_modes // (ppd * ppd)))
    mirror = (z[:, None] > half) | ((z[:, None] == 0) & (z[None, :] > half))
    refl = (ppd - z) % ppd

    def planes():
        """Each chunk of ky planes: (y0, y1, ky, n2)."""
        for y0 in range(0, half, cy):
            y1 = min(half, y0 + cy)
            ky = torch.arange(y0, y1, device=device)[:, None, None]
            yield y0, y1, ky, kx * kx + ky * ky + kz * kz

    def xspace(s):
        """The field of spectrum ``s`` ([z, x, ky]; irfftn halves the last
        axis) after the Hermitian fixup of its ky = 0 plane, [y, z, x]."""
        p0 = s[:, :, 0]
        s[:, :, 0] = torch.where(mirror, p0[refl[:, None], refl[None, :]].conj(), p0)
        s[0, 0, 0] = 0
        x = torch.fft.irfftn(s, s=(ppd, ppd, ppd), dim=(0, 1, 2), norm="forward")
        return x.permute(2, 0, 1).contiguous()  # [z, x, y] -> [y, z, x]

    keep = torch.empty((half, ppd, ppd), dtype=cdt,
                       pin_memory=torch.device(device).type == "cuda")  # D, [ky, z, x]
    s = torch.zeros((ppd, ppd, half + 1), dtype=cdt, device=device)
    for y0, y1, ky, n2 in planes():
        zero = (kx.abs() == half) | (ky.abs() == half) | (kz.abs() == half) | outside[n2]
        pk = torch.where(zero, 0.0, pk_n2[n2]).to(dtype)
        R, T = draws.uniforms(y0, y1, dtype)
        amp = torch.sqrt(pk) if fixed else torch.sqrt(-pk * torch.log(R))
        theta = (2 * math.pi) * T
        D = torch.complex(amp * torch.cos(theta), amp * torch.sin(theta))
        s[:, :, y0:y1] = D.permute(1, 2, 0)
        keep[y0:y1].copy_(D)
    out = xspace(s)
    del s
    yield "density", out
    del out
    for name in names[1:]:
        j = "xyz".index(name[-1])
        s = torch.zeros((ppd, ppd, half + 1), dtype=cdt, device=device)
        for y0, y1, ky, n2 in planes():
            k2 = n2.to(dtype) * fund2
            ik2 = torch.where(n2 == 0, 0.0, 1.0 / torch.where(n2 == 0, 1.0, k2))
            if plt:
                vec, lam = plt_vectors(kx, ky, kz, ppd, table, dtype)
                coef = vec[j] * (fund_d * ik2)
            else:
                coef = (kx, ky, kz)[j].to(dtype) * (fund_d * ik2)
            iD = 1j * keep[y0:y1].to(device, non_blocking=True)
            v = coef * iD
            if name.startswith("vel_"):
                v = v * ((torch.sqrt(1.0 + 24.0 * lam * float(npf(f_cluster))) - 1.0) * 0.25)
            s[:, :, y0:y1] = v.permute(1, 2, 0)
        out = xspace(s)
        del s
        yield name, out
        del out
