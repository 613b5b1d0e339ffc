"""Setup fields and the plain half-spectrum synthesis, as torch tensor ops.

Port of the main-path parts of ``zeldovich_tpu/ops/modes_real.py``:

* ``pk_effective``: P(k) with the zero rules folded in (pk = 0 zeroes a
  mode exactly, since sqrt(-0 * log R) == 0);
* ``plt_coef_fields``: the PLT eigenmode coefficient planes;
* ``synthesize_half_pair``: the packed half-SPECTRUM
  ``(narray, 2, 2, half+1, Z, X)`` = (array, +/- packing, re/im, ky, Z, X),
  with the ky=0 self-conjugate fixup and the zero y-Nyquist row.

These are the plain versions the CUDA kernel of ops/synth.py is held
against.  Work is chunked over y so the int64 limb temporaries of the
draw chain stay bounded at 512^3 and above.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pcg_device
from .modes import SynthConfig, SynthTables, zero_rules


def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _y_chunk(half: int, ppd: int, max_elems: int) -> int:
    """Largest divisor of half with chunk * ppd^2 <= max_elems (>= 1)."""
    cy = max(1, min(half, max_elems // (ppd * ppd)))
    while half % cy:
        cy -= 1
    return cy


def _wavenumbers(y0: int, y1: int, ppd: int, device):
    """ky (ny,1,1), kz (1,Z,1), kx (1,1,X) int64 and their integer n2."""
    half = ppd // 2
    ky = torch.arange(y0, y1, device=device)[:, None, None]
    z = torch.arange(ppd, device=device)[None, :, None]
    x = torch.arange(ppd, device=device)[None, None, :]
    kz = torch.where(z > half, z - ppd, z)
    kx = torch.where(x > half, x - ppd, x)
    n2 = kx * kx + ky * ky + kz * kz
    return ky, kz, kx, n2


def pk_effective(cfg: SynthConfig, tables: SynthTables, dtype):
    """Static per-run amplitude field (half, Z, X): the zero-rule mask
    folded into P(k).  Bit-equal to the JAX package's (a gather + cast)."""
    ppd, half = cfg.ppd, cfg.ppd // 2
    dev = tables.device
    out = torch.empty((half, ppd, ppd), dtype=dtype, device=dev)
    cy = _y_chunk(half, ppd, 1 << 23)
    for y0 in range(0, half, cy):
        ky, kz, kx, n2 = _wavenumbers(y0, y0 + cy, ppd, dev)
        zero = zero_rules(kx, ky, kz, n2, cfg)
        pk = tables.pk_n2[n2].to(dtype)
        out[y0:y0 + cy] = torch.where(zero, 0.0, pk)
    return out


def _inv_k2(n2, cfg: SynthConfig, dtype):
    """1/k^2 (0 at the origin), in the JAX package's rounding order."""
    npf = _np_dtype(dtype)
    k2 = n2.to(dtype) * float(npf(cfg.fundamental) ** 2)
    return torch.where(n2 == 0, 0.0, 1.0 / torch.where(n2 == 0, 1.0, k2))


def plt_coef_fields(cfg: SynthConfig, tables: SynthTables, dtype):
    """Setup-time PLT coefficient planes, stacked (4, half, Z, X).

    Planes cx, cy, cz = evec_j * rescale * fundamental / k^2 (the per-mode
    displacement coefficients) and f, the PLT growth factor of the
    velocity arrays.  One stacked tensor, so the kernel takes one pointer.
    Chunked over y: the 8-point gather holds ~8 chunk-sized (.., 4)
    temporaries at once.
    """
    from .plt import eigenmode_lookup

    ppd, half = cfg.ppd, cfg.ppd // 2
    npf = _np_dtype(dtype)
    dev = tables.device
    out = torch.empty((4, half, ppd, ppd), dtype=dtype, device=dev)
    cy = _y_chunk(half, ppd, 32 * ppd * ppd)
    fund = float(npf(cfg.fundamental))
    for y0 in range(0, half, cy):
        ky, kz, kx, n2 = _wavenumbers(y0, y0 + cy, ppd, dev)
        ik2 = _inv_k2(n2, cfg, dtype)
        evec, eval_ = eigenmode_lookup(kx, ky, kz, ppd, tables.eig, dtype=dtype)
        f = (torch.sqrt(1.0 + 24.0 * eval_ * float(npf(cfg.f_cluster))) - 1.0) * 0.25
        if cfg.qPLTrescale:
            rescale = torch.pow(float(npf(cfg.plt_rescale_base)),
                                float(npf(cfg.plt_target_f)) - f)
            scale = rescale * fund * ik2
        else:
            scale = fund * ik2
        for j in range(3):
            out[j, y0:y0 + cy] = evec[j] * scale
        out[3, y0:y0 + cy] = f
    return out


def _reflect_zx(p):
    """p[..., (n - z) % n, (n - x) % n]."""
    n = p.shape[-1]
    idx = (n - torch.arange(n, device=p.device)) % n
    return p[..., idx[:, None], idx[None, :]]


def fix_ky0_packed(out):
    """Self-conjugate ky=0 fixup of a packed (narray, 2, 2, ky, Z, X) array,
    in place: on the in-plane mirror half, S+ = conj(reflect(S-)) and
    S- = conj(reflect(S+)); the origin is zeroed (zeldovich.cpp:485-503)."""
    ppd = out.shape[-1]
    half = ppd // 2
    z = torch.arange(ppd, device=out.device)[:, None]
    x = torch.arange(ppd, device=out.device)[None, :]
    fixm = (z > half) | ((z == 0) & (x > half))
    orig = (z == 0) & (x == 0)
    row = out[:, :, :, 0]  # (narray, pm, reim, Z, X)
    refl = _reflect_zx(row.flip(1))  # the opposite packing, reflected
    conj = torch.tensor([1.0, -1.0], dtype=out.dtype, device=out.device)
    fixed = torch.where(fixm, refl * conj[:, None, None], row)
    out[:, :, :, 0] = torch.where(orig, 0.0, fixed)
    return out


def _pack_into(out, a, y0, y1, Dp, Fp):
    """Both packings of two real fields: S+ = D + iF, S- = D - iF."""
    out[a, 0, 0, y0:y1] = Dp[0] - Fp[1]
    out[a, 0, 1, y0:y1] = Dp[1] + Fp[0]
    out[a, 1, 0, y0:y1] = Dp[0] + Fp[1]
    out[a, 1, 1, y0:y1] = Dp[1] - Fp[0]


def synthesize_half_pair(cfg: SynthConfig, tables: SynthTables, dtype,
                         pk_eff, plt_coefs=None):
    """Half-SPECTRUM synthesis: (narray, 2, 2, half+1, Z, X), plain torch.

    Per mode of the generated half-space: the first-draw state
    plane[y]*mzx + czx, two XSL-RR draws, Box-Muller against pk_eff, the
    displacement fields i k_j/k^2 D (or the PLT coefficient planes, and f
    times them for the velocity arrays), both +/- packings; then the ky=0
    fixup and the zero y-Nyquist row.
    """
    ppd, half = cfg.ppd, cfg.ppd // 2
    dev = pk_eff.device
    if cfg.qPLT and plt_coefs is None:
        plt_coefs = plt_coef_fields(cfg, tables, dtype)
    narray = cfg.narray
    out = torch.zeros((narray, 2, 2, half + 1, ppd, ppd), dtype=dtype, device=dev)
    npf = _np_dtype(dtype)
    fund = float(npf(cfg.fundamental))
    m = tuple(a[None] for a in tables.mzx)
    c = tuple(a[None] for a in tables.czx)
    ny = _y_chunk(half, ppd, 1 << 22)
    for y0 in range(0, half, ny):
        y1 = y0 + ny
        plane = tuple(p[y0:y1, None, None] for p in tables.planes)
        R, T = pcg_device.uniform_pair_from_affine(plane, m, c, dtype)
        pk = pk_eff[y0:y1]
        amp = torch.sqrt(pk) if cfg.fixed_power else torch.sqrt(-pk * torch.log(R))
        cosv, sinv = pcg_device.sincos_2pi(T)
        D = (amp * cosv, amp * sinv)
        if cfg.just_density:
            zero = torch.zeros_like(D[0])
            _pack_into(out, 0, y0, y1, D, (zero, zero))
            continue
        if cfg.qPLT:
            cx, cy, cz, f = (p[y0:y1] for p in plt_coefs)
        else:
            ky, kz, kx, n2 = _wavenumbers(y0, y1, ppd, dev)
            scale = fund * _inv_k2(n2, cfg, dtype)
            cx, cy, cz = (k.to(dtype) * scale for k in (kx, ky, kz))
        F = (-cx * D[1], cx * D[0])
        G = (-cy * D[1], cy * D[0])
        H = (-cz * D[1], cz * D[0])
        _pack_into(out, 0, y0, y1, D, F)
        _pack_into(out, 1, y0, y1, G, H)
        if cfg.qPLT:
            zero = torch.zeros_like(D[0])
            _pack_into(out, 2, y0, y1, (zero, zero), (F[0] * f, F[1] * f))
            _pack_into(out, 3, y0, y1, (G[0] * f, G[1] * f), (H[0] * f, H[1] * f))
    return fix_ky0_packed(out)
