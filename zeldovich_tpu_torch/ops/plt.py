"""Particle Linear Theory eigenmodes: table IO + trilinear lookup in torch.

Port of ``zeldovich_tpu/ops/plt.py`` (whose module imports jax): the
reference get_eigenmode/interp_eigmode (src/zeldovich.cpp:149-276) as
vectorized gathers, with the JAX package's order of evaluation so float32
results agree to a few ulp and float64 results to rounding.  Tables come
from the reference's ``eigmodes128`` or from
``ops/lattice.py::generate_eigmodes_table`` at any size.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def load_eigmodes(path) -> np.ndarray:
    """Read an eigenmode table -> float64 array (ppd_e, ppd_e, ppd_e//2+1, 4)."""
    raw = Path(path).read_bytes()
    ppd_e = int(np.frombuffer(raw[:4], dtype="<i4")[0])
    nelem = ppd_e * ppd_e * (ppd_e // 2 + 1) * 4
    expect = 4 + nelem * 8
    if len(raw) != expect:
        raise ValueError(
            f"eigenmode file {path}: size {len(raw)} != expected {expect} "
            f"for ppd {ppd_e}"
        )
    return np.frombuffer(raw[4:], dtype="<f8").reshape(
        ppd_e, ppd_e, ppd_e // 2 + 1, 4
    )


def save_eigmodes(path, table):
    """Write a table (numpy array or tensor) in the reference binary format:
    a ``<i4`` ppd_e, then the ``<f8`` data."""
    if isinstance(table, torch.Tensor):
        table = table.detach().cpu().numpy()
    ppd_e = table.shape[0]
    if table.shape != (ppd_e, ppd_e, ppd_e // 2 + 1, 4):
        raise ValueError(f"eigenmode table of shape {table.shape}")
    with open(path, "wb") as fp:
        np.array([ppd_e], dtype="<i4").tofile(fp)
        np.ascontiguousarray(table, dtype="<f8").tofile(fp)


def _interp_eigmode(ikx, iky, ikz, ppd: int, table, fdt):
    """Trilinear interpolation in k-index space (zeldovich.cpp:154-227).

    ikx, iky in [0, ppd); ikz in [0, ppd/2].  Returns (..., 4) in fdt.
    """
    eig_ppd = table.shape[0]
    halfppd = eig_ppd // 2 + 1
    ppdhalf = eig_ppd // 2

    if eig_ppd % ppd == 0:
        # grid points coincide: direct gather
        step = eig_ppd // ppd
        return table[ikx * step, iky * step, ikz * step].to(fdt)

    npf = np.float32 if fdt == torch.float32 else np.float64
    scale = float(npf(eig_ppd) / npf(ppd))
    fx = scale * ikx.to(fdt)
    fy = scale * iky.to(fdt)
    fz = scale * ikz.to(fdt)

    # don't interpolate across the +Nyquist / -Nyquist discontinuity
    def fix(f):
        return torch.where((f > ppdhalf) & (f < halfppd), torch.floor(f + 1), f)

    fx, fy, fz = fix(fx), fix(fy), fix(fz)

    ixl = fx.to(torch.int64)
    iyl = fy.to(torch.int64)
    izl = fz.to(torch.int64)
    # ik_h == eig_ppd wraps to 0 (interpolate between -1 and 0 frequencies)
    ixh = torch.where(ixl + 1 == eig_ppd, 0, ixl + 1)
    iyh = torch.where(iyl + 1 == eig_ppd, 0, iyl + 1)
    izh = torch.where(izl + 1 == eig_ppd, 0, izl + 1)
    izh = torch.clamp(izh, max=halfppd - 1)

    fx = fx - ixl
    fy = fy - iyl
    fz = fz - izl

    t = table.to(fdt)
    w = lambda a: a[..., None]
    return (
        w((1 - fx) * (1 - fy) * (1 - fz)) * t[ixl, iyl, izl]
        + w((1 - fx) * (1 - fy) * fz) * t[ixl, iyl, izh]
        + w((1 - fx) * fy * (1 - fz)) * t[ixl, iyh, izl]
        + w((1 - fx) * fy * fz) * t[ixl, iyh, izh]
        + w(fx * (1 - fy) * (1 - fz)) * t[ixh, iyl, izl]
        + w(fx * (1 - fy) * fz) * t[ixh, iyl, izh]
        + w(fx * fy * (1 - fz)) * t[ixh, iyh, izl]
        + w(fx * fy * fz) * t[ixh, iyh, izh]
    )


def eigenmode_lookup(kx, ky, kz, ppd: int, table, dtype=torch.float64):
    """get_eigenmode (zeldovich.cpp:229-276), vectorized.

    kx, ky, kz: broadcastable integer wavenumber tensors (wrapped to
    [-ppd/2, ppd/2]).  Returns ((ex, ey, ez), eigenvalue), the vector
    carrying the ``k^2 / (k . e_hat)`` up-weighting (zero where
    ill-defined).
    """
    fdt = dtype
    kx, ky, kz = torch.broadcast_tensors(kx, ky, kz)
    ikx = torch.where(kx < 0, ppd + kx, kx)
    iky = torch.where(ky < 0, ppd + ky, ky)
    ikz = torch.where(kz < 0, ppd + kz, kz)
    # rfft convention: use the +kz half-space index
    ikz = torch.where(ikz > ppd // 2, ppd - ikz, ikz)

    e = _interp_eigmode(ikx, iky, ikz, ppd, table, fdt)
    ex, ey, ez, ev = e[..., 0], e[..., 1], e[..., 2], e[..., 3]
    # the real FFT only stores the +kz half-space: flip the z component
    ez = ez * torch.where(kz < 0, -1.0, 1.0).to(fdt)

    mag = torch.sqrt(ex * ex + ey * ey + ez * ez)
    mag = torch.where(mag == 0, 1.0, mag)
    ex, ey, ez = ex / mag, ey / mag, ez / mag

    k2 = (kx * kx + ky * ky + kz * kz).to(fdt)
    dot = kx.to(fdt) * ex + ky.to(fdt) * ey + kz.to(fdt) * ez
    norm = k2 / torch.where(dot == 0, 1.0, dot)
    norm = torch.where((k2 == 0) | (dot == 0) | ~torch.isfinite(norm), 0.0, norm)
    return (norm * ex, norm * ey, norm * ez), ev
