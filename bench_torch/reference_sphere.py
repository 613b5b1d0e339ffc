"""``reference.py`` with the k_cutoff sphere decided as zeldovich-PLT decides
it: what ``correct`` is held against in a configuration that names it
(``"reference": "reference_sphere"``).

The sphere rule zeroes a mode with ``k^2 >= k_nyquist^2``, compared in
float64 as ``n2 fund^2 >= k_nyquist^2`` (zeldovich.cpp:349-358).  On the
sphere itself, ``n2 = (ppd/2)^2``, the two sides are equal in exact
arithmetic, so the last bit of each decides whether those modes are kept.
zeldovich-PLT derives the Nyquist wavenumber as ``pi / separation`` with
``separation = BoxSize / ppd`` (parameters.cpp), and the program's integer
threshold (``utils/power.py::n2_cutoff``) reproduces that comparison;
``reference.py`` computes it as ``pi ppd / BoxSize``.  The two differ in
the last bit at some box sizes: at 576^3 in 500/3 Mpc/h the C++ form
zeroes the sphere's modes and ``reference.py``'s keeps them, which moves
the density by ~5e-4 of its largest value.  This module is
``reference.fields`` with that one line as the C++ has it; everything else
(the spectrum, the draws, the eigenmode vectors, the fields) is
``reference``'s: its helpers imported, ``fields`` copied with that line
changed.  It imports nothing of the program.
The copy lasts until ``reference.py`` takes that line (ROADMAP E10);
``tests/test_torch_odd576.py`` fails if the two bodies part anywhere else.
Where both forms round alike the two modules give the same fields, bit
for bit.
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

from reference import (  # noqa: E402
    FIELDS, SUPPORTED, Draws, Spectrum, _num, _path, load_eigmodes, plt_vectors,
)


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
    nyq = math.pi / (box / ppd)  # pi / separation, as parameters.cpp derives it
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
