"""A plain torch model of the PLT coefficient kernel's blocks, for the tests.

csrc/plt.cu launches the grid of ``kernels.plt_geometry``: block
(bx, bz, r) of ``threads`` threads, ``vec`` consecutive x a thread, covers
the x tile [bx xt, (bx + 1) xt) (xt = threads * vec), the z rows
[bz zt, (bz + 1) zt) and the plane ky = y0 + r.  Where the table's E is a
multiple of ppd a mode reads table[x step, ky step, iz step], iz the kz
fold (z or ppd - z).  Else the block stages the table entries of its tile
(``stage``): every ix from its first x's lower neighbour to its last x's
upper one, E standing for 0 (the wrap), at the plane's two iy and the
row's two iz; it stages again wherever a row's lower iz moves, and a mode
reads its 8 corners from the stage by slot.  ``plt_model`` runs that
schedule block by block (all planes of a tile at once, since a plane only
sets iy), with the kernel's operations in its order as torch ops, and
returns what the kernel writes.  tests/test_torch_plt.py holds it bit for
bit against ``ops/modes_real.py::plt_coef_fields_plain``.  Nothing in the
package calls it.
"""

import re
from pathlib import Path

import numpy as np
import torch

from zeldovich_tpu_torch.kernels import plt_geometry

SOURCE = (Path(__file__).parent.parent / "zeldovich_tpu_torch" / "csrc"
          / "plt.cu").read_text()
#: the kernel's most threads a block, as the CUDA source declares it
THREADS = int(re.search(r"constexpr int PLT_THREADS = (\d+);", SOURCE).group(1))


def nyquist_fix(f, E: int):
    """Don't interpolate across the +/- Nyquist discontinuity of the table."""
    return torch.where((f > E // 2) & (f < E // 2 + 1), torch.floor(f + 1), f)


def stage(table, E: int, ixa: int, R: int, iy, iz, dtype):
    """What a block stages: (planes, corner, component, slot) for the ix
    [ixa, ixa + R), corner c = 2 (iy is the upper) + (iz is the upper),
    rounded to dtype.  iy: (planes, 2) lower and upper iy; iz: (2,)."""
    ix = torch.arange(ixa, ixa + R)
    ix = torch.where(ix == E, 0, ix)
    iyc = iy[:, [0, 0, 1, 1]]  # (planes, 4)
    izc = iz[[0, 1, 0, 1]]  # (4,)
    t = table[ix[None, None, :], iyc[:, :, None], izc[None, :, None]]  # (P, 4, R, 4)
    return t.permute(0, 1, 3, 2).to(dtype)


def finish(e, kx, ky, kz, c, dtype):
    """The kernel's ``finish``: (cx, cy, cz, f) from the looked-up
    (ex, ey, ez, ev); kx (X,), ky (planes, 1), kz a number; c the scalars."""
    ex, ey, ez, ev = e
    if kz < 0:
        ez = -ez
    mag = torch.sqrt(ex * ex + ey * ey + ez * ez)
    mag = torch.where(mag == 0, 1.0, mag)
    ex, ey, ez = ex / mag, ey / mag, ez / mag
    n2 = kx * kx + ky * ky + kz * kz
    k2 = n2.to(dtype)
    dot = kx.to(dtype) * ex + ky.to(dtype) * ey + float(kz) * ez
    norm = k2 / torch.where(dot == 0, 1.0, dot)
    norm = torch.where((n2 == 0) | (dot == 0) | ~torch.isfinite(norm), 0.0, norm)
    ik2 = torch.where(n2 == 0, 0.0, 1.0 / torch.where(n2 == 0, 1.0, k2 * c["fund2"]))
    f = (torch.sqrt(1.0 + ev * 24.0 * c["fcl"]) - 1.0) * 0.25
    if c["rescale"]:
        scale = torch.pow(c["base"], c["target"] - f) * c["fund"] * ik2
    else:
        scale = c["fund"] * ik2
    return norm * ex * scale, norm * ey * scale, norm * ez * scale, f


def scalars(cfg, dtype) -> dict:
    """The kernel's scalar operands, rounded to dtype as plt_coef_fields
    passes them."""
    npf = np.float32 if dtype == torch.float32 else np.float64
    return {"fund": float(npf(cfg.fundamental)),
            "fund2": float(npf(cfg.fundamental) ** 2),
            "fcl": float(npf(cfg.f_cluster)),
            "base": float(npf(cfg.plt_rescale_base)),
            "target": float(npf(cfg.plt_target_f)),
            "rescale": cfg.qPLTrescale}


def plt_model(cfg, table, dtype, rows=None, stats=None):
    """The kernel's output (4, rows, n, n) for the planes ``rows`` (all by
    default); ``stats`` (a dict), if given, receives the stagings' count
    and the largest staged range."""
    n, half, E = cfg.ppd, cfg.ppd // 2, table.shape[0]
    y0, y1 = rows if rows is not None else (0, half)
    g = plt_geometry(n, E, dtype)
    assert g["threads"] <= THREADS and (g["threads"] * g["vec"]) % g["vec"] == 0
    xt, zt, step, c = g["threads"] * g["vec"], g["zt"], g["step"], scalars(cfg, dtype)
    scale = g["scale"]
    out = torch.empty((4, y1 - y0, n, n), dtype=dtype)
    ky = torch.arange(y0, y1)[:, None]  # (planes, 1)
    fy = nyquist_fix(scale * ky.to(dtype), E)
    iyl = fy.to(torch.int64)
    iy = torch.cat([iyl, torch.where(iyl + 1 == E, 0, iyl + 1)], dim=1)  # (planes, 2)
    wy = fy - iyl
    ay = 1 - wy
    stagings, widest = 0, 0
    for x0 in range(0, n, xt):
        x = torch.arange(x0, min(x0 + xt, n))
        kx = torch.where(x > half, x - n, x)
        fx = nyquist_fix(scale * x.to(dtype), E)
        ixl = fx.to(torch.int64)
        ixa = int(ixl[0])
        R = int(ixl[-1]) + 2 - ixa
        widest = max(widest, R)
        assert step or R <= g["cap"], "a tile stages more than the cap"
        sl = ixl - ixa
        wx = fx - ixl
        ax = 1 - wx
        # weights (planes, X) of the corners lll, llh, ..., hhh: x, y, z
        xy = (ax * ay, ax * wy, wx * ay, wx * wy)
        for z0 in range(0, n, zt):
            staged, S = None, None
            for z in range(z0, min(z0 + zt, n)):
                kz = z - n if z > half else z
                iz = n - z if z > half else z
                if step:
                    t = table[x * step, ky * step, iz * step].to(dtype)  # (P, X, 4)
                    e = t.unbind(-1)
                else:
                    fz = nyquist_fix(scale * torch.tensor(float(iz), dtype=dtype), E)
                    izl = int(fz)
                    izh = min(0 if izl + 1 == E else izl + 1, E // 2)
                    wz = fz - izl
                    az = 1 - wz
                    if izl != staged:
                        S = stage(table, E, ixa, R, iy, torch.tensor([izl, izh]), dtype)
                        staged = izl
                        stagings += 1
                    w = [xy[q >> 1] * (wz if q & 1 else az) for q in range(8)]
                    e = []
                    for k in range(4):
                        acc = w[0] * S[:, 0, k, sl]
                        for q in range(1, 8):
                            acc = acc + w[q] * S[:, q & 3, k, sl + (q >> 2)]
                        e.append(acc)
                for j, v in enumerate(finish(e, kx, ky, kz, c, dtype)):
                    out[j, :, z, x0:x0 + len(x)] = v
    if stats is not None:
        stats.update(stagings=stagings, widest=widest)
    return out
