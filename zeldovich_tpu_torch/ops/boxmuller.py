"""B4 and B5: Gaussian deviates D = live * cgauss(pk) from the pcg64 stream.

Ports of ``zeldovich_tpu/ops/pallas_synth.py``:

* ``halfspace_boxmuller(tables, pk, fixed_power, live=None, ky0=0)`` (B4,
  ``halfspace_boxmuller_pallas``) returns ``(D_re, D_im)`` of shape
  ``(rows, Z, X)``: per mode of the generated planes [ky0, ky0 + rows)
  (all ``half`` of them on the full-grid path) the first-draw state
  ``plane[y] * mzx[z, x] + czx[z, x]``, two XSL-RR draws and Box-Muller
  against ``pk`` (times ``live`` where given).  The kernel gives a thread
  one (z, x) column, its jump map in registers, and walks tiles of y
  planes;
* ``boxmuller(tables, sy, sz, sx, pk, live, fixed_power)`` (B5,
  ``boxmuller_pallas``) does the same at per-mode source indices: the
  state ``plane[sy] * mzx[sz, sx] + czx[sz, sx]``, any shape.  The TPU
  kernel takes the jumped states as limb planes; here the kernel forms
  them itself from the indices, one native 128-bit multiply-add.

Both take every even ppd (``synth.check_draw_size``).  On a CUDA tensor
each launches its hand-written kernel
(csrc/boxmuller.cu, the float32 or the float64 instance by pk's dtype:
the fast float32 draws or the exact float64 ones) or raises; on a CPU
tensor it runs the plain version, the draw chain in int64-limb torch ops
(``modes_real.gaussian``).
"""

from __future__ import annotations

import torch

from .. import kernels
from .modes import SynthTables
from .modes_real import draw_planes, gaussian, y_chunk
from .synth import check_draw_size, check_kernel_dtype, check_operands


def _check_planes(tables: SynthTables, rows: int, ky0: int):
    half = tables.planes64.shape[0]
    if not 0 <= ky0 < ky0 + rows <= half:
        raise ValueError(
            f"halfspace_boxmuller: planes [{ky0}, {ky0 + rows}) outside [0, {half})")


def halfspace_boxmuller_plain(tables: SynthTables, pk, fixed_power: bool,
                              live=None, ky0: int = 0):
    """Plain version of B4: the draw chain in int64-limb torch ops,
    chunked over y."""
    rows, ppd = pk.shape[0], pk.shape[-1]
    _check_planes(tables, rows, ky0)
    re, im = torch.empty_like(pk), torch.empty_like(pk)
    cy = y_chunk(rows, ppd, 1 << 22)
    for y0 in range(0, rows, cy):
        y1 = y0 + cy
        re[y0:y1], im[y0:y1] = draw_planes(
            tables, ky0 + y0, ky0 + y1, pk[y0:y1], fixed_power,
            None if live is None else live[y0:y1],
        )
    return re, im


def _table_operands(tables: SynthTables, n: int, half: int) -> dict:
    return {
        "planes64": (tables.planes64, (half, 2), torch.int64),
        "mzx64": (tables.mzx64, (2, n, n), torch.int64),
        "czx64": (tables.czx64, (2, n, n), torch.int64),
    }


def halfspace_boxmuller(tables: SynthTables, pk, fixed_power: bool, live=None,
                        ky0: int = 0):
    """D over generated planes: (D_re, D_im), each (rows, Z, X).

    pk: (rows, Z, X) P(k) of the generated planes [ky0, ky0 + rows), all
    half of them on the full-grid path, the zero rules optionally folded
    in (pk = 0 zeroes a mode exactly); live: optional (rows, Z, X) 0/1
    mask.
    """
    dev = pk.device
    if dev.type == "cpu":
        return halfspace_boxmuller_plain(tables, pk, fixed_power, live, ky0)
    rows, n = pk.shape[0], pk.shape[-1]
    check_draw_size(n)
    if dev.type != "cuda":
        raise ValueError(f"halfspace_boxmuller: no kernel for device {dev}")
    _check_planes(tables, rows, ky0)
    check_kernel_dtype(pk.dtype)
    want = {"pk": (pk, (rows, n, n), pk.dtype),
            **_table_operands(tables, n, tables.planes64.shape[0])}
    if live is not None:
        want["live"] = (live, (rows, n, n), pk.dtype)
    check_operands(want, dev)
    re, im = torch.empty_like(pk), torch.empty_like(pk)
    kernels.launch_boxmuller(tables.planes64[ky0:ky0 + rows], tables.mzx64,
                             tables.czx64, pk, live, re, im, n, rows, fixed_power)
    return re, im


def boxmuller_plain(tables: SynthTables, sy, sz, sx, pk, live, fixed_power: bool):
    """Plain version of B5: gather the limb tables at the indices, then
    the draw chain, over flat chunks of ~4M modes."""
    shape = pk.shape
    sy, sz, sx, pk, live = (t.reshape(-1) for t in (sy, sz, sx, pk, live))
    re, im = torch.empty_like(pk), torch.empty_like(pk)
    step = 1 << 22
    for i0 in range(0, pk.numel(), step):
        s = slice(i0, i0 + step)
        iy, iz, ix = sy[s].long(), sz[s].long(), sx[s].long()
        plane = tuple(p[iy] for p in tables.planes)
        m = tuple(a[iz, ix] for a in tables.mzx)
        c = tuple(a[iz, ix] for a in tables.czx)
        re[s], im[s] = gaussian(plane, m, c, pk[s], fixed_power, live[s])
    return re.reshape(shape), im.reshape(shape)


def boxmuller(tables: SynthTables, sy, sz, sx, pk, live, fixed_power: bool):
    """D = live * cgauss(pk) at source indices: (D_re, D_im) shaped like pk.

    sy, sz, sx: int32 indices of each mode's source in the generated half
    space (sy in [0, half), sz and sx in [0, ppd)), shaped like pk;
    pk: P(|k|) of the source; live: 0/1 (the zero rules).
    """
    dev = pk.device
    if dev.type == "cpu":
        return boxmuller_plain(tables, sy, sz, sx, pk, live, fixed_power)
    n = tables.mzx64.shape[-1]
    half = tables.planes64.shape[0]
    check_draw_size(n)
    if dev.type != "cuda":
        raise ValueError(f"boxmuller: no kernel for device {dev}")
    shape = tuple(pk.shape)
    check_kernel_dtype(pk.dtype)
    want = {
        "sy": (sy, shape, torch.int32), "sz": (sz, shape, torch.int32),
        "sx": (sx, shape, torch.int32), "pk": (pk, shape, pk.dtype),
        "live": (live, shape, pk.dtype), **_table_operands(tables, n, half),
    }
    check_operands(want, dev)
    re, im = torch.empty_like(pk), torch.empty_like(pk)
    kernels.launch_boxmuller_at(sy, sz, sx, tables.planes64, tables.mzx64,
                                tables.czx64, pk, live, re, im, pk.numel(), n,
                                fixed_power)
    return re, im
