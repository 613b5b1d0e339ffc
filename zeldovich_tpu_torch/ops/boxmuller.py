"""B4: Gaussian deviates over the generated half space.

Port of ``zeldovich_tpu/ops/pallas_synth.py::halfspace_boxmuller_pallas``.
``halfspace_boxmuller(tables, pk, fixed_power, live=None)`` returns
``(D_re, D_im)`` of shape ``(half, Z, X)``: per mode the first-draw state
``plane[y] * mzx[z, x] + czx[z, x]``, two XSL-RR draws and Box-Muller
against ``pk`` (times ``live`` where given).

On a CUDA tensor it launches the hand-written kernel (csrc/boxmuller.cu)
or raises; on a CPU tensor it runs the plain version, the front of the
plain half-spectrum synthesis (``modes_real.draw_planes``) over y-chunks.
"""

from __future__ import annotations

import torch

from .. import kernels
from .modes import SynthTables
from .modes_real import draw_planes, y_chunk
from .synth import check_kernel_size, check_operands


def halfspace_boxmuller_plain(tables: SynthTables, pk, fixed_power: bool,
                              live=None):
    """Plain version: the draw chain in int64-limb torch ops, chunked over y."""
    half, ppd = pk.shape[0], pk.shape[-1]
    re, im = torch.empty_like(pk), torch.empty_like(pk)
    cy = y_chunk(half, ppd, 1 << 22)
    for y0 in range(0, half, cy):
        y1 = y0 + cy
        re[y0:y1], im[y0:y1] = draw_planes(
            tables, y0, y1, pk[y0:y1], fixed_power,
            None if live is None else live[y0:y1],
        )
    return re, im


def halfspace_boxmuller(tables: SynthTables, pk, fixed_power: bool, live=None):
    """D over the generated half space: (D_re, D_im), each (half, Z, X).

    pk: (half, Z, X) P(k), the zero rules optionally folded in (pk = 0
    zeroes a mode exactly); live: optional (half, Z, X) 0/1 mask.
    """
    dev = pk.device
    if dev.type == "cpu":
        return halfspace_boxmuller_plain(tables, pk, fixed_power, live)
    if dev.type != "cuda":
        raise ValueError(f"halfspace_boxmuller: no kernel for device {dev}")
    half, n = pk.shape[0], pk.shape[-1]
    check_kernel_size(n)
    want = {
        "pk": (pk, (half, n, n), torch.float32),
        "planes64": (tables.planes64, (half, 2), torch.int64),
        "mzx64": (tables.mzx64, (2, n, n), torch.int64),
        "czx64": (tables.czx64, (2, n, n), torch.int64),
    }
    if live is not None:
        want["live"] = (live, (half, n, n), torch.float32)
    check_operands(want, dev)
    re, im = torch.empty_like(pk), torch.empty_like(pk)
    kernels.launch_boxmuller(tables.planes64, tables.mzx64, tables.czx64, pk,
                             live, re, im, n, half, fixed_power)
    return re, im
