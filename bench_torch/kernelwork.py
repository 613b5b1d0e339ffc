"""The work of the port's kernels and the card's peaks: the yardstick of
the kernel roofline metric.

A kernel's least time is the larger of its bytes (each input read once,
each output written once) over the memory rate and its operations over
the peak: a complex DFT of length n costs 5 n log2 n operations an
element, a mode of the draw kernels (the pcg64 jump, two XSL-RR draws,
Box-Muller) 100 32-bit operations and, in float64, 146 float64 ones on
top (the count of the float64 draw chain's SASS on the card, PR 7).

The work is reckoned from the cell's shapes for each launch counter of
the program's ``kernels.launches``, and for ``plt_coefs`` from
``kernels.plt_launches`` (the PLT coefficient kernel, which writes its
four planes and reads its eigenmode table once): what one launch of that
entry does on the route the cell takes.  In a cell of N ranks it is rank
0's share: its ky planes before the exchange and its z-slab after it,
since the counters and the trace are rank 0's.  A counter that moved and
has no entry here for the route means the route changed, and the metrics
built on it stay silent rather than guess.
"""

from __future__ import annotations

import math
from pathlib import Path

#: NVIDIA H100 SXM data sheet: HBM3 rate, float32 and float64 vector peaks
HBM_BPS, F32_OPS, F64_OPS = 3.35e12, 67e12, 33.5e12
#: operations a mode of the draw kernels: 32-bit integer ones, and the
#: float64 ones of the float64 instances
DRAW_OPS, DRAW_F64_OPS = 100, 146


def bound_s(moved: float, ops: float, itemsize: int, draws: float = 0.0) -> float:
    """Seconds the card needs at least: bytes or operations, the larger."""
    peak = F32_OPS if itemsize == 4 else F64_OPS
    t_ops = (ops / peak + draws * DRAW_OPS / F32_OPS
             + (draws * DRAW_F64_OPS / F64_OPS if itemsize == 8 else 0.0))
    return max(moved / HBM_BPS, t_ops)


def fft_ops(elems: float, n: int) -> float:
    """5 n log2 n operations a length-n complex DFT, for ``elems`` complex
    elements transformed along that axis."""
    return 5.0 * elems * math.log2(n)


def _tables(n: int, planes: int) -> int:
    """Bytes of the pcg64 tables a draw kernel reads: the states of its
    ``planes`` planes (16 each) and the (z, x) jump maps (2 x n^2 x 16)."""
    return planes * 16 + 2 * 2 * n * n * 16


def per_launch(route: str, n: int, narray: int, itemsize: int, plt: bool,
               slab: int = 0, ranks: int = 1, table: int = 0) -> dict:
    """Seconds at the bound of one launch of each counter on ``route``.

    ``half``: the in-core half-spectrum step (B1 = synthesis, packing and
    the x and z DFTs of the packed half spectrum; B2 = the c2r DFT along y
    in place), with PLT the coefficient planes (``table`` bytes of
    eigenmodes read).  Over ``ranks`` ranks, rank 0's share: B1 and the
    planes on its ky planes (the first ceil(n/2 / ranks)), B2 on its
    n / ranks z planes.  ``ooc``: the out-of-core passes with y-slabs of
    ``slab`` rows (B5 draws of a slab's modes at their source indices, zx
    on the slab, y on a z-slab of the same size).
    """
    s, half = itemsize, n // 2
    if route == "half":
        rows = -(-half // ranks)  # rank 0's ky planes
        packed = narray * 2 * 2 * rows * n * n * s  # B1's output
        coefs = 4 * rows * n * n * s if plt else 0
        zpacked = narray * 2 * 2 * half * (n // ranks) * n * s  # B2's z-slab
        out = {
            "halfspace_pack_zx": bound_s(
                rows * n * n * s + _tables(n, rows) + coefs + packed,
                2 * fft_ops(packed / s / 2, n), s, draws=rows * n * n),
            "c2r_y": bound_s(2 * zpacked, fft_ops(zpacked / s / 2, n), s),
        }
        if plt:
            out["plt_coefs"] = bound_s(coefs + table, 0.0, s)
        return out
    if route == "ooc":
        # B5 draws a slab in launches of at most 2^24 modes
        modes = max(1, min(slab, (1 << 24) // (n * n))) * n * n
        block = narray * 2 * slab * n * n * s  # a slab of the stage
        return {
            # operands: three int32 source indices, P(k) and the live mask;
            # outputs: D's real and imaginary parts
            "boxmuller": bound_s(modes * (3 * 4 + 2 * s) + _tables(n, half) + 2 * modes * s,
                                 0.0, s, draws=modes),
            "zx_dft": bound_s(2 * block, 2 * fft_ops(block / s / 2, n), s),
            "y_dft": bound_s(2 * block, fft_ops(block / s / 2, n), s),
        }
    raise ValueError(f"no work model for route {route!r}")


def model_for(config: dict, root: Path, ranks: int = 1) -> dict:
    """``per_launch`` of the route a configuration file's run takes over
    ``ranks`` ranks (rank 0's share); file names resolve against ``root``."""
    par, flags = config["par"], config.get("flags", [])
    n = round(int(par["NP"]) ** (1 / 3))
    plt = bool(int(par.get("ZD_qPLT", 0)))
    narray, s = (4 if plt else 2), (8 if config["dtype"] == "float64" else 4)
    if "--out-of-core" not in flags:
        # the eigenmode table: its file less the 4-byte header
        table = (Path(root) / par["ZD_PLT_filename"]).stat().st_size - 4 if plt else 0
        return per_launch("half", n, narray, s, plt, ranks=ranks, table=table)
    # the program's slab: the most y rows of the stage within --slab-mb that
    # divide ppd
    mb = int(flags[flags.index("--slab-mb") + 1]) if "--slab-mb" in flags else 2048
    slab = max(1, min(n, (mb << 20) // (n * n * narray * 2 * s)))
    while n % slab:
        slab -= 1
    return per_launch("ooc", n, narray, s, plt, slab)


def window_bound_s(launches: dict, model: dict) -> float | None:
    """The window's least time: sum of launches times their bound; None
    where a counter moved that the route's model does not know."""
    total = 0.0
    for name, count in launches.items():
        if not count:
            continue
        if name not in model:
            return None
        total += count * model[name]
    return total
