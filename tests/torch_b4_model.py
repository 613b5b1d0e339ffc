"""A plain torch model of kernel B4's index schedule, for the tests.

csrc/boxmuller.cu gives a thread one (z, x) column (flat index zx, x
fastest) and a tile of ``TY`` consecutive y planes: block (bx, by) of
``THREADS`` threads covers zx in [bx THREADS, (bx + 1) THREADS) and the
planes [by TY, min(half, (by + 1) TY)).  A thread walks its planes ``U`` at
a time (every load of a group before any arithmetic) and ends with single
planes where the tile is ragged.  ``schedule`` lists every (block, thread,
step) access; ``b4_model`` runs that schedule group by group through the
plain draw chain.  The tile constants are read from the CUDA source.
tests/test_torch_boxmuller.py holds the model against the plain version
and the Pallas kernel.  Nothing in the package calls it.
"""

import re
from pathlib import Path

import torch

from zeldovich_tpu_torch.ops.modes_real import gaussian

SOURCE = (Path(__file__).parent.parent / "zeldovich_tpu_torch" / "csrc"
          / "boxmuller.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS = _constant("B4_THREADS")
TY = _constant("B4_TY")
U = _constant("B4_U")


def grid(n, half):
    """The launch's (grid.x, grid.y), as launch_b4 computes them."""
    return (n * n + THREADS - 1) // THREADS, (half + TY - 1) // TY


def steps(half, by):
    """The walk of one thread of tile row `by`: a list of groups, each the
    tile-local plane numbers j whose loads are issued together."""
    rows = min(TY, half - by * TY)
    out, j = [], 0
    while j + U <= rows:
        out.append(list(range(j, j + U)))
        j += U
    out.extend([k] for k in range(j, rows))
    return out


def schedule(n, half):
    """Yield (by, group, y, zx, idx): for tile row `by` and one group of
    its walk, the planes y (g,), every live thread's column zx (over all
    bx, threads with zx >= n^2 left out as the kernel's guard does) and
    the flat offsets idx (g, columns) into pk, live, re and im."""
    gx, gy = grid(n, half)
    nn = n * n
    zx = (torch.arange(gx)[:, None] * THREADS + torch.arange(THREADS)).flatten()
    zx = zx[zx < nn]
    for by in range(gy):
        y0 = by * TY
        for group in steps(half, by):
            y = y0 + torch.tensor(group)
            yield by, group, y, zx, y[:, None] * nn + zx


def b4_model(tables, pk, fixed_power, live=None, ky0=0):
    """(D_re, D_im) as the kernel's threads compute them: each group's pk
    (and live) gathered at the schedule's offsets, the shared-memory plane
    states sp[j] = planes[ky0 + y0 + j], the thread's own (m, c), the plain
    draw chain, and a scatter to the same offsets.  Also returns how often
    each output element was written."""
    half, n = pk.shape[0], pk.shape[-1]
    flat_pk = pk.reshape(-1)
    flat_live = None if live is None else live.reshape(-1)
    re, im = torch.full_like(flat_pk, float("nan")), torch.full_like(flat_pk, float("nan"))
    writes = torch.zeros(flat_pk.shape, dtype=torch.int64)
    mzx = tuple(a.reshape(-1) for a in tables.mzx)
    czx = tuple(a.reshape(-1) for a in tables.czx)
    for by, group, y, zx, idx in schedule(n, half):
        sp = tuple(p[ky0 + by * TY: ky0 + by * TY + TY] for p in tables.planes)
        plane = tuple(s[torch.tensor(group)][:, None] for s in sp)
        m = tuple(a[zx][None] for a in mzx)
        c = tuple(a[zx][None] for a in czx)
        d = gaussian(plane, m, c, flat_pk[idx], fixed_power,
                     None if flat_live is None else flat_live[idx])
        re[idx], im[idx] = d
        writes.index_put_((idx.flatten(),), torch.ones((), dtype=torch.int64),
                          accumulate=True)
    return re.view(pk.shape), im.view(pk.shape), writes.view(pk.shape)
