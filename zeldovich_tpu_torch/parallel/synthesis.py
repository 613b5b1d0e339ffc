"""Sharded mode synthesis: each rank's y-slab of the full k-grid.

Counterpart of ``zeldovich_tpu/parallel/synthesis.py``.  Synthesis is a
function of the global grid index, so each rank builds its own y-slab with
the out-of-core slab synthesis (``ops/modes_real.py::synthesize_pair``,
kernel B5 at each mode's source index), Hermitian-mirror rows included.
The one dependency between ranks is the f_NL input pass: a row y needs
phi(k) at the reflected row (n - y) mod n, which lies on at most two other
ranks; ``reflected`` moves those rows with one uneven all-to-all (the
analog of the JAX ``reflected``, :28).  ``reflected_exchange`` is that
all-to-all for any rows, also those of an out-of-core slab
(``models/outofcore.py::DistributedOutOfCore``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.modes_real import _reflect_zx, synthesize_pair
from .pencil_mmfft import slab


def reflected_exchange(take, rows_of, yl: int, tail, mesh, dtype, device):
    """phi(k) at the reflected rows (n - y) mod n of this rank's rows, each
    row from the rank that holds it, by one uneven all-to-all.

    Rank r holds rows [r yl, (r+1) yl) of the grid; ``rows_of(r)`` lists
    the rows y whose reflections rank r asks for (the same list on every
    rank); ``take(local_rows)`` gives this rank's rows (local indices) as
    a (k, 2, *tail) tensor on ``device``.  Returns (2, len(rows_of(rank)),
    *tail): row i is phi(k) at row (n - rows_of(rank)[i]) mod n; (z, x) are
    not reflected.
    """
    n, w = yl * mesh.world, mesh.world
    y0 = mesh.rank * yl
    row = 2 * int(np.prod(tail))

    def needs(rank):  # the rows rank asks for, in its order
        return [(n - y) % n for y in rows_of(rank)]

    rows, n_in = [], []
    for s in range(w):
        mine = [g - y0 for g in needs(s) if y0 <= g < y0 + yl]
        rows += mine
        n_in.append(len(mine) * row)
    need = needs(mesh.rank)
    n_out = [sum(1 for g in need if g // yl == r) * row for r in range(w)]
    send = take(rows).contiguous()
    recv = torch.empty((len(need), 2, *tail), dtype=dtype, device=device)
    mesh.all_to_all_single(recv.view(-1), send.view(-1), n_out, n_in)
    # the received rows come grouped by the rank that holds them
    order = sorted(range(len(need)), key=lambda i: (need[i] // yl, i))
    out = torch.empty_like(recv)
    out[torch.tensor(order, dtype=torch.long, device=device)] = recv
    return out.transpose(0, 1).contiguous()


def reflected(phi, mesh):
    """Row i of the result is row (n - y0 - i) mod n of the full grid whose
    y-slab [y0, y0 + Yl) this rank holds as ``phi`` (2, Yl, Z, X); (z, x)
    are not reflected."""
    _, yl, nz, nx = phi.shape

    def take(rows):
        idx = torch.tensor(rows, dtype=torch.long, device=phi.device)
        return phi.transpose(0, 1).index_select(0, idx)

    return reflected_exchange(take, lambda r: range(r * yl, (r + 1) * yl), yl,
                              (nz, nx), mesh, phi.dtype, phi.device)


def synthesize_sharded_pair(cfg, tables, dtype, mesh, gen_phi: bool = False,
                            phi_pair=None):
    """This rank's y-slab of the full k-grid, ``(narray, 2, Yl, Z, X)``, or
    of phi(k) ``(1, 2, Yl, Z, X)`` with gen_phi.  ``phi_pair``: this
    rank's y-slab of phi(k) ``(2, Yl, Z, X)`` (the f_NL input pass)."""
    y0, y1 = slab(cfg.ppd, mesh)
    pp = None
    if phi_pair is not None:
        refl = _reflect_zx(reflected(phi_pair, mesh))
        pp = ((phi_pair[0], phi_pair[1]), (refl[0], refl[1]))
    return synthesize_pair(y0, y1 - y0, cfg, tables, dtype, gen_phi=gen_phi,
                           phi_pair=pp)
