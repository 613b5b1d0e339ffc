"""Sharded mode synthesis: each rank's y-slab of the full k-grid.

Counterpart of ``zeldovich_tpu/parallel/synthesis.py``.  Synthesis is a
function of the global grid index, so each rank builds its own y-slab with
the out-of-core slab synthesis (``ops/modes_real.py::synthesize_pair``,
kernel B5 at each mode's source index), Hermitian-mirror rows included.
The one dependency between ranks is the f_NL input pass: a row y needs
phi(k) at the reflected row (n - y) mod n, which lies on at most two other
ranks; ``reflected`` moves those rows with one uneven all-to-all (the
analog of the JAX ``reflected``, :28).
"""

from __future__ import annotations

import torch

from ..ops.modes_real import _reflect_zx, synthesize_pair
from .pencil_mmfft import slab


def reflected(phi, mesh):
    """Row i of the result is row (n - y0 - i) mod n of the full grid whose
    y-slab [y0, y0 + Yl) this rank holds as ``phi`` (2, Yl, Z, X); (z, x)
    are not reflected."""
    _, yl, nz, nx = phi.shape
    n, w = yl * mesh.world, mesh.world
    y0 = mesh.rank * yl

    def needs(rank):  # the rows rank's slab needs, in its row order
        return [(n - y) % n for y in range(rank * yl, (rank + 1) * yl)]

    rows, n_in = [], []
    for s in range(w):
        mine = [g - y0 for g in needs(s) if y0 <= g < y0 + yl]
        rows += mine
        n_in.append(len(mine) * 2 * nz * nx)
    need = needs(mesh.rank)
    n_out = [sum(1 for g in need if g // yl == r) * 2 * nz * nx for r in range(w)]
    idx = torch.tensor(rows, dtype=torch.long, device=phi.device)
    send = phi.transpose(0, 1).index_select(0, idx).contiguous()
    recv = torch.empty((yl, 2, nz, nx), dtype=phi.dtype, device=phi.device)
    mesh.all_to_all_single(recv.view(-1), send.view(-1), n_out, n_in)
    # the received rows come grouped by the rank that holds them
    order = sorted(range(yl), key=lambda i: (need[i] // yl, i))
    out = torch.empty_like(recv)
    out[torch.tensor(order, dtype=torch.long, device=phi.device)] = recv
    return out.transpose(0, 1).contiguous()


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
