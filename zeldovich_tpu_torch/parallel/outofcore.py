"""Out of core over a mesh of ranks: each rank stages 1/W of the grid.

Counterpart of ``zeldovich_tpu/parallel/outofcore.py``.  The JAX package
splits its host stage over processes along x and lets XLA reshard every
slab (``synth_ifft_zx_sharded`` :102, ``fwd_y_phi_nl_sharded`` :189,
``fwd_zx_sharded`` :228, ``ifft_y_sharded`` :264).  The port splits it
along y, as its sharded steps split the in-core grid
(``parallel/pencil_mmfft.py``): rank r's stage holds rows
[r Yl, (r+1) Yl) of every (z, x), Yl = ppd / W, so

* pass 1 (synthesis, the z/x DFT) runs on the rank's own y-slabs as on one
  device, with no collective (``models/outofcore.py``);
* pass 2 walks the z-blocks in lockstep: at step j every rank owns the
  z-block [r Zl + j Bz, r Zl + (j+1) Bz), Bz a divisor of Zl = Yl, and
  needs every rank's rows of it.  Each rank copies its rows of every
  rank's j-th block to the card (``zblocks``: one strided view of its
  stage), and one ``all_to_all_single`` a block (``exchange``) gives it
  its z-slab ``(narray, 2, Y, Bz, X)`` (``zslab_from_rows``); the way
  back (the f_NL phi pass) is ``rows_from_zslab``.
"""

from __future__ import annotations

import torch

from .pencil_mmfft import exchange


def zblocks(stage, j: int, bz: int, world: int):
    """This rank's rows of every rank's j-th z-block of thickness bz: a
    strided view ``(narray, 2, Yl, W, Bz, X)`` of its stage ``(narray, 2,
    Yl, Z, X)`` (rank s's block is [s Zl + j bz, s Zl + (j+1) bz))."""
    na, two, yl, nz, nx = stage.shape
    return stage.reshape(na, two, yl, world, nz // world, nx)[
        :, :, :, :, j * bz:(j + 1) * bz]


def zslab_from_rows(rows, mesh):
    """rows ``(narray, 2, Yl, W, Bz, X)`` (``zblocks`` on the device) ->
    this rank's z-slab ``(narray, 2, Y, Bz, X)``, by one exchange."""
    na, two, yl, w, bz, nx = rows.shape
    out = torch.empty((na, two, yl * w, bz, nx), dtype=rows.dtype, device=rows.device)
    return exchange(rows.reshape(na, two, yl, w * bz, nx), out, 3, 2, [bz] * w,
                    [yl] * w, mesh)


def rows_from_zslab(z, mesh):
    """The way back: this rank's z-slab ``(narray, 2, Y, Bz, X)`` ->
    its rows of every rank's block ``(narray, 2, Yl, W, Bz, X)``."""
    na, two, n, bz, nx = z.shape
    w = mesh.world
    out = torch.empty((na, two, n // w, w * bz, nx), dtype=z.dtype, device=z.device)
    exchange(z, out, 2, 3, [n // w] * w, [bz] * w, mesh)
    return out.view(na, two, n // w, w, bz, nx)
