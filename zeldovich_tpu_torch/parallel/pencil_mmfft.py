"""The sharded forward steps as a slab decomposition over a rank mesh.

Counterpart of ``zeldovich_tpu/parallel/pencil_mmfft.py``.  The JAX package
splits x columns over a 2-D device mesh and exchanges twice an inverse
transform, because XLA wants one SPMD program; here every rank runs the
one-device kernels on a contiguous block and one ``all_to_all_single``
turns its block of y rows (or ky planes) into a block of z planes: the
reference's block decomposition, with the host stage of the out-of-core
run (``models/outofcore.py``) replaced by the exchange.

* the half route (``xspace_half_pair_sharded``; ``half_exact``
  configurations where the FFT kernels take ppd): rank r runs B1
  (``halfspace_pack_zx``, z/x transformed) on its share of the ky planes
  [0, ppd/2), the exchange gives it every ky of its z-slab, and B2
  (``c2r_y``) runs in place on that;
* the full grid (``ifft3_pair_sharded``, ``fft3_pair_sharded``): rank r
  holds the y-slab [r Yl, (r+1) Yl); its z/x DFT, the exchange, then the
  y DFT of its z-slab (``ops/mmfft.py``'s ``dft_zx``/``dft_y``: zx and y,
  or the matrix products at ppd the kernels do not take).  The forward
  transform runs the other way, z-slab to y-slab.

Every step ends on the rank's z-slab ``(narray, 2, Y, Zl, X)``, Zl =
ppd / world: the JAX package's ``zplanes`` layout.  ppd must be a multiple
of the world size (as the JAX package's sharded steps ask); the ky planes
split as evenly as they go (ppd 12 over 4 ranks: 2, 2, 1, 1).  The
exchange runs at every world size, 1 included.
"""

from __future__ import annotations

import torch

from ..ops.c2r import c2r_y
from ..ops.mmfft import dft_y, dft_zx
from ..ops.synth import halfspace_pack_zx
from ..utils.timers import span, tracing


def split_sizes(n: int, world: int) -> list[int]:
    """n entries over world ranks, the first n % world one more."""
    return [n // world + (r < n % world) for r in range(world)]


def _offsets(sizes) -> list[int]:
    out, o = [], 0
    for s in sizes:
        out.append(o)
        o += s
    return out


def check_grid(ppd: int, mesh):
    if ppd % mesh.world:
        raise ValueError(f"grid {ppd} not divisible by {mesh.world} ranks")


def slab(ppd: int, mesh) -> tuple[int, int]:
    """This rank's y-slab (and z-slab) [start, end)."""
    check_grid(ppd, mesh)
    w = ppd // mesh.world
    return mesh.rank * w, (mesh.rank + 1) * w


def ky_planes(ppd: int, mesh) -> tuple[int, int]:
    """This rank's generated ky planes [k0, k1) of [0, ppd/2) on the half
    route (empty where ppd/2 < world)."""
    sizes = split_sizes(ppd // 2, mesh.world)
    k0 = _offsets(sizes)[mesh.rank]
    return k0, k0 + sizes[mesh.rank]


def exchange(x, out, split_axis: int, concat_axis: int, split, concat, mesh):
    """out <- the all-to-all of x, one block at a time.

    The axes before ``min(split_axis, concat_axis)`` index blocks (array,
    component, sign); each block is one ``all_to_all_single``.  Along
    ``split_axis`` the ``split[s]`` entries of x at offset sum(split[:s])
    go to rank s; along ``concat_axis`` out takes rank r's part at offset
    sum(concat[:r]).  The side whose axis leads the block is contiguous a
    rank and is sent from or received into in place; the other side goes
    through one block's buffer, so no more than one block is copied at a
    time.

    The blocks are the span ``shard.exchange``, with the counts ``calls``
    (the ``all_to_all_single`` calls) and ``bytes`` (what this rank sends
    to the other ranks, its own part left out).  While a profiler runs the
    device is synchronized before the span opens and at its close, so that
    its length is the exchange's time, not that of the transforms queued
    before it; with none running nothing waits.
    """
    lead = min(split_axis, concat_axis)
    blk_in, blk_out = x.shape[lead:], out.shape[lead:]
    n_in = [blk_in.numel() // blk_in[split_axis - lead] * n for n in split]
    n_out = [blk_out.numel() // blk_out[concat_axis - lead] * n for n in concat]
    packed = split_axis > lead  # else the send side is in place
    buf = torch.empty(sum(n_in) if packed else sum(n_out), dtype=x.dtype,
                      device=x.device)
    so, co = _offsets(split), _offsets(concat)
    io, oo = _offsets(n_in), _offsets(n_out)
    blocks = x.shape[:lead].numel()
    sent = blocks * (sum(n_in) - n_in[mesh.rank]) * x.element_size()
    synced = tracing() and x.device.type == "cuda"
    if synced:
        torch.cuda.synchronize(x.device)
    with span("shard.exchange", calls=blocks, bytes=sent):
        for b in range(blocks):
            xb = x.flatten(0, lead - 1)[b]
            ob = out.flatten(0, lead - 1)[b]
            if packed:  # x's parts are strided: pack them, receive in place
                for s in range(mesh.world):
                    part = xb.narrow(split_axis - lead, so[s], split[s])
                    buf[io[s]:io[s] + n_in[s]].view(part.shape).copy_(part)
                mesh.all_to_all_single(ob.view(-1), buf, n_out, n_in)
            else:  # send in place, receive into the buffer and unpack
                mesh.all_to_all_single(buf, xb.view(-1), n_out, n_in)
                for r in range(mesh.world):
                    part = ob.narrow(concat_axis - lead, co[r], concat[r])
                    part.copy_(buf[oo[r]:oo[r] + n_out[r]].view(part.shape))
        if synced:
            torch.cuda.synchronize(x.device)
    return out


def xspace_half_pair_sharded(cfg, tables, pk_eff, plt_coefs, mesh, dtype):
    """The half-spectrum forward step of this rank: its z-slab
    ``(narray, 2, Y, Zl, X)`` of x space.

    pk_eff (rows, Z, X) and plt_coefs (4, rows, Z, X) hold this rank's
    generated planes ``ky_planes(ppd, mesh)`` (None where it has none).
    B1 on those planes, the exchange to every ky of the z-slab, B2 in
    place on it.
    """
    n, narray = cfg.ppd, cfg.narray
    check_grid(n, mesh)
    k0, k1 = ky_planes(n, mesh)
    dev = mesh.device
    if k1 > k0:
        g = halfspace_pack_zx(cfg, tables, pk_eff, plt_coefs, ky0=k0)
    else:
        g = torch.empty((narray, 2, 2, 0, n, n), dtype=dtype, device=dev)
    zl = n // mesh.world
    spm = torch.empty((narray, 2, 2, n // 2, zl, n), dtype=dtype, device=dev)
    exchange(g, spm, 4, 3, [zl] * mesh.world, split_sizes(n // 2, mesh.world), mesh)
    del g
    return c2r_y(spm, n, out=spm)  # in place: ky = n/2, no Nyquist row


def ifft3_pair_sharded(yslab, mesh):
    """Unnormalized inverse (FFTW +1) of a full grid held as y-slabs:
    this rank's k-space y-slab ``(narray, 2, Yl, Z, X)`` (transformed over
    z and x in place) in, its x-space z-slab ``(narray, 2, Y, Zl, X)`` out."""
    narray, _, yl, n, _ = yslab.shape
    w = [yl] * mesh.world
    dft_zx(yslab, +1, out=yslab)
    z = torch.empty((narray, 2, yl * mesh.world, n // mesh.world, n),
                    dtype=yslab.dtype, device=yslab.device)
    exchange(yslab, z, 3, 2, [n // mesh.world] * mesh.world, w, mesh)
    return dft_y(z, +1, out=z)


def fft3_pair_sharded(zslab, mesh):
    """Unnormalized forward (FFTW -1), the way back: this rank's z-slab
    ``(narray, 2, Y, Zl, X)`` (transformed along y in place) in, its
    y-slab ``(narray, 2, Yl, Z, X)`` out."""
    narray, _, n, zl, _ = zslab.shape
    dft_y(zslab, -1, out=zslab)
    y = torch.empty((narray, 2, n // mesh.world, zl * mesh.world, n),
                    dtype=zslab.dtype, device=zslab.device)
    exchange(zslab, y, 2, 3, [n // mesh.world] * mesh.world, [zl] * mesh.world, mesh)
    return dft_zx(y, -1, out=y)
