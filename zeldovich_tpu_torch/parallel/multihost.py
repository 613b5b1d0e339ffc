"""Several processes, on one host or on several: each writes its own slabs.

Counterpart of ``zeldovich_tpu/parallel/multihost.py``.  The JAX package
reshards the x-space grid to z-slabs (``zslab_sharding`` :62) before every
process writes the slabs it owns; the port's sharded steps
(``parallel/pencil_mmfft.py``) already end on each rank's z-slab
``(narray, 2, Y, Zl, X)``, planes [r Zl, (r+1) Zl), so nothing is
resharded.  What is multi-process here:

1. parallel particle output: every rank pwrites its own planes into the
   shared ic_* files at computed offsets (``OutputWriter(parallel=True)``,
   utils/output.py), the byte image of the reference's serial append
   loop (src/output.cpp:208-212); no rank receives another's slab;
2. a reduction of the QA statistics over the ranks (density variance,
   signed componentwise max displacement, bytes written).

Synthesis is a function of the global grid index, so the ic_* bytes do
not depend on the number of ranks.
"""

from __future__ import annotations

import torch

from ..utils.output import OutputWriter
from ..utils.streamio import stream_xspace


def write_local_slabs(x, writer, mesh):
    """Write this rank's z-slab x ``(narray, 2, Y, Zl, X)``, planes
    [rank Zl, (rank+1) Zl), through its own writer, one chunk ahead as
    ``stream_xspace`` does; closes the writer."""
    return stream_xspace(x, writer, z0=mesh.rank * x.shape[3])


def reduce_stats(writer, mesh):
    """Replace this rank's output statistics by those of every rank (in
    place): an all-gather of each rank's ``stats_vector``."""
    t = torch.from_numpy(writer.stats_vector()).to(mesh.device)
    writer.merge_stats(torch.stack(mesh.all_gather(t)).cpu().numpy())
    return writer


def sharded_step(model, mesh, timers, kgrid=None):
    """This rank's x-space z-slab ``(narray, 2, Y, Zl, X)`` of the sharded
    step, timed in ``timers``' phases: the half route or the full grid
    (``Zeldovich.xspace_half_pair_sharded``), or with ``kgrid``, this
    rank's y-slab of a loaded k-space grid, its inverse transform alone."""
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda: None))
    if kgrid is None:
        with timers.phase("Mode synthesis (+ f_NL phi pass)"):
            model.sharded_fields(mesh)  # the half route's planes of this rank
            sync()
    with timers.phase("Inverse FFT"):
        # the half route (B1, exchange, B2), or the full grid with its phi
        # pass (B5, zx, exchange, y); zx, exchange, y of a loaded grid
        x = (model.xspace_half_pair_sharded(mesh) if kgrid is None
             else model.xspace_pair_sharded(mesh, kgrid))
        sync()
    return x


def run_multihost(model, mesh, timers, kgrid=None):
    """A multi-process run: the sharded step (``sharded_step``), each rank
    writing its own planes, the statistics reduced over the ranks.

    The caller has prepared the output directory on rank 0 and waited for
    it (``mesh.barrier()``, the counterpart of the JAX ``barrier``).
    Returns the reduced writer; rank 0 reports.
    """
    x = sharded_step(model, mesh, timers, kgrid)
    with timers.phase("Output"):
        writer = OutputWriter(model.param, parallel=mesh.world > 1)
        write_local_slabs(x, writer, mesh)
        del x
        mesh.barrier()
        reduce_stats(writer, mesh)
    return writer
