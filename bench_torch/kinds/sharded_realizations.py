"""Request kind ``sharded_realizations``, the collective twin of
``realizations``: on every rank of the run's mesh each request is
``Zeldovich(param with its seed, dtype)``, its static fields and
``.xspace_half_pair_sharded(mesh)`` through the model API (B1 on the
rank's ky planes, the exchange, B2 on its z-slab), in the same synced
harness ranges (``bench.setup_tables``, ``bench.static_fields``,
``bench.step``).  The consumer reads, on each rank, those of the
``POINTS`` points drawn from the run's seed over the whole output that lie
in the rank's z-slab, and lets the realization go; the last stays on the
device until the window has closed.  Nothing is written, and no output is
gathered.

End to end: ``mem_Mpart_s``, every particle of every realization (all the
ranks' slabs) over the window.  Check: on each rank its slab of the last
realization whole and its points of the sampled others against the same
region of the reference, reduced over the ranks.
"""

from __future__ import annotations

import checks
from mixes import load_kind

COLLECTIVE = True

realizations = load_kind("realizations")
POINTS = realizations.POINTS


def zslab(mix) -> tuple[int, int]:
    """This rank's z planes [z0, z1) of the step's output."""
    zl = mix.ppd // mix.mesh.world
    return mix.mesh.rank * zl, (mix.mesh.rank + 1) * zl


def local_points(points, shape, zslab):
    """Of the flat ``points`` into the whole output ``shape``, those in
    the z-slab, and their flat indices into the rank's slab."""
    _, _, Y, Z, X = shape
    z0, z1 = zslab
    slot, cell = points // (Y * Z * X), points % (Y * Z * X)
    y, z, x = cell // (Z * X), cell // X % Z, cell % X
    sel = (z >= z0) & (z < z1)
    local = ((slot * Y + y) * (z1 - z0) + z - z0) * X + x
    return points[sel], local[sel]


def warm_up(mix):
    """One realization at the cell's shapes, on every rank."""
    m = realizations.model(mix, 1)
    out = m.xspace_half_pair_sharded(mix.mesh)
    del out, m
    mix.points = None


def step(mix, r) -> bool:
    out = realizations.realize(mix, r, lambda m: m.xspace_half_pair_sharded(mix.mesh))
    shape = (out.shape[0], 2, mix.ppd, mix.ppd, mix.ppd)
    if mix.points is None:
        every = checks.sample_points(mix.seed, shape, POINTS, out.device)
        mix.points, mix.local = local_points(every, shape, zslab(mix))
    r["values"] = out.reshape(-1)[mix.local]  # the consumer's read
    r["shape"] = shape
    mix.held = (r, out)
    return True


def end_to_end(mix, window_s: float) -> dict:
    return realizations.end_to_end(mix, window_s)


def check(mix, r, fields) -> dict:
    if "whole" in r:
        return checks.check_pairs(r["whole"], fields, mix.ppd, zslab(mix), mix.mesh)
    return checks.check_points(r["values"], mix.points, r["shape"], fields, mix.mesh)
