"""The comparison that decides ``correct``.

What the timed path produced, against the reference fields of the same
configuration and seed (the ``fields`` of the module the configuration
names, computed once the window has closed and taken one field at a time
as it yields them):

* ``ic_*`` files (jobs): every file the configuration names, at its size;
  every record's lattice index (i, j, k) = (z, y, x) exactly; its
  displacement and velocity (z, y, x components) against the reference's
  fields at that particle;
* x-space pairs (realizations): each array of the step's output
  (narray, 2, Y, Z, X), or of a rank's z-slab of it, against the field it
  holds.

Numbers, each per group of fields (density, displacement, velocity):
``gap`` = max |got - ref| / max |ref| and ``rms_gap`` = rms(got - ref) /
rms(ref), both in units of ``UNIT`` (2^-24, half a float32 step at 1):
the worst and the typical rounding of what was produced.  Over ranks, each
rank tallies what it holds and the ranks' maxima and sums are reduced
(``Tally.reduce``) before the numbers are formed.
"""

from __future__ import annotations

import numpy as np
import torch

UNIT = 2.0 ** -24

#: the output record of ICFormat RVZel (32 bytes: the lattice index as
#: three uint16, the displacement and velocity as float32, z y x order)
RVZEL = np.dtype({"names": ["i", "j", "k", "displ", "vel"],
                  "formats": ["<u2", "<u2", "<u2", "<3f4", "<3f4"],
                  "offsets": [0, 2, 4, 8, 20], "itemsize": 32})

GROUPS = {"density": ("density",),
          "disp": ("disp_x", "disp_y", "disp_z"),
          "vel": ("vel_x", "vel_y", "vel_z")}

#: x-space pair slot (array, re/im) of each field in the step's output:
#: the packed arrays are density + i disp_x, disp_y + i disp_z and, with
#: PLT, 0 + i vel_x, vel_y + i vel_z
PAIR_SLOTS = {"density": (0, 0), "disp_x": (0, 1), "disp_y": (1, 0),
              "disp_z": (1, 1), "vel_x": (2, 1), "vel_y": (3, 0), "vel_z": (3, 1)}


class Tally:
    """Running max |d|, sum d^2, max |ref|, sum ref^2 and count a group."""

    def __init__(self):
        self.v = {g: [0.0, 0.0, 0.0, 0.0, 0] for g in GROUPS}

    @staticmethod
    def stats(got: torch.Tensor, ref: torch.Tensor) -> tuple:
        """(max |d|, sum d^2, max |ref|, sum ref^2, count) of one pair."""
        d = (got.to(torch.float64) - ref.to(torch.float64))
        r = ref.to(torch.float64)
        return (d.abs().max().item(), (d * d).sum().item(), r.abs().max().item(),
                (r * r).sum().item(), d.numel())

    def merge(self, field: str, stats: tuple):
        g = next(k for k, names in GROUPS.items() if field in names)
        t = self.v[g]
        t[0] = max(t[0], stats[0])
        t[1] += stats[1]
        t[2] = max(t[2], stats[2])
        t[3] += stats[3]
        t[4] += stats[4]

    def add(self, field: str, got: torch.Tensor, ref: torch.Tensor):
        self.merge(field, self.stats(got, ref))

    def reduce(self, mesh, flag: int = 0) -> int:
        """Every rank's maxima and sums, on every rank (each must call it);
        returns the largest ``flag`` over the ranks."""
        import torch.distributed as dist

        rows = [self.v[g] for g in GROUPS]
        mx = torch.tensor([[t[0], t[2]] for t in rows] + [[float(flag), 0.0]],
                          dtype=torch.float64, device=mesh.device)
        sm = torch.tensor([[t[1], t[3], t[4]] for t in rows], dtype=torch.float64,
                          device=mesh.device)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.group)
        dist.all_reduce(sm, op=dist.ReduceOp.SUM, group=mesh.group)
        mx, sm = mx.tolist(), sm.tolist()
        for t, (dmax, rmax), (d2, r2, n) in zip(rows, mx, sm):
            t[:] = [dmax, d2, rmax, r2, int(n)]
        return int(mx[-1][0])

    def numbers(self) -> dict:
        out = {}
        for g, (dmax, d2, rmax, r2, n) in self.v.items():
            if not n:
                continue
            out[f"{g}_gap"] = dmax / rmax / UNIT if rmax else float("inf")
            out[f"{g}_rms_gap"] = (d2 / r2) ** 0.5 / UNIT if r2 else float("inf")
        return out


def slab_files(ppd: int, cpd: int):
    """(file number, first z, number of z planes) of every ic_ file: slab
    z goes to ic_{z cpd / ppd}, in ascending z."""
    files = {}
    for z in range(ppd):
        n = z * cpd // ppd
        z0, c = files.get(n, (z, 0))
        files[n] = (z0, c + 1)
    return [(n, z0, c) for n, (z0, c) in sorted(files.items())]


def check_files(outdir, ppd: int, cpd: int, fields, plt: bool, f_vel: float,
                device) -> dict:
    """Numbers of one job's ic_* files against the reference fields
    (``fields``: (name, (Y, Z, X) tensor on ``device``) one at a time).
    Without PLT the velocity is ``f_vel`` times the displacement.

    Every file is read once onto the device; each field's z planes are
    tallied as it comes, and the planes' sums are merged in the records'
    order (file, plane, z y x component, displacement before velocity)."""
    missing = bad_index = 0
    y = torch.arange(ppd, device=device)[:, None]
    x = torch.arange(ppd, device=device)[None, :]
    slabs = []  # (first z, z planes, their records' six float32 components)
    for n, z0, nz in slab_files(ppd, cpd):
        path = outdir / f"ic_{n}"
        want = nz * ppd * ppd * RVZEL.itemsize
        if not path.exists() or path.stat().st_size != want:
            missing += nz * ppd * ppd
            continue
        raw = np.fromfile(path, dtype=np.uint8)
        rec = torch.from_numpy(raw).to(device)
        # the record's bytes as uint16 indices and float32 components
        rec = rec.view(nz, ppd, ppd, RVZEL.itemsize)
        idx = rec[..., :6].contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        for dz in range(nz):
            z = z0 + dz
            bad_index += int(((idx[dz, :, :, 0] != z) | (idx[dz, :, :, 1] != y)
                              | (idx[dz, :, :, 2] != x)).sum().item())
        slabs.append((z0, nz, rec[..., 8:32].contiguous().view(torch.float32)))
        del rec, idx
    part = {}  # (z, component, 0 displacement / 1 velocity) -> Tally.stats
    for name, ref in fields:
        kind, c = name[:4], "zyx".find(name[-1])
        if kind == "disp" or (kind == "vel_" and plt):
            for z0, nz, vals in slabs:
                for dz in range(nz):
                    plane = ref[:, z0 + dz, :]
                    if kind == "disp":
                        part[z0 + dz, c, 0] = Tally.stats(vals[dz, :, :, c], plane)
                    if kind == "vel_" or not plt:
                        vel = plane if plt else plane * f_vel
                        part[z0 + dz, c, 1] = Tally.stats(vals[dz, :, :, 3 + c], vel)
        del ref
    tally = Tally()
    for z0, nz, _ in slabs:
        for z in range(z0, z0 + nz):
            for c, ax in enumerate("zyx"):
                tally.merge(f"disp_{ax}", part[z, c, 0])
                tally.merge(f"vel_{ax}", part[z, c, 1])
    return {"missing_particles": missing, "bad_indices": bad_index, **tally.numbers()}


def check_pairs(pairs, fields, ppd: int, zslab=None, mesh=None) -> dict:
    """Numbers of a step output (narray, 2, Y, Z, X), or of a rank's
    z-slab [z0, z1) of it (``zslab``, reduced over ``mesh``), against the
    reference fields; a zero slot (array 2's real part) counts as zero
    against the velocity group's scale."""
    z0, z1 = zslab or (0, ppd)
    tally = Tally()
    mismatch = int(tuple(pairs.shape[2:]) != (ppd, z1 - z0, ppd))
    dev = None
    if not mismatch:
        for name, ref in fields:
            a, c = PAIR_SLOTS[name]
            if a < pairs.shape[0]:
                dev = ref.device
                tally.add(name, pairs[a, c].to(dev), ref[:, z0:z1, :])
            del ref
        if pairs.shape[0] > 2:
            tally.add("vel_x", pairs[2, 0].to(dev),
                      torch.zeros(pairs.shape[2:], dtype=torch.float64, device=dev))
    if mesh is not None:
        mismatch = tally.reduce(mesh, mismatch)
    if mismatch:
        return {"shape_mismatch": 1}
    return {"shape_mismatch": 0, **tally.numbers()}


def sample_points(seed: int, shape, count: int, device):
    """``count`` flat indices into ``shape`` drawn from the seed."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    total = int(np.prod(shape))
    return torch.randint(0, total, (count,), generator=g).to(device)


def check_points(values, points, shape, fields, mesh=None) -> dict:
    """Numbers of sampled points (``values`` of the flat ``points`` of the
    step output of ``shape``, kept when the realization was consumed;
    over ``mesh`` each rank's points, reduced) against the reference
    fields."""
    tally = Tally()
    narray = shape[0]
    per = int(np.prod(shape[2:]))
    slot = points // per
    cell = points % per
    for name, ref in fields:
        a, c = PAIR_SLOTS[name]
        sel = slot == 2 * a + c
        if a < narray and sel.any():
            tally.add(name, values[sel], ref.reshape(-1)[cell[sel]])
        del ref
    if mesh is not None:
        tally.reduce(mesh)
    return tally.numbers()


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}) for the
    numbers that have a limit; a number with a limit that the run did not
    give fails."""
    shown, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and good
        shown[name] = {"value": v, "limit": limit}
    return ok, shown
