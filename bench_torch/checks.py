"""The comparison that decides ``correct``.

What the timed path produced, against ``reference.fields`` of the same
configuration and seed, computed once the window has closed:

* ``ic_*`` files (jobs): every file the configuration names, at its size;
  every record's lattice index (i, j, k) = (z, y, x) exactly; its
  displacement and velocity (z, y, x components) against the reference's
  fields at that particle;
* x-space pairs (realizations): each array of the step's output
  (narray, 2, Y, Z, X) against the field it holds.

Numbers, each per group of fields (density, displacement, velocity):
``gap`` = max |got - ref| / max |ref| and ``rms_gap`` = rms(got - ref) /
rms(ref), both in units of ``UNIT`` (2^-24, half a float32 step at 1):
the worst and the typical rounding of what was produced.
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
    """Running max |d|, sum d^2, max |ref| and sum ref^2 a group."""

    def __init__(self):
        self.v = {g: [0.0, 0.0, 0.0, 0.0, 0] for g in GROUPS}

    def add(self, field: str, got: torch.Tensor, ref: torch.Tensor):
        g = next(k for k, names in GROUPS.items() if field in names)
        d = (got.to(torch.float64) - ref.to(torch.float64))
        r = ref.to(torch.float64)
        t = self.v[g]
        t[0] = max(t[0], d.abs().max().item())
        t[1] += (d * d).sum().item()
        t[2] = max(t[2], r.abs().max().item())
        t[3] += (r * r).sum().item()
        t[4] += d.numel()

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


def check_files(outdir, ppd: int, cpd: int, ref: dict, plt: bool, f_vel: float,
                device) -> dict:
    """Numbers of one job's ic_* files against the reference fields
    (``ref``: FIELDS -> (Y, Z, X) on ``device``).  Without PLT the
    velocity is ``f_vel`` times the displacement."""
    tally = Tally()
    missing = bad_index = 0
    y = torch.arange(ppd, device=device)[:, None]
    x = torch.arange(ppd, device=device)[None, :]
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
        vals = rec[..., 8:32].contiguous().view(torch.float32)
        for dz in range(nz):
            z = z0 + dz
            bad_index += int(((idx[dz, :, :, 0] != z) | (idx[dz, :, :, 1] != y)
                              | (idx[dz, :, :, 2] != x)).sum().item())
            for c, ax in enumerate("zyx"):
                disp = ref[f"disp_{ax}"][:, z, :]
                tally.add(f"disp_{ax}", vals[dz, :, :, c], disp)
                vel = ref[f"vel_{ax}"][:, z, :] if plt else disp * f_vel
                tally.add(f"vel_{ax}", vals[dz, :, :, 3 + c], vel)
        del rec, idx, vals
    return {"missing_particles": missing, "bad_indices": bad_index, **tally.numbers()}


def check_pairs(pairs, ref: dict) -> dict:
    """Numbers of a whole step output (narray, 2, Y, Z, X) against the
    reference fields; a zero slot (array 2's real part) counts as zero
    against the velocity group's scale."""
    tally = Tally()
    if tuple(pairs.shape[2:]) != tuple(ref["density"].shape):
        return {"shape_mismatch": 1}
    for name, (a, c) in PAIR_SLOTS.items():
        if name in ref:
            tally.add(name, pairs[a, c].to(ref[name].device), ref[name])
    if pairs.shape[0] > 2:
        tally.add("vel_x", pairs[2, 0].to(ref["vel_x"].device), torch.zeros_like(ref["vel_x"]))
    return {"shape_mismatch": 0, **tally.numbers()}


def sample_points(seed: int, shape, count: int, device):
    """``count`` flat indices into ``shape`` drawn from the seed."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    total = int(np.prod(shape))
    return torch.randint(0, total, (count,), generator=g).to(device)


def check_points(values, points, shape, ref: dict) -> dict:
    """Numbers of sampled points (``values`` of the flat ``points`` of the
    step output, kept when the realization was consumed) against the
    reference fields."""
    tally = Tally()
    narray = shape[0]
    flat = {name: ref[name].reshape(-1) for name in ref}
    per = int(np.prod(shape[2:]))
    slot = points // per
    cell = points % per
    for name, (a, c) in PAIR_SLOTS.items():
        if name not in ref or a >= narray:
            continue
        sel = slot == 2 * a + c
        if sel.any():
            tally.add(name, values[sel], flat[name][cell[sel]])
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
