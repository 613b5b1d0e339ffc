"""Out-of-core pipeline on one device: grids larger than device memory.

Port of the single-device pair form of
``zeldovich_tpu/models/outofcore.py::OutOfCoreZeldovich`` (the analog of
the reference's ``-DDISK`` mode).  The full ``(narray, 2, Y, Z, X)`` grid
lives in a host staging buffer (RAM, or an ``np.memmap`` for grids beyond
RAM) and the device streams slabs through the kernels:

  pass 1 (y-slabs):  ``synthesize_pair`` (B5 draws at each mode's source
                     index) -> the z/x DFT(+1) in place -> stage;
  pass 2 (z-slabs):  stage -> the y DFT(+1) in place -> particle writer.

f_NL adds a phi round trip through a second stage of one array: the
generation pass (gen_phi), then the y DFT(+1), the non-linear map and the
y DFT(-1) of (phi, 0) on z-slabs, then the z/x DFT(-1) on y-slabs; pass 1
reads each slab's phi(k) at the same and the reflected indices.

The slab DFTs are routed by ppd as in core (``ops/mmfft.py``: ``dft_zx``,
``dft_y``): the kernels zx_dft (B6/B7) and y_dft (B8) at a power of two
in [16, 2048], the matrix products at every other even ppd (1728, 4096,
...), as JAX ``models/outofcore.py`` falls back to ``mmfft.cfft_axis``.
B5 draws at every even ppd.

Every slab, in the generated half, across ppd/2 or in the mirror half,
takes the general source-index synthesis: the JAX package's identity
fast path for slabs (``synthesize_slab_pair_identity``) is wrong outside
rows [0, ppd/2) (ROADMAP C1) and is not ported.

The stage layout ``(narray, 2, ppd, ppd, ppd)`` in the run's element type
(float32 or float64) is byte for byte the JAX pair stage of that type, so
either package resumes the other's pair PART1 stage.  The port writes a
meta file (layout, shape, dtype) beside its PART1 stage and resumes only a
stage that matches the run (``check_stage``); a stage without one (the
JAX package writes none) must have the run's size and the zero y-Nyquist
planes of every pair stage, so the JAX CLI's complex ``(narray, Y, Z, X)``
stage, which has the byte count of a float64 pair stage, is refused.
Each streaming loop runs one slab ahead (utils/streamio.py), and pass 2
reaches the ic_* writer through ``streamio.write_zslabs``.  Pass 1 is the
span ``ooc.pass1``, each write into a stage ``stage.sink``
(``utils/timers.py``).

The passes are written once, over the grid rows [_row0, _row1) that the
stage holds and its z-slabs on the device (``_zslabs``).
``DistributedOutOfCore`` (``--sharded``/``--distributed --out-of-core``)
changes what a mesh changes: its rows (a y-slab), ``_zslabs`` (one
exchange a z-block, ``parallel/outofcore.py``) and the phi pass's way
back, the reflected phi rows, its stage files and its output.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.mmfft import dft_y, dft_zx
from ..ops.modes_real import _reflect_zx, synthesize_pair
from ..parallel.multihost import reduce_stats
from ..parallel.outofcore import rows_from_zslab, zblocks, zslab_from_rows
from ..parallel.pencil_mmfft import slab as rank_rows
from ..parallel.synthesis import reflected_exchange
from ..utils.output import OutputWriter, setup_output_dir
from ..utils.streamio import slabs_to_device, stream_to_host, write_zslabs
from ..utils.timers import span
from .pipeline import Zeldovich, phi_nl


class StageMismatch(ValueError):
    """A PART1 stage that this run cannot resume."""


def _meta_path(path) -> Path:
    path = Path(path)
    return path.with_name(path.name + ".meta.json")


def _ysel(y0, ny):
    return (slice(None), slice(None), slice(y0, y0 + ny))


def _zsel(z0, nz):
    return (slice(None), slice(None), slice(None), slice(z0, z0 + nz))


def _stage_sink(stage, at=lambda key: key):
    """A sink that writes its host slab into ``stage[at(key)]``: the span
    ``stage.sink``."""
    def sink(key, h):
        with span("stage.sink"):
            stage[at(key)] = h
    return sink


class OutOfCoreZeldovich(Zeldovich):
    """Streamed pipeline with a host-resident (or disk-memmapped) grid."""

    def __init__(self, param, dtype=torch.float64, slab_bytes=2 << 30,
                 backing: str = "ram", device="cuda"):
        super().__init__(param, dtype=dtype, device=device)
        if backing not in ("ram", "disk"):
            raise ValueError(f"backing must be 'ram' or 'disk', got {backing!r}")
        self.backing = backing
        self._fnp = np.float64 if dtype == torch.float64 else np.float32
        #: the grid rows the stage holds (a rank's y-slab on a mesh)
        self._row0, self._row1 = 0, param.ppd
        self._cut_slabs(slab_bytes)

    def _cut_slabs(self, slab_bytes):
        """slab: the largest divisor of the stage's rows within slab_bytes."""
        p, rows = self.param, self._row1 - self._row0
        row = p.ppd * p.ppd * p.narray * 2 * np.dtype(self._fnp).itemsize
        self.slab = max(1, min(rows, slab_bytes // row))
        while rows % self.slab:
            self.slab -= 1

    # -- staging buffer -------------------------------------------------
    def stage_layout(self, narray=None):
        """(shape, numpy dtype) of the host staging buffer."""
        p = self.param
        narray = p.narray if narray is None else narray
        return (narray, 2, self._row1 - self._row0, p.ppd, p.ppd), self._fnp

    def _stage_meta(self) -> dict:
        shape, dtype = self.stage_layout()
        return {"layout": "pair", "shape": list(shape), "dtype": np.dtype(dtype).name}

    def check_stage(self, path):
        """Raise StageMismatch unless ``path`` is a PART1 stage of this run:
        its meta file's layout, shape and dtype are the run's and the file
        has their size; or, with no meta file, the file has the size of
        the run's pair stage and its y-Nyquist planes are zero, as every
        pair stage's are (a complex stage read as pairs has values there);
        that stage is taken as the pair layout, and one stderr line says so."""
        path = Path(path)
        want = self._stage_meta()
        nbytes = int(np.prod(want["shape"])) * np.dtype(want["dtype"]).itemsize
        layout = f"pair {want['dtype']} {tuple(want['shape'])} ({nbytes} bytes)"
        if not path.exists():
            raise StageMismatch(f"no PART1 stage at {path}")
        size = path.stat().st_size
        meta = _meta_path(path)
        if meta.exists():
            got = json.loads(meta.read_text())
            if got != want:
                raise StageMismatch(
                    f"stage {path} holds {got.get('layout')} {got.get('dtype')} "
                    f"{tuple(got.get('shape', ()))} but this run expects {layout}")
            if size != nbytes:
                raise StageMismatch(f"stage {path} is {size} bytes, want {layout}")
            return
        if size != nbytes:
            raise StageMismatch(f"stage {path} has no meta file and is {size} bytes, "
                                f"but this run expects {layout}")
        shape, dtype = self.stage_layout()
        nyq = np.memmap(path, dtype=dtype, mode="r", shape=shape)[:, :, shape[2] // 2]
        if nyq.any():
            raise StageMismatch(
                f"stage {path} has no meta file and is not the {layout} stage this "
                "run expects: its y-Nyquist planes are not zero (a complex (narray, "
                "Y, Z, X) stage of the JAX package has the byte count of a float64 "
                "pair stage)")
        print(f"stage {path} has no meta file: assumed to be the {layout} of this run",
              file=sys.stderr)

    def stage_memmap(self, path, mode="w+"):
        """Disk-backed staging buffer at ``path`` (the PART1/2 checkpoint):
        "w+" writes its meta file beside it, "r" checks it (check_stage)."""
        shape, dtype = self.stage_layout()
        if mode == "w+":
            _meta_path(path).write_text(json.dumps(self._stage_meta()))
        else:
            self.check_stage(path)
        return np.memmap(path, dtype=dtype, mode=mode, shape=shape)

    def cleanup_stage_memmap(self, path):
        Path(path).unlink(missing_ok=True)
        _meta_path(path).unlink(missing_ok=True)

    def _stage_file(self, name) -> Path:
        """The disk stage ``name`` (--backing disk) in the output directory."""
        return self.param.output_path / f"{name}.mm"

    def _alloc_stage(self, narray, name="zeldovich.stage"):
        shape, dtype = self.stage_layout(narray)
        if self.backing == "disk":
            path = self._stage_file(name)
            path.parent.mkdir(parents=True, exist_ok=True)
            return np.memmap(path, dtype=dtype, mode="w+", shape=shape)
        return np.empty(shape, dtype=dtype)

    def _y_sink(self, stage):
        return _stage_sink(stage, lambda y0: _ysel(y0 - self._row0, self.slab))

    def _slab_starts(self):
        """The stage's y-slabs (pass 1) by their first grid row."""
        return range(self._row0, self._row1, self.slab)

    def _zslabs(self, stage, fn):
        """(z0, fn(z-slab [z0, z0+slab) on the device)) for each z-slab of
        the stage, the slab after next already on its way."""
        keys = [_zsel(z0, self.slab) for z0 in self._slab_starts()]
        for sel, z in slabs_to_device(keys, stage.__getitem__, self.device):
            yield sel[3].start, fn(z)

    def _from_zslab(self, z):
        """The phi pass's way back from a z-slab to what ``_z_sink`` takes."""
        return z

    def _z_sink(self, stage):
        return _stage_sink(stage, lambda z0: _zsel(z0, self.slab))

    def _pass1_slab(self, y0, gen_phi=False, phi_pair=None):
        """Synthesize the y-slab [y0, y0+slab) and transform z and x."""
        k = synthesize_pair(y0, self.slab, self.cfg, self.tables, self.dtype,
                            gen_phi=gen_phi, phi_pair=phi_pair,
                            D_source=self._D_source)
        return dft_zx(k, +1, out=k)

    # -- phi round trip -------------------------------------------------
    def _phi_stage(self):
        """phi(k) of the stage's rows, (1, 2, rows, Z, X), in a host stage."""
        p = self.param
        stage = self._alloc_stage(1, "zeldovich.phi")
        stream_to_host(((y0, self._pass1_slab(y0, gen_phi=True))
                        for y0 in self._slab_starts()), self._y_sink(stage))
        inv_n3 = 1.0 / p.ppd**3

        def fwd_y_phi_nl(z):
            dft_y(z, +1, out=z)
            return self._from_zslab(dft_y(phi_nl(z, p.f_NL, inv_n3), -1, out=z))

        stream_to_host(self._zslabs(stage, fwd_y_phi_nl), self._z_sink(stage))
        ykeys = [_ysel(y0 - self._row0, self.slab) for y0 in self._slab_starts()]
        stream_to_host(((sel, dft_zx(y, -1, out=y)) for sel, y in slabs_to_device(
            ykeys, stage.__getitem__, self.device)), _stage_sink(stage))
        return stage

    def _phi_pairs(self, phi_stage):
        """(y0, ((same_re, same_im), (refl_re, refl_im))) for each y-slab
        [y0, y0+slab): phi(k) on the device at (y, z, x) and at the
        reflected index ((-y, -z, -x) mod ppd).  Both row blocks come
        through ``slabs_to_device``, so the host gather of a slab's blocks
        overlaps the device's work on the slab before."""
        p = self.param

        def rows(key):
            y0, reflected = key
            if not reflected:
                return phi_stage[0, :, y0:y0 + self.slab]
            return phi_stage[0][:, (p.ppd - np.arange(y0, y0 + self.slab)) % p.ppd]

        keys = [(y0, r) for y0 in self._slab_starts() for r in (False, True)]
        blocks = slabs_to_device(keys, rows, self.device)
        for (y0, _), same in blocks:
            _, refl = next(blocks)
            refl = _reflect_zx(refl)
            yield y0, ((same[0], same[1]), (refl[0], refl[1]))

    # -- main passes ----------------------------------------------------
    def stage_pass1(self, stage=None):
        """Pass 1: synthesis + z/x inverse DFTs of every y-slab, staged to
        the host as (narray, 2, y, z, x): the span ``ooc.pass1``."""
        p = self.param
        with span("ooc.pass1"):
            phi_stage = self._phi_stage() if p.f_NL != 0 else None
            if stage is None:
                stage = self._alloc_stage(p.narray)

            phis = (((y0, None) for y0 in self._slab_starts()) if phi_stage is None
                    else self._phi_pairs(phi_stage))
            stream_to_host(((y0, self._pass1_slab(y0, phi_pair=phi)) for y0, phi in phis),
                           self._y_sink(stage))
            if phi_stage is not None and self.backing == "disk":
                # the consumed phi stage (1/narray of the main stage) must
                # not outlive the pass
                self._stage_file("zeldovich.phi").unlink(missing_ok=True)
        return stage

    def pass2(self, stage):
        """(z0, x-space z-slab on the device) for each z-slab of the stage:
        the y DFT(+1) in place."""
        return self._zslabs(stage, lambda z: dft_y(z, +1, out=z))

    def _setup_dir(self):
        setup_output_dir(self.param)

    def _writer(self) -> OutputWriter:
        return OutputWriter(self.param)

    def _finish(self, writer):
        writer.report(self.Pk)

    def run(self, setup_dir: bool = True, stage=None) -> OutputWriter:
        """Pass 2 over a stage (pass 1 first when none is given): the y
        inverse DFT of every z-slab, streamed through the writer."""
        if setup_dir:
            self._setup_dir()
        own_stage = stage is None
        if own_stage:
            stage = self.stage_pass1()
        writer = write_zslabs(self.pass2(stage), self._writer())
        if own_stage and self.backing == "disk":
            # the run completed: reclaim the stage (the reference's
            # quickdelete of consumed block files); a crash leaves it on
            # disk as the resume point
            del stage
            self._stage_file("zeldovich.stage").unlink(missing_ok=True)
        self._finish(writer)
        return writer


class DistributedOutOfCore(OutOfCoreZeldovich):
    """Out of core over a mesh of ranks, each staging 1/W of the grid.

    Counterpart of ``zeldovich_tpu/models/outofcore.py::DistributedOutOfCore``
    (:255), with the stage split along y instead of x
    (``parallel/outofcore.py``): rank r stages rows [r Yl, (r+1) Yl),
    Yl = ppd / W, in host RAM or (``backing="disk"``) in
    ``zeldovich.stage.p{r}.mm``.

      pass 1 (the rank's y-slabs): the one-device pass 1, synthesis (B5)
                                   and the z/x DFT(+1), no collective;
      pass 2 (z-blocks, lockstep): the rank's rows of every rank's block to
                                   the card, one exchange to its z-slab,
                                   the y DFT(+1), its own planes pwritten
                                   by its own writer.

    f_NL runs the phi round trip through a per-rank phi stage the same way
    (the z-block pass exchanges there and back), and pass 1 takes the
    reflected rows (n - y) mod n of each slab from the ranks that hold
    them with one uneven all-to-all (``parallel/synthesis.py``).  Every
    slab's arithmetic is the one-device out-of-core run's, so the ic_*
    bytes are that run's.  The slab thickness is a divisor of Yl, so every
    rank takes the same number of steps.  The ``--part 1`` stage is
    ``zeldovich.kspace.mm.p{r}`` with a meta file (shape, dtype, world, y
    range); a restart with another world size is refused.
    """

    def __init__(self, param, mesh, dtype=torch.float64, slab_bytes=2 << 30,
                 backing: str = "ram"):
        super().__init__(param, dtype=dtype, slab_bytes=slab_bytes, backing=backing,
                         device=mesh.device)
        self.check_sharded(mesh)  # ZD_Version=1, ranks that do not divide ppd
        self.mesh = mesh
        self._row0, self._row1 = rank_rows(param.ppd, mesh)
        self._cut_slabs(slab_bytes)

    def _stage_meta(self) -> dict:
        return {**super()._stage_meta(), "layout": "pair y-slab",
                "world": self.mesh.world, "y_range": [self._row0, self._row1]}

    def _rank_path(self, path) -> Path:
        path = Path(path)
        return path.with_name(f"{path.name}.p{self.mesh.rank}")

    def check_stage(self, path):
        """Raise StageMismatch unless this rank's ``path``.p{rank} and its
        meta file are a stage checkpoint of this run: its world size, y
        range, shape and dtype."""
        mm = self._rank_path(path)
        want = self._stage_meta()
        try:
            got = json.loads(_meta_path(mm).read_text())
        except (OSError, ValueError) as e:
            raise StageMismatch(f"no stage checkpoint for rank {self.mesh.rank} "
                                f"at {mm}: {e}") from None
        if got != want:
            raise StageMismatch(
                f"stage checkpoint {mm} was cut for world {got.get('world')}, y range "
                f"{got.get('y_range')}, {got.get('dtype')} {got.get('shape')}, but "
                f"this run is world {want['world']}, y range {want['y_range']}, "
                f"{want['dtype']} {want['shape']}")
        shape, dtype = self.stage_layout()
        if mm.stat().st_size != int(np.prod(shape)) * np.dtype(dtype).itemsize:
            raise StageMismatch(f"stage checkpoint {mm} is {mm.stat().st_size} bytes, "
                                f"want {want}")

    def stage_memmap(self, path, mode="w+"):
        """This rank's disk stage ``path``.p{rank}; "r" checks it on every
        rank, and every rank raises if any rank's does not match."""
        mm = self._rank_path(path)
        err = None
        if mode != "w+":
            try:
                self.check_stage(path)
            except StageMismatch as e:
                err = e
            if not self.mesh.agree(err is None):
                raise err or StageMismatch(
                    f"stage checkpoint {path}: another rank's does not match this run")
            shape, dtype = self.stage_layout()
            return np.memmap(mm, dtype=dtype, mode=mode, shape=shape)
        return super().stage_memmap(mm, mode)

    def cleanup_stage_memmap(self, path):
        super().cleanup_stage_memmap(self._rank_path(path))

    def _stage_file(self, name) -> Path:
        return self.param.output_path / f"{name}.p{self.mesh.rank}.mm"

    def _zslabs(self, stage, fn):
        """(z0, fn(this rank's z-slab)) for each lockstep z-block: its rows
        of every rank's block to the device, one exchange."""
        w = self.mesh.world
        for j, rows in slabs_to_device(range((self._row1 - self._row0) // self.slab),
                                       lambda j: zblocks(stage, j, self.slab, w),
                                       self.device):
            yield self._row0 + j * self.slab, fn(zslab_from_rows(rows, self.mesh))

    # -- phi round trip -------------------------------------------------
    def _from_zslab(self, z):
        """The way back: this rank's rows of every rank's z-block."""
        return rows_from_zslab(z, self.mesh)

    def _z_sink(self, stage):
        def sink(z0, h):
            j = (z0 - self._row0) // self.slab
            zblocks(stage, j, self.slab, self.mesh.world)[...] = h
        return sink

    def _phi_pairs(self, phi_stage):
        """(y0, ((same_re, same_im), (refl_re, refl_im))) for each of the
        rank's y-slabs: phi(k) at (y, z, x) from its own stage, and at
        ((-y, -z, -x) mod ppd) from the ranks that hold the rows (n - y)
        mod n, by one uneven all-to-all a slab."""
        p, ny = self.param, self.slab
        yl = self._row1 - self._row0

        def take(rows):
            h = np.ascontiguousarray(phi_stage[0][:, rows].swapaxes(0, 1))
            return torch.from_numpy(h).to(self.device)

        for i, y0 in enumerate(self._slab_starts()):
            y0l = y0 - self._row0
            same = torch.from_numpy(np.array(phi_stage[0, :, y0l:y0l + ny])).to(self.device)
            refl = _reflect_zx(reflected_exchange(
                take, lambda r: range(r * yl + i * ny, r * yl + (i + 1) * ny), yl,
                (p.ppd, p.ppd), self.mesh, self.dtype, self.device))
            yield y0, ((same[0], same[1]), (refl[0], refl[1]))

    # -- the run ---------------------------------------------------------
    def _setup_dir(self):
        if self.mesh.rank == 0:
            setup_output_dir(self.param)
        self.mesh.barrier()

    def _writer(self) -> OutputWriter:
        return OutputWriter(self.param, parallel=self.mesh.world > 1)

    def _finish(self, writer):
        self.mesh.barrier()
        reduce_stats(writer, self.mesh)
        if self.mesh.rank == 0:
            writer.report(self.Pk)
