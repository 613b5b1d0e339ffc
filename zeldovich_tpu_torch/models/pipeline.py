"""The in-core pipeline on one device.

Port of ``zeldovich_tpu/models/pipeline.py``: parameters -> P(k), M(k) and
RNG tables (setup) -> the cached static fields pk_eff and the PLT
coefficient planes -> the forward step -> streamed particle output + QA
report, all in the model's ``dtype`` (float32 or float64: every kernel
has an instance of each).  The forward step takes one of two routes:

* the half spectrum (``half_exact`` configurations).  At a ppd the FFT
  kernels take (a power of two in [16, 2048], ``fft_kernels_take``): B1
  (synthesis + packing + z/x transforms) and B2 (c2r along y), fused; at
  every other even ppd the separate route, JAX ``_half_pair_forward``
  without its mega kernel: B3 (synthesis + packing), the ky=0 fixup, then
  ``ifft3_half_pair`` on the matrix-product DFTs of ``ops/mmfft.py``.
  Through the model API ``kspace_half_pair`` -> ``xspace_half_pair(spm)``
  the separate route at any ppd (zx and B2 where the kernels take ppd);
* the full grid (f_NL, ZD_Version=1, CornerModes with k_cutoff != 1):
  B4 draws (every even ppd) -> ``synthesize_full_fast_pair`` ->
  ``ifft3_pair`` (B8 along y, B6/B7 over z and x where the kernels take
  ppd, the matrix products elsewhere), with the f_NL phi pass in front.

The sharded steps (``*_sharded(mesh)``, ``parallel/``) return this rank's
slab of the same grids over a mesh of ranks.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import plt as plt_ops
from ..ops.c2r import c2r_y
from ..ops.mmfft import fft3_pair, ifft3_half_pair, ifft3_pair
from ..ops.modes import SynthConfig, SynthTables
from ..ops.modes_real import (
    fix_ky0_packed, pk_effective, plt_coef_fields, synthesize_full_fast_pair,
)
from ..ops.synth import fft_kernels_take, halfspace_pack, halfspace_pack_zx
from ..utils.output import (  # noqa: F401 (output_dtype re-exported)
    OutputWriter, output_dtype, setup_output_dir,
)
from ..utils.params import Parameters
from ..utils.power import PowerSpectrum, mode_amplitude_tables
from ..utils.timers import span, tracing


def phi_nl(phi, f_NL: float, inv_n3: float):
    """In place on an x-space phi pair (..., 2, Y, Z, X) whose imaginary
    part is scratch: re = (phi + f_NL phi^2) * inv_n3, im = 0
    (zeldovich.cpp:749-759; the transforms are unnormalized, so the round
    trip's 1/ppd^3 is folded in here)."""
    x, t = phi.select(-4, 0), phi.select(-4, 1)
    torch.mul(x, f_NL, out=t)
    t.mul_(x)
    t.add_(x)
    t.mul_(inv_n3)
    x.copy_(t)
    t.zero_()
    return phi


class Zeldovich:
    """Parameters -> displacement/velocity fields on ``device``."""

    def __init__(self, param: Parameters, dtype=torch.float64, device="cuda"):
        """The set-up tables, each part a span: ``setup.power`` (P(k) and
        the mode amplitudes), ``setup.eigmodes`` (the PLT table read),
        ``setup.rng_tables`` (``SynthTables.build``)."""
        self.param = param
        self.dtype = dtype
        self.device = torch.device(device)
        with span("setup.power"):
            self.Pk = PowerSpectrum(param)
            pk_n2, M_n2 = mode_amplitude_tables(self.Pk, param)
        self.cfg = SynthConfig.from_params(param, self.Pk.fixed_power)
        eig = None
        if param.qPLT:
            print("Using PLT eigenmodes.", file=sys.stderr)
            with span("setup.eigmodes"):
                eig = plt_ops.load_eigmodes(param.resolve_path(param.PLT_filename))
        with span("setup.rng_tables"):
            self.tables = SynthTables.build(
                param.seed, param.ppd, pk_n2, M_n2=M_n2, eig=eig, device=self.device
            )
        self._D_source = None
        if param.version == 1:
            # the legacy MT19937 stream, generated on the host
            from ..ops import v1

            D = v1.generate_D_half(param, self.Pk, pk_n2)
            self._D_source = torch.from_numpy(
                np.stack([D.real, D.imag])).to(self.device, dtype)
        self._pk_eff = None
        self._plt_coefs = None
        self._rank_fields = (None, None, None)  # (planes, pk_eff, plt_coefs)

    @property
    def half_exact(self) -> bool:
        """Whether the half-spectrum form reproduces the full grid.

        False for f_NL (the input-phi pass repopulates Nyquist modes),
        CornerModes with k_cutoff != 1 (self-conjugate lines draw
        independent modes) and ZD_Version=1 (host-generated phases).
        """
        p = self.param
        return (
            p.f_NL == 0
            and p.version == 2
            and not (p.CornerModes and p.k_cutoff != 1)
        )

    @property
    def pk_eff(self):
        """Cached static amplitude field (setup work)."""
        if self._pk_eff is None:
            self._pk_eff = pk_effective(self.cfg, self.tables, self.dtype)
        return self._pk_eff

    @property
    def plt_coefs(self):
        """Cached (4, half, Z, X) PLT coefficient planes; None unless qPLT."""
        if not self.param.qPLT:
            return None
        if self._plt_coefs is None:
            self._plt_coefs = self._plt_coef_fields()
        return self._plt_coefs

    def _plt_coef_fields(self, rows=None):
        """``plt_coef_fields`` of the planes ``rows`` (all where None) in
        the span ``static.plt_coefs``: while a profiler runs it synchronizes
        the device at its close, so that its length is the planes' time;
        with none running nothing waits."""
        with span("static.plt_coefs"):
            coefs = plt_coef_fields(self.cfg, self.tables, self.dtype, rows=rows)
            if tracing() and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return coefs

    def kspace_half_pair(self):
        """The packed half spectrum (narray, 2, 2, half+1, Z, X): kernel B3
        (every even ppd) and the ky=0 fixup.  Only for ``half_exact``
        configurations."""
        if not self.half_exact:
            raise NotImplementedError(
                "non-Hermitian configuration uses the full-grid pair path")
        spm = halfspace_pack(self.cfg, self.tables, self.pk_eff, self.plt_coefs)
        return fix_ky0_packed(spm)

    def xspace_half_pair(self, spm=None):
        """The forward step: (narray, 2, Y, Z, X) x-space real pairs.

        Without ``spm``: where the FFT kernels take ppd, the fused route
        (B1, then B2 in place on B1's output); elsewhere the separate
        route, ``kspace_half_pair`` and ``ifft3_half_pair`` on the matrix
        products, its z/x pass in place (the spectrum and the output, no
        third grid).  It falls back to the full-grid path for the
        configurations the half spectrum cannot represent, as the JAX
        package does.  With ``spm`` (from ``kspace_half_pair``), the
        separate route on it: ``ifft3_half_pair``, spm left as it is.
        """
        if spm is not None:
            return ifft3_half_pair(spm)
        if not self.half_exact:
            return self.xspace_pair()
        if not fft_kernels_take(self.cfg.ppd):
            return ifft3_half_pair(self.kspace_half_pair(), overwrite=True)
        g = halfspace_pack_zx(self.cfg, self.tables, self.pk_eff, self.plt_coefs)
        return c2r_y(g, self.cfg.ppd, out=g)  # in place: one grid

    # -- the full-grid pair path ---------------------------------------
    # ``plain=True`` runs the plain versions of B4 and the transforms on
    # any device: the route the kernels are held against on the card.
    def phi_pass(self, plain: bool = False):
        """f_NL input pass: phi(k) -> x space -> (phi + f_NL phi^2) / ppd^3
        -> k space; returns the (2, Y, Z, X) phi(k) pair.

        The inverse transform is unnormalized, so the round trip's 1/ppd^3
        is folded into the non-linear map (zeldovich.cpp:749-759).  All in
        place on one full grid; its imaginary plane is the scratch.
        """
        p = self.param
        phi = synthesize_full_fast_pair(
            self.cfg, self.tables, self.dtype, gen_phi=True, pk_eff=self.pk_eff,
            D_source=self._D_source, plain=plain,
        )[0]
        ifft3_pair(phi, out=phi, plain=plain)
        phi_nl(phi, p.f_NL, 1.0 / p.ppd**3)
        return fft3_pair(phi, out=phi, plain=plain)

    def kspace_pair(self, plain: bool = False):
        """Packed k-space arrays as real pairs: (narray, 2, Y, Z, X)."""
        phi = self.phi_pass(plain) if self.param.f_NL != 0 else None
        return synthesize_full_fast_pair(
            self.cfg, self.tables, self.dtype, phi_pair=phi, pk_eff=self.pk_eff,
            D_source=self._D_source, plt_coefs=self.plt_coefs, plain=plain,
        )

    def xspace_pair(self, kpair=None, plain: bool = False):
        """Full-grid forward step: (narray, 2, Y, Z, X), transformed in
        place; of ``kpair`` (a loaded PART1 grid) when given."""
        k = self.kspace_pair(plain) if kpair is None else kpair
        return ifft3_pair(k, out=k, plain=plain)

    # -- sharded phases (a mesh of ranks, parallel/) --------------------
    def check_sharded(self, mesh):
        """Raise where the sharded steps cannot run this configuration on
        ``mesh``: NotImplementedError for ZD_Version=1 (host-generated, no
        sharded path), ValueError where the ranks do not divide ppd."""
        from ..parallel.pencil_mmfft import check_grid

        if self._D_source is not None:
            raise NotImplementedError(
                "ZD_Version=1 is host-generated; use the single-host "
                "complex pipeline"
            )
        check_grid(self.cfg.ppd, mesh)

    def kspace_pair_sharded(self, mesh):
        """This rank's y-slab [r Yl, (r+1) Yl) of the full k-grid,
        ``(narray, 2, Yl, Z, X)``, Yl = ppd / world: B5 at the slab's
        source modes, after the f_NL phi pass where f_NL != 0."""
        from ..parallel.pencil_mmfft import fft3_pair_sharded, ifft3_pair_sharded
        from ..parallel.synthesis import synthesize_sharded_pair

        self.check_sharded(mesh)
        p = self.param
        phi = None
        if p.f_NL != 0:
            phi = synthesize_sharded_pair(self.cfg, self.tables, self.dtype, mesh,
                                          gen_phi=True)
            phi = ifft3_pair_sharded(phi, mesh)
            phi_nl(phi, p.f_NL, 1.0 / p.ppd**3)
            phi = fft3_pair_sharded(phi, mesh)[0]
        return synthesize_sharded_pair(self.cfg, self.tables, self.dtype, mesh,
                                       phi_pair=phi)

    def xspace_pair_sharded(self, mesh, kpair=None):
        """The full-grid forward step over ``mesh``: this rank's z-slab
        ``(narray, 2, Y, Zl, X)`` of x space, Zl = ppd / world, from its
        y-slab of ``kpair`` (``kspace_pair_sharded``'s, made when not
        given; transformed in place)."""
        from ..parallel.pencil_mmfft import ifft3_pair_sharded

        k = self.kspace_pair_sharded(mesh) if kpair is None else kpair
        return ifft3_pair_sharded(k, mesh)

    def half_route_sharded(self) -> bool:
        """Whether the sharded step takes the half route (B1, B2): a
        ``half_exact`` configuration at a ppd the FFT kernels take."""
        return self.half_exact and fft_kernels_take(self.cfg.ppd)

    def sharded_fields(self, mesh):
        """(pk_eff, plt_coefs) of this rank's generated planes on the half
        route, cached ((None, None) where it has none); None on the full
        grid.  The PLT planes are the span ``static.plt_coefs``, as on one
        device."""
        from ..parallel.pencil_mmfft import ky_planes

        if not self.half_route_sharded():
            return None
        rows = ky_planes(self.cfg.ppd, mesh)
        if rows == (0, self.cfg.ppd // 2):
            return self.pk_eff, self.plt_coefs
        if self._rank_fields[0] != rows:
            pk = coefs = None
            if rows[1] > rows[0]:
                pk = pk_effective(self.cfg, self.tables, self.dtype, rows=rows)
                if self.param.qPLT:
                    coefs = self._plt_coef_fields(rows)
            self._rank_fields = (rows, pk, coefs)
        return self._rank_fields[1:]

    def xspace_half_pair_sharded(self, mesh):
        """The sharded forward step: this rank's z-slab
        ``(narray, 2, Y, Zl, X)`` of x space, Zl = ppd / world.

        The half route (B1 on the rank's ky planes, one exchange, B2 on
        its z-slab) where ``half_route_sharded``; elsewhere the full grid
        (``xspace_pair_sharded``: B5, zx, the exchange, y), as the JAX
        package falls back for the configurations the half spectrum cannot
        represent.  ZD_Version=1 has no sharded path (host-generated).
        """
        from ..parallel.pencil_mmfft import xspace_half_pair_sharded

        self.check_sharded(mesh)
        if not self.half_route_sharded():
            return self.xspace_pair_sharded(mesh)
        pk, coefs = self.sharded_fields(mesh)
        return xspace_half_pair_sharded(self.cfg, self.tables, pk, coefs, mesh,
                                        self.dtype)

    def run_pair(self, setup_dir: bool = True) -> OutputWriter:
        """Full run: forward step, streamed output, QA report."""
        from ..utils.streamio import stream_xspace

        p = self.param
        if setup_dir:
            setup_output_dir(p)
        writer = OutputWriter(p)
        stream_xspace(self.xspace_half_pair(), writer)
        writer.report(self.Pk)
        return writer
