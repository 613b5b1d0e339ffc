"""The in-core half-spectrum pipeline on one device.

Port of the main path of ``zeldovich_tpu/models/pipeline.py``: parameters
-> P(k) and RNG tables (setup) -> the cached static fields pk_eff and the
PLT coefficient planes -> the forward step (B1: synthesis + packing +
z/x transforms, B2: c2r along y) -> streamed particle output + QA report.

Only configurations whose spectrum is exactly Hermitian run here
(``half_exact``); the others are ROADMAP A7 and raise.
"""

from __future__ import annotations

import sys

import torch

from zeldovich_tpu.utils.output import OutputWriter, setup_output_dir
from zeldovich_tpu.utils.params import Parameters
from zeldovich_tpu.utils.power import PowerSpectrum, mode_amplitude_tables

from ..ops import plt as plt_ops
from ..ops.c2r import c2r_y
from ..ops.modes import SynthConfig, SynthTables
from ..ops.modes_real import pk_effective, plt_coef_fields
from ..ops.synth import halfspace_pack_zx


class Zeldovich:
    """Parameters -> displacement/velocity fields on ``device``."""

    def __init__(self, param: Parameters, dtype=torch.float32, device="cpu"):
        self.param = param
        self.dtype = dtype
        self.device = torch.device(device)
        self.Pk = PowerSpectrum(param)
        pk_n2, _ = mode_amplitude_tables(self.Pk, param)
        self.cfg = SynthConfig.from_params(param, self.Pk.fixed_power)
        eig = None
        if param.qPLT:
            print("Using PLT eigenmodes.", file=sys.stderr)
            eig = plt_ops.load_eigmodes(param.resolve_path(param.PLT_filename))
        self.tables = SynthTables.build(
            param.seed, param.ppd, pk_n2, eig=eig, device=self.device
        )
        self._pk_eff = None
        self._plt_coefs = None

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
            self._plt_coefs = plt_coef_fields(self.cfg, self.tables, self.dtype)
        return self._plt_coefs

    def xspace_half_pair(self):
        """The forward step: (narray, 2, Y, Z, X) x-space real pairs."""
        if not self.half_exact:
            raise NotImplementedError(
                "f_NL, ZD_Version=1 and CornerModes with k_cutoff != 1 are "
                "not ported yet (ROADMAP A7); run them with the JAX package, "
                "python -m zeldovich_tpu"
            )
        g = halfspace_pack_zx(self.cfg, self.tables, self.pk_eff, self.plt_coefs)
        return c2r_y(g, self.cfg.ppd)

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
