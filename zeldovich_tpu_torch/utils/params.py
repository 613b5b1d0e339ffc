"""Run parameters: registration, validation, derived quantities.

Mirrors the reference ``Parameters`` class (src/parameters.cpp:11-222,
include/parameters.h:9-86): identical key names, defaults, MUST_DEFINE
flags, validation rules and derived quantities, so existing ``.par`` files
(including full Abacus parameter files with extra keys) work unchanged.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from pathlib import Path

from .parseheader import DONT_CARE, MUST_DEFINE, ParseHeader, PHType

MAX_PPD = 65536  # virtual RNG cube edge (include/zeldovich.h:34)


class ParameterError(ValueError):
    pass


@dataclass
class Parameters:
    # raw parameter-file fields (defaults: parameters.cpp:13-44)
    boxsize: float = 0.0
    Pk_scale: float = 1.0
    np: int = 0
    numblock: int = 2
    cpd: int = 0
    qdensity: int = 0
    qoneslab: int = -1
    seed: int = 0
    Pk_norm: float = 0.0
    Pk_sigma: float = 0.0
    Pk_sigma_ratio: float = 0.0
    f_cluster: float = 1.0
    Pk_smooth: float = 0.0
    qPk_fix_to_mean: int = 0
    Pk_filename: str = ""
    Pk_powerlaw_index: float = 1000.0
    output_dir: str = ""
    density_filename: str = "density{:d}"
    z_initial: float = 0.0
    qonemode: int = 0
    one_mode: list = field(default_factory=lambda: [0, 0, 0])
    qPLT: int = 0
    PLT_filename: str = ""
    qPLTrescale: int = 0
    PLT_target_z: float = 0.0
    f_NL: float = 0.0
    n_s: float = 1.0
    Omega_M: float = 1.0
    ICFormat: str = ""
    AllowDirectIO: int = 0
    version: int = -1
    CornerModes: int = 0

    # derived (setup())
    ppd: int = 0
    separation: float = 0.0
    fundamental: float = 0.0
    nyquist: float = 0.0

    # location of the source file, for resolving relative paths
    param_dir: Path = field(default_factory=Path)

    _REGISTRY = [
        # (key, attr, type, flag) -- parameters.cpp:61-95
        ("BoxSize", "boxsize", PHType.DOUBLE, MUST_DEFINE),
        ("ZD_Pk_scale", "Pk_scale", PHType.DOUBLE, MUST_DEFINE),
        ("NP", "np", PHType.LONG, MUST_DEFINE),
        ("ZD_NumBlock", "numblock", PHType.INT, MUST_DEFINE),
        ("CPD", "cpd", PHType.INT, MUST_DEFINE),
        ("ZD_qdensity", "qdensity", PHType.INT, DONT_CARE),
        ("ZD_qoneslab", "qoneslab", PHType.INT, DONT_CARE),
        ("ZD_Seed", "seed", PHType.INT, MUST_DEFINE),
        ("ZD_Pk_norm", "Pk_norm", PHType.DOUBLE, MUST_DEFINE),
        ("ZD_Pk_sigma", "Pk_sigma", PHType.DOUBLE, DONT_CARE),
        ("ZD_Pk_sigma_ratio", "Pk_sigma_ratio", PHType.DOUBLE, DONT_CARE),
        ("ZD_f_cluster", "f_cluster", PHType.DOUBLE, DONT_CARE),
        ("ZD_Pk_smooth", "Pk_smooth", PHType.DOUBLE, MUST_DEFINE),
        ("ZD_qPk_fix_to_mean", "qPk_fix_to_mean", PHType.INT, DONT_CARE),
        ("ZD_Pk_filename", "Pk_filename", PHType.STRING, DONT_CARE),
        ("ZD_Pk_powerlaw_index", "Pk_powerlaw_index", PHType.DOUBLE, DONT_CARE),
        ("InitialConditionsDirectory", "output_dir", PHType.STRING, MUST_DEFINE),
        ("ZD_density_filename", "density_filename", PHType.STRING, DONT_CARE),
        ("InitialRedshift", "z_initial", PHType.DOUBLE, MUST_DEFINE),
        ("ZD_qonemode", "qonemode", PHType.INT, DONT_CARE),
        ("ZD_one_mode", "one_mode", PHType.INT_VECTOR, DONT_CARE),
        ("ZD_qPLT", "qPLT", PHType.INT, DONT_CARE),
        ("ZD_PLT_filename", "PLT_filename", PHType.STRING, DONT_CARE),
        ("ZD_qPLT_rescale", "qPLTrescale", PHType.INT, DONT_CARE),
        ("ZD_PLT_target_z", "PLT_target_z", PHType.DOUBLE, DONT_CARE),
        ("ZD_k_cutoff", "k_cutoff", PHType.DOUBLE, DONT_CARE),
        ("ZD_f_NL", "f_NL", PHType.DOUBLE, DONT_CARE),
        ("ZD_n_s", "n_s", PHType.DOUBLE, DONT_CARE),
        ("Omega_M", "Omega_M", PHType.DOUBLE, DONT_CARE),
        ("ICFormat", "ICFormat", PHType.STRING, MUST_DEFINE),
        ("AllowDirectIO", "AllowDirectIO", PHType.INT, DONT_CARE),
        ("ZD_Version", "version", PHType.INT, DONT_CARE),
        ("ZD_CornerModes", "CornerModes", PHType.INT, DONT_CARE),
    ]

    k_cutoff: float = 1.0

    header_text: str = ""  # raw header, re-emittable into output files

    @classmethod
    def from_file(cls, path) -> "Parameters":
        path = Path(path)
        ph = ParseHeader()
        self = cls()
        for key, attr, type_, flag in cls._REGISTRY:
            ph.install(key, type_, flag, default=getattr(self, attr))
        ph.read_header(path)
        for key, attr, *_ in cls._REGISTRY:
            setattr(self, attr, ph[key])
        self.param_dir = path.parent
        try:
            self.header_text = path.read_bytes().split(b"\x02\n")[0].decode(
                "utf-8", errors="replace"
            )
        except OSError:
            self.header_text = ""
        self.setup()
        return self

    @classmethod
    def from_dict(cls, d: dict) -> "Parameters":
        """Programmatic construction (tests, library use)."""
        self = cls()
        key_to_attr = {k: a for k, a, *_ in cls._REGISTRY}
        for k, v in d.items():
            attr = key_to_attr.get(k, k)
            if not hasattr(self, attr):
                raise ParameterError(f"unknown parameter {k}")
            setattr(self, attr, v)
        self.setup()
        return self

    # -- validation + derived quantities (parameters.cpp:97-197) -----------
    def setup(self):
        if self.version == -1:
            raise ParameterError(
                "ZD_Version was not specified. New ICs should specify "
                "ZD_Version = 2; legacy ICs (pre-November 2019) should use "
                "ZD_Version = 1 to reproduce the old phases."
            )
        if self.version not in (1, 2):
            raise ParameterError(f"ZD_Version must be 1 or 2, got {self.version}")
        if self.version == 1:
            print(
                "*** WARNING: ZD_Version = 1: output phases depend on "
                "ZD_NumBlock; use ZD_Version = 2 for new ICs.",
                file=sys.stderr,
            )

        self.np = int(self.np)
        self.ppd = round(self.np ** (1.0 / 3.0))
        if self.ppd**3 != self.np:
            raise ParameterError(f"NP = {self.np} is not a perfect cube")
        if self.ppd > MAX_PPD:
            raise ParameterError(f"ppd {self.ppd} exceeds MAX_PPD {MAX_PPD}")

        # NumBlock is only modified in version 1 (RNG synchronization across
        # ppd for k_cutoff oversampling; parameters.cpp:129-142)
        if self.version == 1 and self.k_cutoff != 1.0:
            self.numblock = int(self.numblock * self.k_cutoff + 0.5)

        if self.boxsize <= 0.0:
            raise ParameterError("BoxSize must be positive")
        if self.ppd <= 0 or self.numblock <= 0:
            raise ParameterError("NP and ZD_NumBlock must be positive")
        if self.Pk_scale <= 0.0:
            raise ParameterError("ZD_Pk_scale must be positive")
        if self.Pk_norm < 0.0:
            raise ParameterError("ZD_Pk_norm must be non-negative")
        if (self.Pk_sigma > 0) == (self.Pk_sigma_ratio > 0):
            raise ParameterError(
                "Must specify exactly one of ZD_Pk_sigma or ZD_Pk_sigma_ratio!"
            )
        if not (0.0 < self.f_cluster <= 1.0):
            raise ParameterError("ZD_f_cluster must be in (0, 1]")
        if bool(self.Pk_filename) == (self.Pk_powerlaw_index != 1000):
            raise ParameterError(
                "Must specify exactly one of ZD_Pk_filename or "
                "ZD_Pk_powerlaw_index"
            )
        if self.Pk_powerlaw_index != 1000 and self.Pk_powerlaw_index > 0:
            raise ParameterError(
                "blue power-law spectra (index > 0) are most likely input error"
            )
        if self.qPLT and not self.PLT_filename:
            raise ParameterError("ZD_qPLT requires ZD_PLT_filename")
        if self.k_cutoff < 1:
            raise ParameterError("ZD_k_cutoff must be >= 1")
        if self.qPLT and not str(self.ICFormat).startswith("RV"):
            raise ParameterError(
                "ZD_qPLT computes velocities in Fourier space; use an RV* "
                "ICFormat"
            )
        if self.ppd % 2 != 0:
            raise ParameterError("ppd must be even")

        self.separation = self.boxsize / self.ppd
        self.nyquist = math.pi / self.separation
        self.fundamental = 2.0 * math.pi / self.boxsize
        return self

    # -- conveniences -------------------------------------------------------
    @property
    def narray(self) -> int:
        """Number of packed complex FFT arrays (zeldovich.cpp:871-876)."""
        if self.qdensity == 2:
            return 1
        return 4 if self.qPLT else 2

    def resolve_path(self, p) -> Path:
        """Resolve a path from the .par file.

        The reference resolves relative paths against the CWD; we prefer the
        parameter file's directory (so runs work from anywhere) and fall
        back to the CWD for compatibility.
        """
        p = Path(p)
        if p.is_absolute():
            return p
        cand = self.param_dir / p
        return cand if cand.exists() or not p.exists() else p

    @property
    def output_path(self) -> Path:
        return self.resolve_path(self.output_dir)
