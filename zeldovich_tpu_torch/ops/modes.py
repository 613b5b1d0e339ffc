"""Static synthesis configuration, zero rules and the pcg64 setup tables.

Port of the host half of ``zeldovich_tpu/ops/modes.py``: ``SynthConfig``,
``zero_rules`` and ``SynthTables``.  The tables are the per-y-plane RNG
start states and the precomposed, pre-bumped (z, x) affine jump maps, so
that a mode's first-draw state is ONE 128-bit multiply-add
``plane[y] * mzx[z, x] + czx[z, x]`` (see ``ops/pcg.py``).

Tables are held twice: as 4-tuples of int64 limb tensors (the plain
tensor-op form, comparable limb for limb with the JAX package's u32
planes) and as packed 64-bit words for the CUDA kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.params import Parameters
from ..utils.power import n2_cutoff
from . import pcg, pcg_device


@dataclass(frozen=True)
class SynthConfig:
    """Static configuration of the synthesis (mirrors the JAX package's)."""

    ppd: int
    fundamental: float
    kmax_int: int  # Nyquist-index rule, the reference's ik_cutoff form
    k2_cutoff: float  # physical (nyquist/k_cutoff)^2 sphere
    # smallest integer n2 with n2*fund^2 >= k2_cutoff in float64: the
    # cutoff decision is exact in every compute dtype
    n2_cutoff: int
    corner_modes: bool
    qonemode: bool
    one_mode: tuple[int, int, int]
    fixed_power: bool
    qPLT: bool
    qPLTrescale: bool
    f_cluster: float
    plt_rescale_base: float  # a_NL / a0
    plt_target_f: float  # continuum growth rate at f_cluster
    narray: int  # 1 (density-only), 2, or 4 (PLT velocities)
    just_density: bool

    @classmethod
    def from_params(cls, param: Parameters, fixed_power: bool) -> "SynthConfig":
        half = param.ppd // 2
        if param.qPLTrescale:
            a_NL = 1.0 / (1 + param.PLT_target_z)
            a0 = 1.0 / (1 + param.z_initial)
        else:
            a_NL = a0 = 1.0
        k2_cutoff = (
            param.nyquist * param.nyquist / (param.k_cutoff * param.k_cutoff)
        )
        return cls(
            ppd=param.ppd,
            fundamental=param.fundamental,
            kmax_int=int(half * (1.0 / param.k_cutoff) + 0.5),
            k2_cutoff=k2_cutoff,
            n2_cutoff=n2_cutoff(param),
            corner_modes=bool(param.CornerModes),
            qonemode=bool(param.qonemode),
            one_mode=tuple(param.one_mode),
            fixed_power=fixed_power,
            qPLT=bool(param.qPLT),
            qPLTrescale=bool(param.qPLTrescale),
            f_cluster=param.f_cluster,
            plt_rescale_base=a_NL / a0,
            plt_target_f=(np.sqrt(1.0 + 24 * param.f_cluster) - 1) / 4.0,
            narray=param.narray,
            just_density=param.qdensity == 2,
        )


def zero_rules(kx, ky, kz, n2, cfg: SynthConfig):
    """Mode-zeroing mask (zeldovich.cpp:349-358): Nyquist index, k_cutoff
    sphere (unless CornerModes), one-mode filter.  The sphere rule compares
    the exact integer n2 with the host-precomputed threshold."""
    zero = (
        (kx.abs() == cfg.kmax_int)
        | (ky.abs() == cfg.kmax_int)
        | (kz.abs() == cfg.kmax_int)
    )
    if not cfg.corner_modes:
        zero = zero | (n2 >= cfg.n2_cutoff)
    if cfg.qonemode:
        om = cfg.one_mode
        zero = zero | ~((kx == om[0]) & (ky == om[1]) & (kz == om[2]))
    return zero


def hermitian_source(y, z, x, ppd: int):
    """Map output grid indices to their generating mode (exact, int64).

    Returns (sy, sz, sx, mirror, hard_zero), broadcast to one shape: the
    source lies in the generated half space sy in [0, ppd/2] (sy = ppd/2
    only on the y-Nyquist plane); ``mirror`` marks entries that take the
    conjugate of their source; ``hard_zero`` marks the y-Nyquist plane and
    the origin (the JAX package's ops/modes.py::hermitian_source).
    """
    y, z, x = torch.broadcast_tensors(y, z, x)
    half = ppd // 2
    mirror = (y > half) | ((y == 0) & ((z > half) | ((z == 0) & (x > half))))
    sy = torch.where(mirror, (ppd - y) % ppd, y)
    sz = torch.where(mirror, (ppd - z) % ppd, z)
    sx = torch.where(mirror, (ppd - x) % ppd, x)
    hard_zero = (y == half) | ((y == 0) & (z == 0) & (x == 0))
    return sy, sz, sx, mirror, hard_zero


def _words(lm):
    """Limb tuple -> (lo64, hi64) words stacked on a new leading axis.

    int64 tensors carrying the unsigned 64-bit patterns: the high limb is
    taken as signed 32-bit before the shift so nothing overflows.
    """
    def word(l0, l1):
        l1s = torch.where(l1 >= 2**31, l1 - 2**32, l1)
        return (l1s << 32) | l0

    return torch.stack([word(lm[0], lm[1]), word(lm[2], lm[3])])


@dataclass(frozen=True)
class SynthTables:
    """RNG jump tables and amplitude tables for one run, on one device."""

    planes: tuple  # 4 x (ppd//2,) int64 limbs: per-y-plane start states
    mz: tuple  # 4 x (ppd,) z-axis affine multipliers (pre-bumped)
    cz: tuple  # 4 x (ppd,) z-axis affine increments (pre-bumped)
    mx: tuple  # 4 x (ppd,) x-axis affine multipliers
    cx: tuple  # 4 x (ppd,) x-axis affine increments
    mzx: tuple  # 4 x (ppd, ppd) precomposed (z, x) multipliers
    czx: tuple  # 4 x (ppd, ppd) precomposed (z, x) increments
    pk_n2: torch.Tensor  # (3*(ppd/2)^2+1,) float64 P(|k|) by integer n2
    eig: torch.Tensor | None  # (ppd_e, ppd_e, ppd_e//2+1, 4) PLT eigenmodes
    M_n2: torch.Tensor | None = None  # same-indexed f_NL M(k) factor, float64
    # packed 64-bit words for the CUDA kernel: planes (half, 2) and the
    # (z, x) maps (2, ppd, ppd), each [lo64, hi64]
    planes64: torch.Tensor = field(init=False)
    mzx64: torch.Tensor = field(init=False)
    czx64: torch.Tensor = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "planes64", _words(self.planes).T.contiguous())
        object.__setattr__(self, "mzx64", _words(self.mzx).contiguous())
        object.__setattr__(self, "czx64", _words(self.czx).contiguous())

    @property
    def device(self) -> torch.device:
        return self.pk_n2.device

    @classmethod
    def build(cls, seed: int, ppd: int, pk_n2: np.ndarray, M_n2=None, eig=None,
              device="cuda") -> "SynthTables":
        """Host pcg64 tables (ops/pcg.py) + the (z, x) compose on device.

        ``eig``: the PLT table, an array or a tensor on ``device``, or a
        callable that returns one (``plt.TableRead.join``), called once
        the host tables are built."""
        mz, cz = pcg.prebump_axis_tables(
            *pcg.axis_affine_tables(ppd, 2 * pcg.MAX_PPD)
        )
        mx, cx = pcg.axis_affine_tables(ppd, 2)
        planes = pcg.plane_state_table(seed, ppd)
        L = lambda a: pcg_device.limbs(a, device)
        mzt, czt, mxt, cxt = L(mz), L(cz), L(mx), L(cx)
        mzx, czx = pcg_device.compose_affine(
            tuple(a[:, None] for a in mzt), tuple(a[:, None] for a in czt),
            tuple(a[None, :] for a in mxt), tuple(a[None, :] for a in cxt),
        )
        if callable(eig):
            eig = eig()
        if eig is not None and not isinstance(eig, torch.Tensor):
            eig = torch.tensor(np.asarray(eig, np.float64), device=device)
        return cls(
            planes=L(planes),
            mz=mzt, cz=czt, mx=mxt, cx=cxt,
            mzx=mzx, czx=czx,
            pk_n2=torch.tensor(np.asarray(pk_n2, np.float64), device=device),
            eig=eig,
            M_n2=None if M_n2 is None else torch.tensor(
                np.asarray(M_n2, np.float64), device=device),
        )


def tables_from_jax(planes, mz, cz, mx, cx, mzx, czx, pk_n2, eig=None,
                    pk_eff=None, plt_coefs=None, device="cuda", M_n2=None):
    """The JAX package's setup state, carried across as the port's tensors.

    Every table argument is a 4-tuple of u32 limb arrays (the JAX
    ``SynthTables`` fields, as numpy); ``pk_n2``/``eig``/``M_n2`` and the
    optional ``pk_eff`` (half, Z, X) and ``plt_coefs`` 4-tuple are float
    arrays.
    Returns ``(tables, pk_eff, plt_coefs)`` on ``device``, the coefficient
    planes stacked (4, half, Z, X) as ``modes_real.plt_coef_fields``
    returns them (None where the input was None), so tests can feed
    identical state to both sides.
    """
    def L(t):
        return tuple(
            torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64),
                            device=device)
            for a in t
        )

    def F(a):
        return None if a is None else torch.tensor(np.asarray(a), device=device)

    tables = SynthTables(
        planes=L(planes), mz=L(mz), cz=L(cz), mx=L(mx), cx=L(cx),
        mzx=L(mzx), czx=L(czx), pk_n2=F(np.asarray(pk_n2, np.float64)),
        eig=F(eig), M_n2=None if M_n2 is None else F(np.asarray(M_n2, np.float64)),
    )
    coefs = None if plt_coefs is None else F(np.stack(plt_coefs))
    return tables, F(pk_eff), coefs
