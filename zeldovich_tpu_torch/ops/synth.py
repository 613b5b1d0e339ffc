"""B1 and B3: the half-spectrum synthesis and packing, with and without
the z/x inverse DFTs.

Ports of ``zeldovich_tpu/ops/pallas_synth.py``:

* ``halfspace_pack_zx`` (B1, ``halfspace_pack_zx_pallas``) returns the
  z/x-transformed packed half-spectrum ``(narray, 2, 2, half, Z, X)``
  with the ky=0 fixup and without the always-zero y-Nyquist row (or the
  planes [ky0, ky0 + rows) of it); the c2r y-transform (ops/c2r.py) is
  told ``n`` explicitly;
* ``halfspace_pack`` (B3, ``halfspace_pack_pallas``) returns the
  untransformed ``(narray, 2, 2, half+1, Z, X)`` with the ky=0 plane raw
  and the Nyquist row zero: the separate half route's synthesis, at every
  even ppd (B3 carries no DFT).

Two size rules: ``fft_kernels_take`` (power-of-two ppd in [16, 2048]) for
the kernels that carry a DFT (B1 here, B2, zx, y), which ``ops/mmfft.py``
also routes by, and ``check_draw_size`` (every even ppd up to
``DRAW_PPD_MAX``) for the draw and pack kernels B3, B4 and B5.

On a CUDA tensor each launches its hand-written kernel (csrc/synth.cu,
the float32 or the float64 instance by pk_eff's dtype) or raises; on a
CPU tensor it runs the plain version: for B1 ``pack_rows`` and the ky=0 fixup followed by an unnormalized sign +1
complex FFT over (z, x), for B3 ``pack_half_raw``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from .modes import SynthConfig, SynthTables
from .modes_real import fix_ky0_packed, pack_half_raw, pack_rows

_FIXED_POWER, _JUST_DENSITY, _QPLT = 1, 2, 4


@lru_cache(maxsize=32)
def twiddles(n: int, device: torch.device, sign: int = +1,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n/2, 2) table of exp(sign 2 pi i j / n) in ``dtype``, computed in
    float64 (and rounded once for float32): the kernels' FFTs transform in
    the table's sign."""
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign}")
    check_kernel_dtype(dtype)
    w = np.exp(sign * 2j * np.pi * np.arange(n // 2) / n)
    tw = np.stack([w.real, w.imag], axis=-1)
    return torch.from_numpy(tw).to(device, dtype)


def check_kernel_dtype(dtype):
    """The kernels exist for float32 and float64 (kernels.REAL)."""
    if dtype not in kernels.REAL:
        raise TypeError(f"the CUDA kernels are float32 and float64, got {dtype}")


def fft_kernels_take(n: int) -> bool:
    """The FFT kernels' size rule (B1, B2, zx, y): a power of two in
    [16, 2048].  The port of the size term of the JAX package's kernel
    gates (``pallas_fft._gate``); other lengths take the matrix products
    of ``ops/mmfft.py``."""
    return 16 <= n <= 2048 and not n & (n - 1)


def check_kernel_size(n: int):
    """Raise unless the FFT kernels take length n (``fft_kernels_take``)."""
    if not fft_kernels_take(n):
        raise ValueError(
            f"ppd {n}: the CUDA FFT kernels take power-of-two ppd in [16, 2048]; "
            "other sizes take the matrix-product route of ops/mmfft.py "
            "(kernels for them: ROADMAP D6)"
        )


#: The largest ppd of the draw and pack kernels (B3, B4, B5): B3's launch
#: grid has ppd blocks along y and ppd/2 + 1 along z (at most 65535 each)
#: and its int wavenumber sum kx^2 + ky^2 + kz^2 reaches 3 (ppd/2)^2, below
#: 2^31 up to ppd = 53508; every other index of the three is size_t or
#: long long, and none assumes a power of two
DRAW_PPD_MAX = 53508


def check_draw_size(n: int):
    """The draw and pack kernels B3, B4 and B5 take every even ppd in
    [2, DRAW_PPD_MAX]: their blocks take any row length (B3's block is
    min(ppd, 256) threads, B4 guards its ragged tiles and columns, B5 is
    flat over the modes)."""
    if n % 2 or not 2 <= n <= DRAW_PPD_MAX:
        raise ValueError(
            f"ppd {n}: the CUDA draw and pack kernels (B3, B4, B5) take even "
            f"ppd in [2, {DRAW_PPD_MAX}]"
        )


def check_operands(want: dict, dev):
    """Each name -> (tensor, shape, dtype) must be a contiguous tensor of
    that shape and dtype on dev: what a kernel's pointers assume."""
    for name, (t, shape, dtype) in want.items():
        if t.device != dev or tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )


def halfspace_pack_zx_plain(cfg: SynthConfig, tables: SynthTables, pk_eff,
                            plt_coefs=None, ky0: int = 0):
    """Plain version: pack_rows, the ky=0 fixup, ifft2."""
    spm = pack_rows(cfg, tables, pk_eff.dtype, pk_eff, plt_coefs, ky0)
    if ky0 == 0:
        fix_ky0_packed(spm)
    c = torch.complex(spm[:, :, 0], spm[:, :, 1])
    del spm
    c = torch.fft.ifft2(c, norm="forward")  # sign +1, no 1/N
    return torch.stack([c.real, c.imag], dim=2)


def _kernel_operands(cfg: SynthConfig, tables: SynthTables, pk_eff, plt_coefs,
                     what: str, size_rule, ky0: int = 0):
    """Checks for the B1/B3 CUDA route, the size by size_rule; returns
    (coefs, flags, fund, fund2)."""
    dev = pk_eff.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    n, half = cfg.ppd, cfg.ppd // 2
    size_rule(n)
    dtype = pk_eff.dtype
    check_kernel_dtype(dtype)
    if cfg.qPLT and plt_coefs is None:
        raise ValueError("PLT needs the coefficient planes (plt_coef_fields)")
    rows = pk_eff.shape[0]
    if not 0 <= ky0 < ky0 + rows <= half:
        raise ValueError(f"{what}: planes [{ky0}, {ky0 + rows}) outside [0, {half})")
    coefs = plt_coefs if cfg.qPLT else None
    want = {
        "pk_eff": (pk_eff, (rows, n, n), dtype),
        "planes64": (tables.planes64, (half, 2), torch.int64),
        "mzx64": (tables.mzx64, (2, n, n), torch.int64),
        "czx64": (tables.czx64, (2, n, n), torch.int64),
    }
    if coefs is not None:
        want["plt_coefs"] = (coefs, (4, rows, n, n), dtype)
    check_operands(want, dev)
    flags = (
        (_FIXED_POWER if cfg.fixed_power else 0)
        | (_JUST_DENSITY if cfg.just_density else 0)
        | (_QPLT if coefs is not None else 0)
    )
    # the fundamental and its square rounded to the element type, as the
    # plain version's field_coefs forms them
    fund = (np.float32 if dtype == torch.float32 else np.float64)(cfg.fundamental)
    return coefs, flags, float(fund), float(fund * fund)


def halfspace_pack_zx(cfg: SynthConfig, tables: SynthTables, pk_eff,
                      plt_coefs=None, ky0: int = 0):
    """Transformed packed half-spectrum (narray, 2, 2, rows, Z, X).

    pk_eff: (rows, Z, X) pk_effective of the generated planes
    [ky0, ky0 + rows), all half of them on the main path; plt_coefs:
    (4, rows, Z, X) PLT coefficient planes of the same planes
    (modes_real.plt_coef_fields), required under PLT.
    """
    if pk_eff.device.type == "cpu":
        return halfspace_pack_zx_plain(cfg, tables, pk_eff, plt_coefs, ky0)
    coefs, flags, fund, fund2 = _kernel_operands(cfg, tables, pk_eff, plt_coefs,
                                                 "halfspace_pack_zx", check_kernel_size,
                                                 ky0)
    n, rows = cfg.ppd, pk_eff.shape[0]
    out = torch.empty((cfg.narray, 2, 2, rows, n, n), dtype=pk_eff.dtype,
                      device=pk_eff.device)
    kernels.launch_pack_zx(
        tables.planes64, tables.mzx64, tables.czx64, pk_eff, coefs,
        twiddles(n, pk_eff.device, +1, pk_eff.dtype), out, n, cfg.narray, flags,
        fund, fund2, ky0,
    )
    return out


def halfspace_pack(cfg: SynthConfig, tables: SynthTables, pk_eff, plt_coefs=None):
    """B3: the packed half spectrum (narray, 2, 2, half+1, Z, X), the ky=0
    plane raw (the caller applies ``modes_real.fix_ky0_packed``) and the
    y-Nyquist row zero.  Operands as for halfspace_pack_zx."""
    if pk_eff.device.type == "cpu":
        return pack_half_raw(cfg, tables, pk_eff.dtype, pk_eff, plt_coefs)
    coefs, flags, fund, fund2 = _kernel_operands(cfg, tables, pk_eff, plt_coefs,
                                                 "halfspace_pack", check_draw_size)
    if pk_eff.shape[0] != cfg.ppd // 2:
        raise ValueError("halfspace_pack: want pk_eff of every generated plane")
    n, half = cfg.ppd, cfg.ppd // 2
    out = torch.empty((cfg.narray, 2, 2, half + 1, n, n), dtype=pk_eff.dtype,
                      device=pk_eff.device)
    kernels.launch_halfspace_pack(
        tables.planes64, tables.mzx64, tables.czx64, pk_eff, coefs, out, n,
        cfg.narray, flags, fund, fund2,
    )
    return out
