"""B6/B7 and B8: unnormalized complex DFTs along one axis of real pairs.

Ports of ``zeldovich_tpu/ops/pallas_fft.py``:

* ``zx_dft(pair, sign)``: the 2-D DFT over (z, x) of ``(..., 2, K, n, n)``
  pairs (``zx_folded_pallas`` for n <= 512, ``zx_tiled_pallas`` for
  n in [1024, 2048]: one contract, one CUDA entry);
* ``y_dft(pair, sign)``: the DFT along axis -3 of ``(..., 2, Y, Bz, X)``
  pairs (``y_tiled_pallas``), a full grid (Bz = Z) or a z-slab.

Both are unnormalized with the FFTW sign convention (sign +1: no 1/N on
the inverse) and take ``out``, which may be the input itself (in place).
On a CUDA tensor each launches its hand-written kernel
(csrc/fft_axis.cu, the float32 or the float64 instance by the tensor's
dtype) or raises; on a CPU tensor it runs the plain version,
``torch.fft.ifftn(..., norm="forward")`` for sign +1 and
``torch.fft.fftn(..., norm="backward")`` for sign -1 over the same axes.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .synth import check_kernel_dtype, check_kernel_size, twiddles


def _plain(pair, sign: int, dims, out):
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign}")
    c = torch.complex(pair.select(-4, 0), pair.select(-4, 1))
    if sign > 0:
        c = torch.fft.ifftn(c, dim=dims, norm="forward")
    else:
        c = torch.fft.fftn(c, dim=dims, norm="backward")
    if out is None:
        return torch.stack([c.real, c.imag], dim=-4)
    out.select(-4, 0).copy_(c.real)
    out.select(-4, 1).copy_(c.imag)
    return out


def zx_dft_plain(pair, sign: int, out=None):
    """Plain version of zx_dft: torch.fft over the last two axes."""
    _shape_zx(pair, out)
    return _plain(pair, sign, (-2, -1), out)


def y_dft_plain(pair, sign: int, out=None):
    """Plain version of y_dft: torch.fft along axis -3."""
    _shape_y(pair, out)
    return _plain(pair, sign, (-3,), out)


def _shape_zx(pair, out):
    if pair.dim() < 4 or pair.shape[-4] != 2 or pair.shape[-1] != pair.shape[-2]:
        raise ValueError(f"zx_dft: want (..., 2, K, n, n), got {tuple(pair.shape)}")
    _check_out(pair, out, "zx_dft")


def _shape_y(pair, out):
    if pair.dim() < 4 or pair.shape[-4] != 2:
        raise ValueError(f"y_dft: want (..., 2, Y, Bz, X), got {tuple(pair.shape)}")
    _check_out(pair, out, "y_dft")


def _check_out(pair, out, what):
    if out is not None and (out.shape != pair.shape or out.dtype != pair.dtype
                            or out.device != pair.device):
        raise ValueError(f"{what}: out {out.dtype} {tuple(out.shape)} on "
                         f"{out.device} does not match the input")


def _kernel_args(pair, out, n, sign, what):
    """Checks for the CUDA route, the size first; returns (out, twiddles,
    batch)."""
    check_kernel_size(n)
    if pair.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {pair.device}")
    check_kernel_dtype(pair.dtype)
    if not pair.is_contiguous():
        raise ValueError(f"{what} kernel: want a contiguous input")
    if out is None:
        out = torch.empty_like(pair)
    elif not out.is_contiguous():
        raise ValueError(f"{what} kernel: out must be contiguous")
    # a float32 thread moves two adjacent columns as one 8-byte word, a
    # float64 thread one 8-byte element
    if pair.data_ptr() % 8 or out.data_ptr() % 8:
        raise ValueError(f"{what} kernel: want data on 8-byte boundaries")
    batch = math.prod(pair.shape[:-4])
    return out, twiddles(n, pair.device, sign, pair.dtype), batch


def zx_dft(pair, sign: int, out=None):
    """2-D DFT over (z, x) of (..., 2, K, n, n) pairs; out may be pair."""
    _shape_zx(pair, out)
    if pair.device.type == "cpu":
        return zx_dft_plain(pair, sign, out)
    n, K = pair.shape[-1], pair.shape[-3]
    out, tw, batch = _kernel_args(pair, out, n, sign, "zx_dft")
    kernels.launch_zx_dft(pair, out, tw, n, K, batch)
    return out


def y_dft(pair, sign: int, out=None):
    """DFT along axis -3 of (..., 2, Y, Bz, X) pairs; out may be pair."""
    _shape_y(pair, out)
    if pair.device.type == "cpu":
        return y_dft_plain(pair, sign, out)
    n, inner = pair.shape[-3], pair.shape[-2] * pair.shape[-1]
    if inner % 2 and pair.dtype == torch.float32:
        raise ValueError(f"y_dft kernel: float32 wants an even Bz * X, got {inner}")
    out, tw, batch = _kernel_args(pair, out, n, sign, "y_dft")
    kernels.launch_y_dft(pair, out, tw, n, inner, batch)
    return out
