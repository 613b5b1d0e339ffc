"""B2: half-spectrum c2r inverse DFT along y.

Port of ``zeldovich_tpu/ops/pallas_fft.py::c2r_y_folded_pallas``.  Input
``(narray, 2, 2, ky, Bz, X)`` = (array, +/- packing, re/im, ky, z, x) with
z and x already transformed, where S+- = D~ +- i F~ for two real fields,
a full grid (Bz = Z) or a z-slab; output ``(narray, 2, n, Bz, X)`` with
re = D and im = F, unnormalized, sign +1.  ``n`` is explicit: ky is n/2 + 1 (Nyquist row present) or n/2
(Nyquist-free), never inferred from parity, which is ambiguous for
n = 2 (mod 4).

On a CUDA tensor it launches the hand-written kernel (csrc/c2r.cu, the
float32 or the float64 instance by the tensor's dtype) or raises; on a
CPU tensor it runs the plain version, which follows
``mmfft.c2r_y_pair``: 2D~ = S+ + S-, 2iF~ = S+ - S-, then
``torch.fft.irfft(..., norm="forward")`` along y.

``out=spm`` runs in place when ky = n/2 (B1's pair form): the input's
four components x n/2 rows of a (z, x) column take exactly the bytes of
the output's two components x n rows, so no second grid is allocated.
"""

from __future__ import annotations

import torch

from .. import kernels
from .synth import check_kernel_dtype, check_kernel_size, twiddles


def _nyquist(spm, n: int) -> bool:
    ky = spm.shape[-3]
    if n % 2 or ky not in (n // 2, n // 2 + 1) or spm.shape[-5:-3] != (2, 2):
        raise ValueError(
            f"c2r_y: want (..., 2, 2, {n // 2} or {n // 2 + 1}, Z, X) for "
            f"n = {n}, got {tuple(spm.shape)}"
        )
    return ky == n // 2 + 1


def c2r_y_plain(spm, n: int):
    """Plain version: two irfft along y; DC and Nyquist imaginary parts
    are dropped explicitly (c2r transforms are not bound to ignore them)."""
    has_nyq = _nyquist(spm, n)
    spr, spi = spm[..., 0, 0, :, :, :], spm[..., 0, 1, :, :, :]
    smr, smi = spm[..., 1, 0, :, :, :], spm[..., 1, 1, :, :, :]
    D = torch.complex(spr + smr, spi + smi) * 0.5
    F = torch.complex(spi - smi, smr - spr) * 0.5
    edge = [0, n // 2] if has_nyq else [0]
    for a in (D, F):
        a.imag[..., edge, :, :] = 0.0
    d = torch.fft.irfft(D, n=n, dim=-3, norm="forward")
    del D
    f = torch.fft.irfft(F, n=n, dim=-3, norm="forward")
    return torch.stack([d, f], dim=-4)


def _out_view(spm, n: int, has_nyq: bool, out):
    """``out`` as the (narray, 2, n, Bz, X) result: spm itself (in place,
    ky = n/2 only) or a tensor of that shape sharing no memory with spm."""
    shape = (spm.shape[0], 2, n, *spm.shape[-2:])
    if out is spm:
        if has_nyq:
            raise ValueError("c2r_y: in place needs ky = n/2 rows (no Nyquist row), "
                             f"got {spm.shape[-3]} for n = {n}")
        return spm.view(shape)
    if (tuple(out.shape) != shape or out.dtype != spm.dtype
            or out.device != spm.device or not out.is_contiguous()):
        raise ValueError(f"c2r_y: want out contiguous {spm.dtype} {shape} on "
                         f"{spm.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if out.untyped_storage().data_ptr() == spm.untyped_storage().data_ptr():
        raise ValueError("c2r_y: out shares memory with the input; in place is out=spm")
    return out


def c2r_y(spm, n: int, out=None):
    """(narray, 2, 2, ky, Bz, X) -> (narray, 2, n, Bz, X); into ``out`` when
    given (``out=spm``: in place, for ky = n/2)."""
    has_nyq = _nyquist(spm, n)
    dst = None if out is None else _out_view(spm, n, has_nyq, out)
    if spm.device.type == "cpu":
        x = c2r_y_plain(spm, n)
        return x if dst is None else dst.copy_(x)
    check_kernel_size(n)
    if spm.device.type != "cuda":
        raise ValueError(f"c2r_y: no kernel for device {spm.device}")
    check_kernel_dtype(spm.dtype)
    # float32 moves two adjacent columns as one 8-byte word
    odd = spm.dtype == torch.float32 and (spm.shape[-2] * spm.shape[-1]) % 2
    if spm.dim() != 6 or odd:
        raise ValueError(f"c2r_y kernel: want (narray, 2, 2, ky, Bz, X), Bz * X "
                         f"even for float32, got {tuple(spm.shape)}")
    if not spm.is_contiguous() or spm.data_ptr() % 8:
        raise ValueError("c2r_y kernel: want a contiguous input on an 8-byte boundary")
    narray = spm.shape[0]
    if dst is None:
        dst = torch.empty((narray, 2, n, *spm.shape[-2:]), dtype=spm.dtype,
                          device=spm.device)
    kernels.launch_c2r_y(spm, twiddles(n, spm.device, +1, spm.dtype), dst, n, narray,
                         has_nyq)
    return dst
