"""3-D DFTs of real pairs: the port of ``ops/mmfft.py``'s ``ifft3_pair`` /
``fft3_pair`` (full grid) and ``ifft3_half_pair`` (packed half spectrum).

The pair layout is ``(..., 2, Y, Z, X)`` (re/im on axis -4), so a batch of
packed arrays ``(narray, 2, Y, Z, X)`` transforms as it is.  Each transform
is ``y_dft`` followed by ``zx_dft`` (the JAX order is y, z, x), both
unnormalized in the FFTW sign convention.  ``out`` may be the input (in
place: no second full grid).  ``plain=True`` runs the plain versions of
the kernels on any device: the reference the kernels are held against.
"""

from __future__ import annotations

from .c2r import c2r_y, c2r_y_plain
from .fft import y_dft, y_dft_plain, zx_dft, zx_dft_plain


def _dft3(pair, sign: int, out, plain: bool):
    y, zx = (y_dft_plain, zx_dft_plain) if plain else (y_dft, zx_dft)
    x = y(pair, sign, out)
    return zx(x, sign, x)


def ifft3_pair(pair, out=None, plain: bool = False):
    """Unnormalized inverse (sign +1), the reference convention."""
    return _dft3(pair, +1, out, plain)


def fft3_pair(pair, out=None, plain: bool = False):
    """Forward (sign -1), unnormalized."""
    return _dft3(pair, -1, out, plain)


def ifft3_half_pair(spm, plain: bool = False):
    """Unnormalized inverse 3-D transform of a packed half spectrum.

    spm: (narray, 2, 2, ky, Z, X) (array, +/- packing, re/im, ky, z, x)
    with ky = n/2 + 1, from ``halfspace_pack`` + ``fix_ky0_packed``.
    zx_dft (sign +1) on it, re/im at -4 with K = ky, then the c2r along y
    with n = 2 (ky - 1) (B2 takes the Nyquist row); returns
    (narray, 2, n, Z, X), the layout ``ifft3_pair`` gives for the full
    grid.  The port of the JAX package's ``mmfft.ifft3_half_pair``.
    """
    n = 2 * (spm.shape[-3] - 1)
    zx, c2r = (zx_dft_plain, c2r_y_plain) if plain else (zx_dft, c2r_y)
    return c2r(zx(spm, +1), n)
