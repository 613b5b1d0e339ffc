"""Full-grid 3-D complex DFTs of real pairs (the port of ``ops/mmfft.py``'s
``ifft3_pair`` / ``fft3_pair``).

The pair layout is ``(..., 2, Y, Z, X)`` (re/im on axis -4), so a batch of
packed arrays ``(narray, 2, Y, Z, X)`` transforms as it is.  Each transform
is ``y_dft`` followed by ``zx_dft`` (the JAX order is y, z, x), both
unnormalized in the FFTW sign convention.  ``out`` may be the input (in
place: no second full grid).  ``plain=True`` runs the plain versions of
the kernels on any device: the reference the kernels are held against.
"""

from __future__ import annotations

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
