"""Legacy ZD_Version=1 mode generation (MT19937 + rejection Box-Muller).

Reproduces the reference's v1 stream semantics (deprecated; phases depend
on ZD_NumBlock): one MT19937 per y-residual within a block, seeded
``seed + yres`` (power_spectrum.cpp:18-25); plane y = yblock*block + yres
draws from stream ``yres``, y-blocks processed serially so one stream spans
planes yres, block+yres, 2*block+yres, ... (zeldovich.cpp:369 with the
outer loop at :558); draws are consumed only for non-zeroed modes, via the
rejection-sampling ``cgauss<1>`` (power_spectrum.cpp:310-332).

Vectorization: rejection sampling is serial per stream, but the *accepted
pair sequence* is order-preserving -- pair up the raw uniform stream,
compute the acceptance mask in bulk, and the m-th accepted pair belongs to
the m-th generated mode.  So each stream is drawn in large batches at
memory speed and the per-mode loop disappears.

The result is a D(k) field on the generated half-space that feeds the same
packing/Hermitian/FFT machinery as v2 (ops/modes.py synthesize with
``D_source``).
"""

from __future__ import annotations

import numpy as np

from ..utils.params import Parameters
from .mt19937 import MT19937


def _zero_mask_plane(ky: int, param: Parameters) -> np.ndarray:
    """Boolean (ppd, ppd) mask of zeroed modes for plane ky (z, x order)."""
    ppd = param.ppd
    half = ppd // 2
    idx = np.arange(ppd)
    k = np.where(idx > half, idx - ppd, idx)
    kz = k[:, None]
    kx = k[None, :]
    kmax = int(half * (1.0 / param.k_cutoff) + 0.5)
    k2 = (kx * kx + ky * ky + kz * kz) * param.fundamental**2
    zero = (np.abs(kx) == kmax) | (np.abs(kz) == kmax) | (abs(ky) == kmax)
    if not param.CornerModes:
        zero |= k2 >= param.nyquist**2 / param.k_cutoff**2
    if param.qonemode:
        om = param.one_mode
        zero |= ~((kx == om[0]) & (ky == om[1]) & (kz == om[2]))
    return zero


class StreamDrawer:
    """Draws accepted cgauss<1> pairs from one MT19937 stream, consuming
    exactly the same underlying uniforms as the reference's serial loop."""

    def __init__(self, seed: int):
        self._rng = MT19937(seed)
        self._p1 = np.empty(0)
        self._p2 = np.empty(0)
        self._r2 = np.empty(0)
        self._pos = 0

    def _refill(self, need: int):
        # Drawing in bulk consumes uniforms beyond what the reference's
        # serial loop would have consumed *only if* we discard leftovers;
        # by buffering every accepted pair (in order) and never rewinding,
        # consumption stays aligned: the reference consumes pairs strictly
        # in order too.
        batch = max(4096, int(need / 0.7) + 64)
        u = self._rng.uniforms(2 * batch)
        p1 = u[0::2] * 2.0 - 1.0
        p2 = u[1::2] * 2.0 - 1.0
        r2 = p1 * p1 + p2 * p2
        ok = (r2 < 1.0) & (r2 > 0.0)
        self._p1 = np.concatenate([self._p1[self._pos :], p1[ok]])
        self._p2 = np.concatenate([self._p2[self._pos :], p2[ok]])
        self._r2 = np.concatenate([self._r2[self._pos :], r2[ok]])
        self._pos = 0

    def take(self, count: int):
        while len(self._p1) - self._pos < count:
            self._refill(count - (len(self._p1) - self._pos))
        s = slice(self._pos, self._pos + count)
        self._pos += count
        return self._p1[s], self._p2[s], self._r2[s]


def generate_D_half(param: Parameters, Pk, pk_n2: np.ndarray) -> np.ndarray:
    """v1 D(k) on the generated half-space: complex128 (ppd/2, ppd, ppd).

    pk_n2: P(k) by integer n2 (utils.power.mode_amplitude_tables).
    """
    ppd = param.ppd
    half = ppd // 2
    block = ppd // param.numblock
    idx = np.arange(ppd)
    kwrap = np.where(idx > half, idx - ppd, idx)
    n2_zx = (kwrap[:, None] ** 2 + kwrap[None, :] ** 2).astype(np.int64)

    drawers = [StreamDrawer(param.seed + i) for i in range(block)]
    D = np.zeros((half, ppd, ppd), dtype=np.complex128)

    for yblock in range(param.numblock // 2):
        for yres in range(block):
            y = yblock * block + yres
            ky = y  # y < ppd/2: no wrap
            zero = _zero_mask_plane(ky, param)
            ngen = int((~zero).sum())
            if ngen == 0:
                continue
            p1, p2, r2 = drawers[yres].take(ngen)
            n2 = n2_zx[~zero] + ky * ky
            Pkv = pk_n2[n2]
            if Pk.fixed_power:
                amp = np.sqrt(Pkv / r2)
            else:
                amp = np.sqrt(-Pkv * np.log(r2) / r2)
            plane = np.zeros((ppd, ppd), dtype=np.complex128)
            plane[~zero] = p1 * amp + 1j * (p2 * amp)
            D[y] = plane
    return D
