"""MT19937 for the legacy ZD_Version=1 mode stream.

The reference's v1 path draws from GSL's mt19937 (one generator per
y-residual within a block, seeded ``seed + i``; src/power_spectrum.cpp:18-25)
with ``gsl_rng_uniform`` = 32-bit output / 2^32 and rejection-sampling
Box-Muller (``cgauss<1>``, power_spectrum.cpp:310-332).  Version 1 is kept
for backwards compatibility only: its phases depend on ZD_NumBlock.

This is the standard Mersenne Twister (Matsumoto & Nishimura, mt19937ar)
with Knuth-2002 scalar seeding and GSL's default seed 4357 for s == 0.
Generation is vectorized per 624-word twist block (numpy), so bulk draws
run at memory speed on the host.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)


class MT19937:
    def __init__(self, seed: int):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 4357  # GSL default seed
        mt = np.empty(_N, dtype=np.uint64)
        mt[0] = seed
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> np.uint64(30))) + i) & 0xFFFFFFFF
        self._mt = mt.astype(np.uint32)
        self._idx = _N  # force a twist on first draw

    def _twist(self):
        # canonical three-part update: the tail reads words already updated
        # in this twist, so vectorize in dependency order
        mt = self._mt

        def tw(cur, nxt, src):
            y = (cur & _UPPER) | (nxt & _LOWER)
            mag = np.where(y & np.uint32(1), _MATRIX_A, np.uint32(0))
            return src ^ (y >> np.uint32(1)) ^ mag

        # chunks of N-M=227 respect the dependency chain (chunk j reads
        # values chunk j-1 already produced)
        step = _N - _M
        for start in range(0, _N - 1, step):
            stop = min(start + step, _N - 1)
            src = np.take(mt, (np.arange(start, stop) + _M) % _N)
            mt[start:stop] = tw(mt[start:stop], mt[start + 1 : stop + 1], src)
        mt[_N - 1] = tw(mt[_N - 1 :], mt[:1], mt[_M - 1 : _M])[0]
        self._idx = 0

    def integers(self, n: int) -> np.ndarray:
        """Next n tempered 32-bit outputs (uint32)."""
        out = np.empty(n, dtype=np.uint32)
        filled = 0
        while filled < n:
            if self._idx >= _N:
                self._twist()
            take = min(n - filled, _N - self._idx)
            y = self._mt[self._idx : self._idx + take].copy()
            y ^= y >> np.uint32(11)
            y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
            y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
            y ^= y >> np.uint32(18)
            out[filled : filled + take] = y
            filled += take
            self._idx += take
        return out

    def uniforms(self, n: int) -> np.ndarray:
        """n gsl_rng_uniform draws: [0, 1) as k / 2^32, float64."""
        return self.integers(n).astype(np.float64) * 2.0**-32
