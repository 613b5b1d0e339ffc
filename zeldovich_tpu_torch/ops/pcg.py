"""Bit-exact pcg64 (``setseq_xsl_rr_128_64``): the host tables of the stream.

This is the determinism backbone of the whole framework: the reference IC
generator draws every Fourier mode's two uniforms from a single logical pcg64
stream laid out over a virtual ``MAX_PPD^3`` (65536^3) Fourier cube, so that
the phases are invariant to the actual grid size and blocking
(see reference ``README.md:146-182``, ``src/power_spectrum.cpp:26-38``,
``src/zeldovich.cpp:314-341``).

The generator follows the PCG paper spec (O'Neill 2014): this file holds the
pure-Python-integer half that builds the per-plane and per-axis jump tables,
and the draws themselves run on the device (``ops/pcg_device.py`` and the
CUDA kernels).  Semantics verified bit-exact
against the reference's vendored header (``include/pcg-rng/pcg_random.hpp``)
via a compiled oracle; golden vectors live in ``tests/test_pcg.py``.

Key semantics (for the 128-bit-state engine):

* state update ("bump"): ``s' = (s * MULT + INC) mod 2^128`` where ``INC`` is
  the default stream increment (odd).
* The single-int-arg constructor seeds ``s0 = bump(seed + INC)``.
* ``operator()`` for 128-bit state types advances FIRST and outputs the NEW
  state (``output_previous == false`` because ``sizeof(pcg128_t) > 8``).
* XSL-RR output: ``rot = s >> 122``; ``out = rotr64(hi64(s) ^ lo64(s), rot)``.
* ``advance(delta)`` is the O(log delta) LCG jump-ahead (Brown 1994): an
  affine map ``s -> m*s + c`` whose coefficients depend only on ``delta``.

The affine form is what makes the stream TPU-friendly: for a fixed grid size
the per-row / per-column jump deltas are static, so their affine coefficients
are precomputed host-side and each mode's RNG state becomes one 128-bit
multiply-add on device -- no serial skip bookkeeping like the reference's
``nskip`` walk (``src/zeldovich.cpp:333-363``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

MASK128 = (1 << 128) - 1

# Default multiplier / increment of the 128-bit LCG underlying pcg64
# (PCG paper constants; reference pcg_random.hpp:163,169).
PCG64_MULT = (2549297995355413924 << 64) | 4865540595714422341
PCG64_INC = (6364136223846793005 << 64) | 1442695040888963407

#: The virtual cube edge the logical stream is laid out over
#: (reference include/zeldovich.h:34).
MAX_PPD = 65536

DRAWS_PER_MODE = 2  # deterministic Box-Muller consumes exactly 2 uniforms
DRAWS_PER_PLANE = DRAWS_PER_MODE * MAX_PPD * MAX_PPD


def bump(state: int) -> int:
    """One LCG step: ``s * MULT + INC mod 2^128``."""
    return (state * PCG64_MULT + PCG64_INC) & MASK128


def seed_state(seed: int) -> int:
    """Initial state for ``pcg64(seed)`` (single-arg ctor, default stream)."""
    return bump((seed + PCG64_INC) & MASK128)


def advance_affine(delta: int) -> tuple[int, int]:
    """Affine coefficients ``(m, c)`` with ``advance(s, delta) = m*s + c``.

    Brown (1994) fast-exponentiation jump-ahead, identical recurrence to the
    reference engine's ``advance`` (pcg_random.hpp:664-686).
    """
    cur_mult, cur_plus = PCG64_MULT, PCG64_INC
    acc_mult, acc_plus = 1, 0
    while delta > 0:
        if delta & 1:
            acc_mult = (acc_mult * cur_mult) & MASK128
            acc_plus = (acc_plus * cur_mult + cur_plus) & MASK128
        cur_plus = ((cur_mult + 1) * cur_plus) & MASK128
        cur_mult = (cur_mult * cur_mult) & MASK128
        delta >>= 1
    return acc_mult, acc_plus


def compose_affine(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    """Affine map of advancing by ``delta_b`` then ``delta_a`` (a after b)."""
    ma, ca = a
    mb, cb = b
    return (ma * mb) & MASK128, (ma * cb + ca) & MASK128


# ---------------------------------------------------------------------------
# Logical-stream layout over the virtual MAX_PPD^3 cube
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def plane_states(seed: int, nplanes: int) -> tuple[int, ...]:
    """RNG state at the start of each y-plane (reference v2rng array)."""
    states = [seed_state(seed)]
    m, c = advance_affine(DRAWS_PER_PLANE)
    for _ in range(nplanes - 1):
        states.append((m * states[-1] + c) & MASK128)
    return tuple(states)


# ---------------------------------------------------------------------------
# Precomputed tables for the device kernel (32-bit limbs, little-endian)
# ---------------------------------------------------------------------------


def to_limbs32(v: int, n: int = 4) -> np.ndarray:
    """128-bit int -> n uint32 limbs, least-significant first."""
    return np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)], dtype=np.uint32)


def from_limbs32(limbs) -> int:
    v = 0
    for i, l in enumerate(np.asarray(limbs, dtype=np.uint64)):
        v |= int(l) << (32 * i)
    return v


def axis_affine_tables(ppd: int, axis_stride: int) -> tuple[np.ndarray, np.ndarray]:
    """Affine (m, c) tables for one grid axis as uint32 limb arrays.

    ``axis_stride`` is the number of draws between consecutive *logical*
    slots on this axis: ``2*MAX_PPD`` for z, ``2`` for x.  Entry ``i`` is the
    affine map advancing a plane/row state by ``stride`` times i's logical
    slot (i for i <= ppd/2, else ``MAX_PPD - ppd + i``: negative frequencies
    sit at the top of the virtual axis).

    Returns (m, c), each of shape (ppd, 4) uint32 (little-endian limbs).
    """
    m = np.empty((ppd, 4), dtype=np.uint32)
    c = np.empty((ppd, 4), dtype=np.uint32)
    # consecutive logical slots differ by `axis_stride` draws except at the
    # wrap; build incrementally with one compose per entry.
    step = advance_affine(axis_stride)
    wrap = advance_affine(axis_stride * (MAX_PPD - ppd + 1))
    cur = (1, 0)
    for i in range(ppd):
        if i == ppd // 2 + 1:
            cur = compose_affine(wrap, advance_affine(axis_stride * (ppd // 2)))
        elif i > 0:
            cur = compose_affine(step, cur)
        m[i] = to_limbs32(cur[0])
        c[i] = to_limbs32(cur[1])
    return m, c


def prebump_axis_tables(m: np.ndarray, c: np.ndarray):
    """Fold one LCG step into an axis affine table (bump ∘ jump).

    The composed map sends the plane state straight to the state at the
    mode's FIRST output draw (pcg64 is advance-then-output:
    output_previous == false for 128-bit state engines,
    pcg_random.hpp:381-386,827), saving one 128-bit madd per mode in every
    draw chain; the second draw is one further bump.  Applied to the
    OUTER (z) axis at table build so the precomposed (z, x) maps and the
    on-the-fly compose path inherit it identically
    (pcg_device.uniform_pair_from_affine documents the matching
    contract).
    """
    step = (PCG64_MULT, PCG64_INC)
    mo = np.empty_like(m)
    co = np.empty_like(c)
    for i in range(m.shape[0]):
        mm, cc = compose_affine(step, (from_limbs32(m[i]), from_limbs32(c[i])))
        mo[i] = to_limbs32(mm)
        co[i] = to_limbs32(cc)
    return mo, co


def plane_state_table(seed: int, ppd: int) -> np.ndarray:
    """uint32-limb array (ppd//2, 4) of per-y-plane start states."""
    states = plane_states(seed, ppd // 2)
    out = np.empty((ppd // 2, 4), dtype=np.uint32)
    for i, s in enumerate(states):
        out[i] = to_limbs32(s)
    return out
