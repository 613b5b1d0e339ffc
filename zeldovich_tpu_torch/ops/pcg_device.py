"""Vectorized pcg64 in torch: 128-bit limb arithmetic on int64 tensors.

Port of ``zeldovich_tpu/ops/pcg_device.py``.  torch has no unsigned
64-bit multiply-high, so a 128-bit value is a TUPLE of four int64 tensors
each holding one 32-bit limb (least-significant first, values in
[0, 2^32)).  Products are formed from 16-bit pieces binned per 16-bit
output column (the ``_madd128_cols16`` scheme of ops/pallas_synth.py):
every piece product is < 2^32 and every column sum < 2^22, so nothing
overflows int64 and the result is bit-exact with the reference stream.

This is the plain (tensor-op) form of the stream, used for setup tables
and for the plain versions of the kernels; the CUDA kernels do the same
math with native ``unsigned __int128``.

Float semantics follow the JAX package: float32 uses the fast draw forms
(``fast_uniform_f32``, minimax ``sincos_2pi``), float64 the exact
reference ``one_rand`` conversion and library cos/sin.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pcg

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF

MULT_LIMBS = tuple(int(v) for v in pcg.to_limbs32(pcg.PCG64_MULT))
INC_LIMBS = tuple(int(v) for v in pcg.to_limbs32(pcg.PCG64_INC))


def limbs(a: np.ndarray, device=None) -> tuple:
    """(..., 4) uint32 host array -> 4-tuple of int64 limb tensors."""
    a = np.asarray(a, dtype=np.uint32).astype(np.int64)
    return tuple(torch.as_tensor(np.ascontiguousarray(a[..., j]), device=device)
                 for j in range(4))


def _pieces(t):
    """4 limbs -> 8 base-2^16 pieces (Python ints stay ints)."""
    out = []
    for limb in t:
        out += [limb & _M16, limb >> 16]
    return out


def madd128(m, s, c):
    """(m*s + c) mod 2^128 over limb tuples (tensors or Python ints).

    Column k accumulates the addend's piece plus at most 8 low and 7 high
    product halves, all < 2^16, so every column stays below 2^20.
    """
    A, B = _pieces(m), _pieces(s)
    cols = _pieces(c)
    for i in range(8):
        for j in range(8 - i):
            k = i + j
            p = A[j] * B[i]
            cols[k] = cols[k] + (p & _M16)
            if k < 7:  # column 7's high half falls off the top (mod 2^128)
                cols[k + 1] = cols[k + 1] + (p >> 16)
    carry = 0
    digs = []
    for k in range(8):
        t = cols[k] + carry
        digs.append(t & _M16)
        carry = t >> 16
    return tuple(digs[2 * w] | (digs[2 * w + 1] << 16) for w in range(4))


def mul128(a, b):
    """Low 128 bits of a*b."""
    return madd128(a, b, (0, 0, 0, 0))


def compose_affine(ma, ca, mb, cb):
    """Compose jump maps: advancing by delta_b then delta_a -> (m, c)."""
    return mul128(ma, mb), madd128(ma, cb, ca)


def bump(state):
    """One LCG step."""
    return madd128(MULT_LIMBS, state, INC_LIMBS)


def xsl_rr(state):
    """XSL-RR output permutation -> (lo32, hi32) int64 halves of the draw."""
    s0, s1, s2, s3 = state
    rot = s3 >> 26  # top 6 bits of the state
    xlo = s0 ^ s2
    xhi = s1 ^ s3
    swap = rot >= 32
    lo1 = torch.where(swap, xhi, xlo)
    hi1 = torch.where(swap, xlo, xhi)
    r32 = rot & 31
    inv = (32 - r32) & 31
    nz = r32 != 0
    lo = (lo1 >> r32) | torch.where(nz, (hi1 << inv) & _M32, 0)
    hi = (hi1 >> r32) | torch.where(nz, (lo1 << inv) & _M32, 0)
    return lo, hi


def uniform_exact(lo, hi, dtype=torch.float64):
    """Draw -> (0, 1] exactly as the reference one_rand (float64 form).

    ``(r + 1) * 2^-64`` assembled from two exact 32-bit converts and one
    correctly rounded add; the all-ones draw returns 1.0.
    """
    lo1 = (lo + 1) & _M32
    hi1 = (hi + (lo1 == 0).to(hi.dtype)) & _M32
    v = (hi1.to(dtype) * 2.0**32 + lo1.to(dtype)) * 2.0**-64
    allones = (lo == _M32) & (hi == _M32)
    return torch.where(allones, torch.ones((), dtype=dtype, device=v.device), v)


def _i32f(v):
    """u32 (in int64) -> float32 of (v - 2^31), one rounded convert."""
    return (v - 2**31).to(torch.int32).to(torch.float32)


def fast_uniform_f32(lo, hi):
    """(hi:lo) -> ~(x+1)*2^-64 in (0, 1 + 2^-32], float32.

    The JAX package's fast f32 form (pcg_device.fast_uniform_f32), op for
    op: the +2^-56 overshoot keeps the value strictly positive.
    """
    a = _i32f(hi) * np.float32(2.0**-32) + np.float32(0.5)
    b = _i32f(lo) * np.float32(2.0**-64) + np.float32(2.0**-33 * (1.0 + 2.0**-23))
    return a + b


# minimax fits of cos(2 pi r) and sin(2 pi r)/r on r in [-1/4, 1/4]
# (the JAX package's coefficients, pcg_device._COS2PI / _SIN2PI)
_COS2PI = (0.9999999532476083, -19.739171322478587, 64.93458164580112,
           -85.24010035715638, 56.240540440829314)
_SIN2PI = (6.283185159611168, -41.34165492934352, 81.6009981926163,
           -76.54965682070578, 39.535813712149924)


def sincos_2pi(T):
    """(cos 2 pi T, sin 2 pi T); fast minimax form in float32.

    torch.round rounds half to even like jnp.round (the CUDA kernels use
    rintf, never roundf).
    """
    if T.dtype != torch.float32:
        theta = (2 * np.pi) * T
        return torch.cos(theta), torch.sin(theta)
    F = np.float32
    t = T - torch.round(T)            # [-1/2, 1/2]
    q = torch.round(t + t)            # {-1, 0, 1}
    r = t - q * F(0.5)                # [-1/4, 1/4]
    u = r * r
    c = torch.full_like(u, F(_COS2PI[4]))
    s = torch.full_like(u, F(_SIN2PI[4]))
    for k in (3, 2, 1, 0):
        c = c * u + F(_COS2PI[k])
        s = s * u + F(_SIN2PI[k])
    s = s * r
    sign = F(1.0) - (q.abs() + q.abs())
    return sign * c, sign * s


def uniform(lo, hi, dtype):
    """The draw's uniform in the dtype's semantics (fast f32 / exact f64)."""
    if dtype == torch.float32:
        return fast_uniform_f32(lo, hi)
    return uniform_exact(lo, hi, dtype)


def uniform_pair_from_affine(plane_state, m, c, dtype):
    """Uniforms (R, T) from a precomposed, pre-bumped per-mode map (m, c)."""
    s1 = madd128(m, plane_state, c)
    s2 = bump(s1)
    return uniform(*xsl_rr(s1), dtype), uniform(*xsl_rr(s2), dtype)
