"""The port's pcg64 stream and setup tables against the JAX package.

The integer stream is held bit-exact.  float32 draws use the fast draw
semantics that the JAX package uses by default on every backend
(fast_uniform_f32 and the minimax sincos_2pi, ROADMAP C3): the port
implements them op for op and agrees to 1 ulp (the CPU backends may
contract the polynomial into FMAs differently).  float64 draws use the
exact reference conversion and agree bit for bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.ops import pcg, pcg_device as jpcg
from zeldovich_tpu.ops.modes import SynthTables as JSynthTables
from zeldovich_tpu_torch.ops import pcg_device as tpcg
from zeldovich_tpu_torch.ops.modes import SynthTables, tables_from_jax

torch.set_num_threads(1)


def _rand_limbs(rng, shape):
    return rng.integers(0, 2**32, size=(*shape, 4), dtype=np.uint64).astype(np.uint32)


def _as_np(t):
    return np.stack([np.asarray(a).astype(np.int64) for a in t], axis=-1)


def _tp(a):
    return tpcg.limbs(a)


def _jx(a):
    return jpcg.unpack(jnp.asarray(a))


@pytest.mark.parametrize("op", ["madd128", "bump", "compose"])
def test_128bit_arithmetic_bit_exact(op):
    rng = np.random.default_rng(11)
    m, s, c = (_rand_limbs(rng, (257,)) for _ in range(3))
    # edge values: all-ones and zero limbs
    m[0], s[1], c[2] = 0xFFFFFFFF, 0, 0xFFFFFFFF
    if op == "madd128":
        got = tpcg.madd128(_tp(m), _tp(s), _tp(c))
        want = jpcg.madd128(_jx(m), _jx(s), _jx(c))
    elif op == "bump":
        got = tpcg.bump(_tp(s))
        want = jpcg.bump(_jx(s))
    else:
        got = sum(tpcg.compose_affine(_tp(m), _tp(c), _tp(s), _tp(c)), ())
        want = sum(jpcg.compose_affine(_jx(m), _jx(c), _jx(s), _jx(c)), ())
    np.testing.assert_array_equal(
        np.stack([g.numpy() for g in got]), np.stack([np.asarray(w) for w in want])
    )


def test_xsl_rr_and_uniforms():
    rng = np.random.default_rng(5)
    s = _rand_limbs(rng, (4096,))
    s[:64, 3] = np.arange(64, dtype=np.uint32) << 26  # every rotation
    lo, hi = tpcg.xsl_rr(_tp(s))
    r = np.asarray(jpcg.output_u64(_jx(s))).astype(np.uint64)
    got = lo.numpy().astype(np.uint64) | (hi.numpy().astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(got, r)

    # float64: the exact reference conversion, bit for bit
    np.testing.assert_array_equal(
        tpcg.uniform_exact(lo, hi).numpy(),
        np.asarray(jpcg.uniform_from_u64(jnp.asarray(r), jnp.float64)),
    )
    # float32 fast form: one rounding per op, 1 ulp
    u32 = tpcg.fast_uniform_f32(lo, hi).numpy()
    want = np.asarray(jpcg.fast_uniform_f32_from_u64(jnp.asarray(r)))
    np.testing.assert_array_max_ulp(u32, want, maxulp=1)
    assert u32.min() > 0


def test_sincos_2pi_fast_form():
    T = np.random.default_rng(2).uniform(0, 1 + 2**-32, 1 << 14).astype(np.float32)
    T[:5] = [0.0, 0.25, 0.5, 0.75, 1.0]
    c, s = tpcg.sincos_2pi(torch.from_numpy(T))
    jc, js = jpcg.sincos_2pi(jnp.asarray(T), np.float32)
    # 1 ulp of unit amplitude (the fits' own error is below that)
    eps = np.float32(2.0**-23)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=eps)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=eps)
    # float64 takes the library cos/sin like the JAX package
    T64 = T.astype(np.float64)
    c64, s64 = tpcg.sincos_2pi(torch.from_numpy(T64))
    np.testing.assert_allclose(c64.numpy(), np.cos(2 * np.pi * T64), rtol=0, atol=1e-15)
    np.testing.assert_allclose(s64.numpy(), np.sin(2 * np.pi * T64), rtol=0, atol=1e-15)


@pytest.mark.parametrize("ppd", [16, 24])
def test_synth_tables_equal_as_integers(ppd):
    pk_n2 = np.linspace(0.0, 1.0, 3 * (ppd // 2) ** 2 + 1)
    j = JSynthTables.build(4242, ppd, pk_n2)
    port = SynthTables.build(4242, ppd, pk_n2, device="cpu")
    carried, _, _ = tables_from_jax(
        *(tuple(np.asarray(a) for a in getattr(j, f))
          for f in ("planes", "mz", "cz", "mx", "cx", "mzx", "czx")),
        np.asarray(j.pk_n2), device="cpu"
    )
    for f in ("planes", "mz", "cz", "mx", "cx", "mzx", "czx"):
        want = _as_np(getattr(j, f))
        np.testing.assert_array_equal(_as_np(getattr(port, f)), want, err_msg=f)
        np.testing.assert_array_equal(_as_np(getattr(carried, f)), want, err_msg=f)
    for f in ("planes64", "mzx64", "czx64"):
        np.testing.assert_array_equal(
            getattr(port, f).numpy(), getattr(carried, f).numpy(), err_msg=f
        )
    # the kernel's packed words are the same 128-bit integers
    w = port.mzx64.numpy().view(np.uint64)
    m = _as_np(j.mzx).astype(np.uint64)
    np.testing.assert_array_equal(w[0], m[..., 0] | (m[..., 1] << np.uint64(32)))
    np.testing.assert_array_equal(w[1], m[..., 2] | (m[..., 3] << np.uint64(32)))


def test_first_draw_state_of_every_mode():
    """plane[y] * mzx + czx lands on each mode's first-draw state: against
    the JAX device stream everywhere, and the host scalar pcg64 on a few."""
    ppd, seed = 16, 12346
    port = SynthTables.build(seed, ppd, np.zeros(3 * 64 + 1), device="cpu")
    j = JSynthTables.build(seed, ppd, np.zeros(3 * 64 + 1))
    half = ppd // 2
    got = tpcg.madd128(
        tuple(a[None] for a in port.mzx),
        tuple(p[:, None, None] for p in port.planes),
        tuple(a[None] for a in port.czx),
    )
    want = jpcg.madd128(
        tuple(a[None] for a in j.mzx),
        tuple(p[:, None, None] for p in j.planes),
        tuple(a[None] for a in j.czx),
    )
    got, want = _as_np(got), _as_np(want)
    assert got.shape == (half, ppd, ppd, 4)
    np.testing.assert_array_equal(got, want)
    for y, z, x in [(0, 0, 0), (3, 9, 15), (7, 15, 1)]:
        s = pcg.bump(pcg.mode_state(seed, y, z, x, ppd))  # advance-then-output
        assert pcg.from_limbs32(got[y, z, x].astype(np.uint32)) == s


EDGE_DRAWS = [0, 1, 2**32 - 1, 2**32, 2**53 - 2, 2**53 - 1, 2**53, 2**53 + 1, 2**53 + 2,
              2**54 + 3, 2**63 - 1, 2**63, 2**63 + 2**10, 2**64 - 2**11 - 1,
              2**64 - 2**11, 2**64 - 2**10 - 1, 2**64 - 2**10, 2**64 - 2, 2**64 - 1]


@pytest.mark.parametrize("r", EDGE_DRAWS, ids=[hex(r) for r in EDGE_DRAWS])
def test_uniform_exact_at_the_edges(r):
    """The float64 uniform (r + 1) 2^-64 rounded to nearest, bit for bit
    with JAX uniform_from_u64: draws below and above 2^53 (where r + 1 no
    longer fits the mantissa and ties round to even), the largest ones
    (which round up to 1.0) and the all-ones draw, whose r + 1 wraps: 1.0.
    The CUDA kernels form it as one round-to-nearest convert of r + 1 and
    an exact scaling, which is what Python's int-to-float is."""
    lo = torch.tensor([r & 0xFFFFFFFF], dtype=torch.int64)
    hi = torch.tensor([r >> 32], dtype=torch.int64)
    got = tpcg.uniform_exact(lo, hi).numpy()
    want = np.asarray(jpcg.uniform_from_u64(jnp.asarray(np.array([r], np.uint64)),
                                            jnp.float64))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    one_convert = 1.0 if r == 2**64 - 1 else float(r + 1) * 2.0**-64
    assert got[0] == one_convert and 0.0 < got[0] <= 1.0


def test_uniform_exact_bit_for_bit_on_large_draws():
    """Random draws at and above 2^53, the range where the conversion of
    r + 1 rounds."""
    rng = np.random.default_rng(53)
    r = rng.integers(2**53, 2**64 - 1, size=1 << 14, dtype=np.uint64, endpoint=True)
    lo = torch.from_numpy((r & np.uint64(0xFFFFFFFF)).astype(np.int64))
    hi = torch.from_numpy((r >> np.uint64(32)).astype(np.int64))
    np.testing.assert_array_equal(
        tpcg.uniform_exact(lo, hi).numpy(),
        np.asarray(jpcg.uniform_from_u64(jnp.asarray(r), jnp.float64)))
