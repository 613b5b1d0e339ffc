"""Kernel B4's plain version against the JAX package.

``zeldovich_tpu_torch.ops.boxmuller.halfspace_boxmuller`` runs its plain
version on CPU tensors (the int64-limb draw chain of ``draw_planes``).
Its reference is the Pallas kernel ``halfspace_boxmuller_pallas`` in
interpret mode, as the JAX package's own tests run it, fed the same RNG
tables (``tables_from_jax``) and the same pk and live fields, made from a
seed with numpy.  The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py.

Tolerances: the integer stream is bit-exact, and so are the uniforms
(tests/test_torch_pcg.py) and the zero pattern.  The deviates then go
through log, sqrt and cos/sin, whose CPU implementations differ between
torch and XLA (XLA's are its own polynomials, and it contracts the f32
minimax sincos polynomial of ROADMAP C3 into FMAs where torch rounds each
step): float64 agrees to 1 ulp of each output's scale (0.58 measured at
32^3), float32 to 2 ulp (1.74 measured).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.ops import pcg_device as jpcg
from zeldovich_tpu.ops.modes import SynthTables as JSynthTables
from zeldovich_tpu.ops.pallas_synth import halfspace_boxmuller_pallas
from zeldovich_tpu_torch.ops import pcg_device as tpcg
from zeldovich_tpu_torch.ops.boxmuller import halfspace_boxmuller
from zeldovich_tpu_torch.ops.modes import tables_from_jax

torch.set_num_threads(1)


def _tables(ppd, seed=24680):
    j = JSynthTables.build(seed, ppd, np.zeros(3 * (ppd // 2) ** 2 + 1))
    N = lambda tup: tuple(np.asarray(a) for a in tup)
    port, _, _ = tables_from_jax(
        N(j.planes), N(j.mz), N(j.cz), N(j.mx), N(j.cx), N(j.mzx), N(j.czx),
        np.asarray(j.pk_n2), device="cpu"
    )
    return j, port


@pytest.mark.parametrize("ppd", [16, 32])
def test_integer_stream_bit_exact(ppd):
    """Both draws of every mode of the generated half space, as 64-bit
    integers, equal the JAX device stream's."""
    j, port = _tables(ppd)
    state = tpcg.madd128(
        tuple(a[None] for a in port.mzx),
        tuple(p[:, None, None] for p in port.planes),
        tuple(a[None] for a in port.czx),
    )
    jstate = jpcg.madd128(
        tuple(a[None] for a in j.mzx),
        tuple(p[:, None, None] for p in j.planes),
        tuple(a[None] for a in j.czx),
    )
    for _ in range(2):  # draw 1, then one LCG step to draw 2
        lo, hi = tpcg.xsl_rr(state)
        got = lo.numpy().astype(np.uint64) | (hi.numpy().astype(np.uint64) << np.uint64(32))
        want = np.asarray(jpcg.output_u64(jstate)).astype(np.uint64)
        assert got.shape == (ppd // 2, ppd, ppd)
        np.testing.assert_array_equal(got, want)
        state, jstate = tpcg.bump(state), jpcg.bump(jstate)


@pytest.mark.parametrize("ppd", [16, 32])
@pytest.mark.parametrize("fixed_power", [False, True], ids=["drawn", "fixed"])
@pytest.mark.parametrize("with_live", [False, True], ids=["pk", "live"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_b4_plain_matches_pallas_interpret(ppd, fixed_power, with_live, dtype):
    j, port = _tables(ppd)
    rng = np.random.default_rng(ppd + 2 * fixed_power + with_live)
    shape = (ppd // 2, ppd, ppd)
    pk = rng.uniform(0.0, 3.0, shape).astype(dtype)
    pk[rng.random(shape) < 0.1] = 0.0  # zero-ruled modes
    live = (rng.random(shape) > 0.2).astype(dtype) if with_live else None

    want = halfspace_boxmuller_pallas(
        j.planes, j.mzx, j.czx, jnp.asarray(pk),
        None if live is None else jnp.asarray(live),
        fixed_power=fixed_power, interpret=True,
    )
    got = halfspace_boxmuller(
        port, torch.from_numpy(pk), fixed_power,
        None if live is None else torch.from_numpy(live),
    )
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g == 0, w == 0)
        ulps = 1 if dtype == "float64" else 2
        eps = np.finfo(dtype).eps
        np.testing.assert_allclose(g, w, rtol=0, atol=ulps * eps * np.abs(w).max())


def test_b4_has_no_plain_route_off_the_cpu():
    """Only a CPU tensor takes the plain version: another device goes to
    the kernel path, which raises where it has no kernel."""
    _, port = _tables(16)
    with pytest.raises(ValueError, match="no kernel"):
        halfspace_boxmuller(port, torch.empty((8, 16, 16), device="meta"), False)
