"""Kernel B4's plain version against the JAX package.

``zeldovich_tpu_torch.ops.boxmuller.halfspace_boxmuller`` runs its plain
version on CPU tensors (the int64-limb draw chain of ``draw_planes``).
Its reference is the Pallas kernel ``halfspace_boxmuller_pallas`` in
interpret mode, as the JAX package's own tests run it, fed the same RNG
tables (``tables_from_jax``) and the same pk and live fields, made from a
seed with numpy.  The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py; here a torch model of its index
schedule (tests/torch_b4_model.py: a thread a (z, x) column, tiles of y
planes walked a few at a time, ragged last tiles) is held against the
plain version, exactly, and against the Pallas kernel.

Tolerances: the integer stream is bit-exact, and so are the uniforms
(tests/test_torch_pcg.py) and the zero pattern.  The deviates then go
through log, sqrt and cos/sin, whose CPU implementations differ between
torch and XLA (XLA's are its own polynomials, and it contracts the f32
minimax sincos polynomial of ROADMAP C3 into FMAs where torch rounds each
step): float64 agrees to 1 ulp of each output's scale (0.58 measured at
32^3), float32 to 2 ulp (1.74 measured).
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.ops import pcg_device as jpcg
from zeldovich_tpu.ops.modes import SynthTables as JSynthTables
from zeldovich_tpu.ops.pallas_synth import halfspace_boxmuller_pallas
from zeldovich_tpu_torch.ops import pcg_device as tpcg
from zeldovich_tpu_torch.ops.boxmuller import (
    halfspace_boxmuller, halfspace_boxmuller_plain,
)
from zeldovich_tpu_torch.ops.modes import tables_from_jax

import torch_b4_model as b4m

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


def _fields(shape, seed, dtype="float32", with_live=True):
    rng = np.random.default_rng(seed)
    pk = rng.uniform(0.0, 3.0, shape).astype(dtype)
    pk[rng.random(shape) < 0.1] = 0.0
    live = (rng.random(shape) > 0.2).astype(dtype) if with_live else None
    return pk, live


def test_b4_model_reads_the_kernels_tile_constants():
    """The model's constants come from csrc/boxmuller.cu; the walk covers
    a tile's planes in groups of U, then singly."""
    assert (b4m.THREADS, b4m.TY, b4m.U) == (256, 32, 4)
    assert b4m.grid(16, 8) == (1, 1) and b4m.grid(128, 63) == (64, 2)
    assert b4m.steps(63, 0) == [list(range(j, j + 4)) for j in range(0, 32, 4)]
    assert b4m.steps(63, 1) == ([list(range(j, j + 4)) for j in range(0, 28, 4)]
                                + [[28], [29], [30]])
    assert b4m.steps(1, 0) == [[0]]


def test_b4_double_instances_share_the_tile_and_halve_the_blocks():
    """The float64 instances of B4 walk the same tiles (one schedule, which
    the model runs in pk's dtype); their register budget is two blocks a
    SM, 128 registers a thread, where float32's four leave 64."""
    blocks = {name: int(re.search(rf"constexpr int {name} = (\d+);", b4m.SOURCE).group(1))
              for name in ("B4_MIN_BLOCKS", "B4_MIN_BLOCKS_F64")}
    assert blocks == {"B4_MIN_BLOCKS": 4, "B4_MIN_BLOCKS_F64": 2}
    assert "sizeof(F) == 8 ? B4_MIN_BLOCKS_F64 : B4_MIN_BLOCKS" in b4m.SOURCE
    assert 65536 // (b4m.THREADS * blocks["B4_MIN_BLOCKS_F64"]) == 128
    assert 65536 // (b4m.THREADS * blocks["B4_MIN_BLOCKS"]) == 64
    twin = (Path(b4m.__file__).parent.parent / "zeldovich_tpu_torch" / "csrc"
            / "boxmuller_f64.cu").read_text()
    assert "#define ZT_F64" in twin and '#include "boxmuller.cu"' in twin


@pytest.mark.parametrize("ppd", [16, 64])
@pytest.mark.parametrize("fixed_power", [False, True], ids=["drawn", "fixed"])
def test_b4_schedule_model_float64_equals_plain(ppd, fixed_power):
    """The schedule in float64 (the exact uniforms, library log, cos and
    sin) equals the plain version bit for bit, every mode written once."""
    _, port = _tables(ppd)
    half = ppd // 2 - 1
    pk, live = _fields((half, ppd, ppd), 3 * ppd, dtype="float64")
    args = (port, torch.from_numpy(pk), fixed_power, torch.from_numpy(live))
    re_, im, writes = b4m.b4_model(*args)
    assert re_.dtype == torch.float64 and bool((writes == 1).all())
    want = halfspace_boxmuller_plain(*args)
    assert torch.equal(re_, want[0]) and torch.equal(im, want[1])


@pytest.mark.parametrize("ppd", [16, 32, 64, 128])
@pytest.mark.parametrize("planes", ["one", "half-1", "half"])
def test_b4_schedule_model_equals_plain(ppd, planes):
    """Every mode is written exactly once, and the modelled kernel (the
    schedule's gathers fed through the plain draw chain) equals the plain
    version bit for bit: full and ragged y tiles, blocks wider than a row
    (n < 256), with live given on the ragged case, fixed power on the
    single plane."""
    _, port = _tables(ppd)
    half = {"one": 1, "half-1": ppd // 2 - 1, "half": ppd // 2}[planes]
    pk, live = _fields((half, ppd, ppd), ppd + half, with_live=planes == "half-1")
    fixed = planes == "one"
    args = (port, torch.from_numpy(pk), fixed,
            None if live is None else torch.from_numpy(live))
    re, im, writes = b4m.b4_model(*args)
    assert bool((writes == 1).all())
    want = halfspace_boxmuller_plain(*args)
    assert torch.equal(re, want[0]) and torch.equal(im, want[1])


@pytest.mark.parametrize("ppd", [16, 32])
@pytest.mark.parametrize("fixed_power", [False, True], ids=["drawn", "fixed"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_b4_schedule_model_with_live_matches_pallas_interpret(ppd, fixed_power, dtype):
    """The modelled kernel with a live mask against the Pallas kernel in
    interpret mode, at this file's tolerance (1 ulp of the scale in
    float64, 2 in float32: XLA's CPU log, cos and sin differ from torch's)."""
    j, port = _tables(ppd)
    shape = (ppd // 2, ppd, ppd)
    pk, live = _fields(shape, 7 * ppd + fixed_power, dtype)
    want = halfspace_boxmuller_pallas(
        j.planes, j.mzx, j.czx, jnp.asarray(pk), jnp.asarray(live),
        fixed_power=fixed_power, interpret=True,
    )
    re, im, writes = b4m.b4_model(port, torch.from_numpy(pk), fixed_power,
                                  torch.from_numpy(live))
    assert bool((writes == 1).all())
    eps = np.finfo(dtype).eps * (1 if dtype == "float64" else 2)
    for g, w in zip((re, im), want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g == 0, w == 0)
        np.testing.assert_allclose(g, w, rtol=0, atol=eps * np.abs(w).max())


@pytest.mark.parametrize("ky0,rows", [(0, 3), (5, 11), (12, 4)])
def test_b4_takes_a_span_of_planes(ky0, rows):
    """halfspace_boxmuller(..., ky0=) on the planes [ky0, ky0 + rows) gives
    those planes of the whole half space, by the plain version and by the
    kernel's schedule."""
    _, port = _tables(32)
    pk, live = _fields((16, 32, 32), 99)
    pk, live = torch.from_numpy(pk), torch.from_numpy(live)
    whole = halfspace_boxmuller(port, pk, False, live)
    span = slice(ky0, ky0 + rows)
    got = halfspace_boxmuller(port, pk[span], False, live[span], ky0=ky0)
    model = b4m.b4_model(port, pk[span], False, live[span], ky0=ky0)
    for w, g, m in zip(whole, got, model):
        assert torch.equal(g, w[span]) and torch.equal(m, w[span])


def test_b4_rejects_planes_outside_the_half_space():
    _, port = _tables(16)
    pk = torch.ones((4, 16, 16))
    with pytest.raises(ValueError, match="outside"):
        halfspace_boxmuller(port, pk, False, ky0=5)
    with pytest.raises(ValueError, match="outside"):
        halfspace_boxmuller(port, torch.ones((9, 16, 16)), False)
