"""Kernels B6/B7 (zx_dft) and B8 (y_dft) against the JAX package.

``zeldovich_tpu_torch.ops.fft`` runs its plain versions on CPU tensors
(torch.fft).  References: the Pallas kernels ``zx_folded_pallas``,
``zx_tiled_pallas`` and ``y_tiled_pallas`` in interpret mode (float32,
tile = 8 so the tiled kernels take several tiles), and the XLA
``mmfft.cfft_axis`` / ``ifft3_pair`` / ``fft3_pair`` (float64).  Inputs
are made from a seed with numpy.  The CUDA kernels are held against the
same plain versions on the card by chip_smoke.py.

Tolerances: float32 1e-5 of the output's scale, float64 1e-12 (the folded
matmul DFT and an FFT round differently; both are well inside these).

The CUDA kernels' schedule (csrc/fft_reg.cuh: the radix plan of each n,
the Stockham index maps, the twiddle-table lookups, the padded
shared-memory exchanges of both layouts) is modelled in plain torch
(``torch_fft_model.stockham``) and held here against torch.fft and the
Pallas kernels at every power-of-two n in [16, 2048]; nothing in the
package calls the model.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.ops import mmfft as jmmfft
from zeldovich_tpu.ops.pallas_fft import y_tiled_pallas, zx_folded_pallas, zx_tiled_pallas
from zeldovich_tpu_torch.ops import mmfft
from zeldovich_tpu_torch.ops.fft import y_dft, zx_dft
from zeldovich_tpu_torch.ops.synth import twiddles
from torch_fft_model import CSRC, PLAN, Tiles, exchange_wavefronts, stockham

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "float64": 1e-12}


def _pair(shape, dtype, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _close(got, want, dtype):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("sign", [+1, -1])
def test_zx_matches_zx_folded_pallas(n, sign):
    spm = _pair((2, 2, 3, n, n), np.float32, n + sign)
    want = np.asarray(zx_folded_pallas(jnp.asarray(spm), sign, interpret=True))
    _close(zx_dft(torch.from_numpy(spm), sign).numpy(), want, "float32")


@pytest.mark.parametrize("sign", [+1, -1])
def test_zx_matches_zx_tiled_pallas(sign):
    spm = _pair((2, 2, 3, 32, 32), np.float32, 6)
    want = np.asarray(zx_tiled_pallas(jnp.asarray(spm), sign, tile=8, interpret=True))
    _close(zx_dft(torch.from_numpy(spm), sign).numpy(), want, "float32")


@pytest.mark.parametrize("bz", [1, 8, 16])
@pytest.mark.parametrize("sign", [+1, -1])
def test_y_matches_y_tiled_pallas(bz, sign):
    """A z-slab (…, 2, Y, Bz, X) of Bz planes; Bz = Z is the full grid."""
    zslab = _pair((2, 2, 16, bz, 16), np.float32, bz + sign)
    want = np.asarray(y_tiled_pallas(jnp.asarray(zslab), sign, tile=8, interpret=True))
    _close(y_dft(torch.from_numpy(zslab), sign).numpy(), want, "float32")


@pytest.mark.parametrize("sign", [+1, -1])
def test_axis_dfts_float64_match_cfft_axis(sign):
    k = _pair((2, 2, 16, 8, 16), np.float64, 11)
    p = jnp.swapaxes(jnp.asarray(k), 0, 1)  # (2, batch, ...) for mmfft
    re, im = jmmfft.cfft_axis(p[0], p[1], -3, sign)
    want_y = np.asarray(jnp.swapaxes(jnp.stack([re, im]), 0, 1))
    _close(y_dft(torch.from_numpy(k), sign).numpy(), want_y, "float64")
    k = _pair((2, 2, 3, 16, 16), np.float64, 12)
    re, im = jnp.asarray(k[:, 0]), jnp.asarray(k[:, 1])
    for ax in (-2, -1):
        re, im = jmmfft.cfft_axis(re, im, ax, sign)
    want_zx = np.stack([np.asarray(re), np.asarray(im)], axis=1)
    _close(zx_dft(torch.from_numpy(k), sign).numpy(), want_zx, "float64")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("direction", ["inverse", "forward"])
def test_3d_pair_transforms_match_mmfft(dtype, direction):
    """ifft3_pair / fft3_pair on (narray, 2, Y, Z, X) at 16^3 against the
    JAX package's, which takes (2, narray, Y, Z, X)."""
    k = _pair((2, 2, 16, 16, 16), dtype, 7)
    jfn, fn = {"inverse": (jmmfft.ifft3_pair, mmfft.ifft3_pair),
               "forward": (jmmfft.fft3_pair, mmfft.fft3_pair)}[direction]
    want = np.swapaxes(np.asarray(jfn(jnp.swapaxes(jnp.asarray(k), 0, 1))), 0, 1)
    _close(fn(torch.from_numpy(k)).numpy(), want, dtype)
    t = torch.from_numpy(k.copy())
    assert fn(t, out=t) is t  # in place
    _close(t.numpy(), want, dtype)


def test_twiddle_sign():
    w = twiddles(16, torch.device("cpu"), -1).numpy()
    np.testing.assert_allclose(w[:, 0] + 1j * w[:, 1],
                               np.exp(-2j * np.pi * np.arange(8) / 16), atol=1e-7)
    with pytest.raises(ValueError):
        twiddles(16, torch.device("cpu"), 0)


@pytest.mark.parametrize("n", list(PLAN))
def test_twiddles_take_the_kernels_dtype(n):
    """float32 by default; float64 for the double instances, computed in
    float64 and not rounded to float; no other type."""
    cpu = torch.device("cpu")
    want = np.exp(2j * np.pi * np.arange(n // 2) / n)
    w32, w64 = twiddles(n, cpu), twiddles(n, cpu, +1, torch.float64)
    assert w32.dtype == torch.float32 and w64.dtype == torch.float64
    assert w32.shape == w64.shape == (n // 2, 2)
    np.testing.assert_array_equal(w64.numpy(), np.stack([want.real, want.imag], -1))
    np.testing.assert_array_equal(w32.numpy(), w64.numpy().astype(np.float32))
    with pytest.raises(TypeError, match="float32 and float64"):
        twiddles(n, cpu, +1, torch.float16)


def test_no_plain_route_off_the_cpu():
    """Only a CPU tensor takes the plain versions: another device goes to
    the kernel path, which raises where it has no kernel."""
    pair = torch.empty((2, 2, 16, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        zx_dft(pair, +1)
    with pytest.raises(ValueError, match="no kernel"):
        y_dft(pair, -1)
    with pytest.raises(ValueError, match="want"):
        zx_dft(torch.zeros((2, 2, 16, 8)), +1)  # (z, x) not square


# -- the kernels' schedule (csrc/fft_reg.cuh, csrc/fft_pass.cuh) ---------------

def _model_axis(pair, sign, axis, layout):
    c = torch.complex(torch.from_numpy(pair[:, 0]), torch.from_numpy(pair[:, 1]))
    c = stockham(c.movedim(axis, -1), sign, layout).movedim(-1, axis)
    return torch.stack([c.real, c.imag], 1).numpy()


def test_plan_is_the_headers():
    """The model's plan is the table fft_reg.cuh documents and radix()
    returns."""
    text = (CSRC / "fft_reg.cuh").read_text()
    ns = re.search(r"//\s+N\s+([\d ]+)\n", text).group(1).split()
    rs = re.search(r"//\s+radix\s+([\d, ]+)\n", text).group(1).split()
    assert {int(n): tuple(int(r) for r in rr.split(",")) for n, rr in zip(ns, rs)} == PLAN
    for n, plan in PLAN.items():
        assert np.prod(plan) == n and plan[0] == max(plan)
        assert all(plan[0] % r == 0 for r in plan)


@pytest.mark.parametrize("n", list(PLAN))
@pytest.mark.parametrize("sign", [+1, -1])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_schedule_matches_torch_fft_and_y_tiled_pallas(n, sign, dtype):
    """Along y (the cols layout, as y_dft and zx's z pass run it) against
    torch.fft and (float32) y_tiled_pallas; along x (the rows layout)
    against torch.fft.  The float64 instances' schedule against torch.fft
    in complex128, to 1e-12."""
    zslab = _pair((1, 2, n, 1, 8), dtype, n - sign)
    got = _model_axis(zslab, sign, -3, "cols")
    assert got.dtype == np.dtype(dtype)
    c = torch.complex(torch.from_numpy(zslab[:, 0]), torch.from_numpy(zslab[:, 1]))
    want = (torch.fft.ifft(c, dim=-3, norm="forward") if sign > 0
            else torch.fft.fft(c, dim=-3))
    _close(got, torch.stack([want.real, want.imag], 1).numpy(), dtype)
    if dtype == "float32":
        jwant = np.asarray(y_tiled_pallas(jnp.asarray(zslab), sign, tile=8, interpret=True))
        _close(got, jwant, "float32")
    rows = _pair((3, 2, n), dtype, n + sign)
    got = _model_axis(rows, sign, -1, "rows")
    c = torch.complex(torch.from_numpy(rows[:, 0]), torch.from_numpy(rows[:, 1]))
    want = torch.fft.ifft(c, norm="forward") if sign > 0 else torch.fft.fft(c)
    _close(got, torch.stack([want.real, want.imag], 1).numpy(), dtype)


@pytest.mark.parametrize("n", list(PLAN))
@pytest.mark.parametrize("sign", [+1, -1])
def test_schedule_zx_matches_zx_pallas(n, sign):
    """z in the cols layout, then x in the rows layout, as zt_zx_dft runs
    them, against zx_folded_pallas (n <= 512) or zx_tiled_pallas."""
    spm = _pair((1, 2, 1, n, n), np.float32, 3 * n + sign)
    got = _model_axis(_model_axis(spm, sign, -2, "cols"), sign, -1, "rows")
    fn = zx_folded_pallas if n <= 512 else zx_tiled_pallas
    _close(got, np.asarray(fn(jnp.asarray(spm), sign, interpret=True)), "float32")


@pytest.mark.parametrize("n", list(PLAN))
@pytest.mark.parametrize("sign", [+1, -1])
def test_schedule_zx_float64_matches_torch_fft(n, sign):
    """The double instances' zx (z in the cols layout, then x in the rows
    layout) against torch.fft in complex128, to 1e-12."""
    spm = _pair((1, 2, 1, n, n), np.float64, 5 * n + sign)
    got = _model_axis(_model_axis(spm, sign, -2, "cols"), sign, -1, "rows")
    c = torch.complex(torch.from_numpy(spm[:, 0]), torch.from_numpy(spm[:, 1]))
    want = (torch.fft.ifft2(c, norm="forward") if sign > 0 else torch.fft.fft2(c))
    _close(got, torch.stack([want.real, want.imag], 1).numpy(), "float64")


# -- the tiles of either element type (fft_pass.cuh, fft_axis.cu, synth.cu) ----

def test_tile_model_is_the_headers():
    """Tiles repeats these expressions of the sources."""
    pass_h = (CSRC / "fft_pass.cuh").read_text()
    for text in ("return sizeof(F) == 8 && reg::elems(n) == 16 ? 512 : 1024;",
                 "return sizeof(F) == 4 && n >= 64 && reg::elems(n) == 8 ? 2 : 1;",
                 "constexpr int lo = 32 / (int)sizeof(F), hi = 128 / (int)sizeof(F);",
                 "2 * extent<true>(n) * tx * (int)sizeof(F) > 227 * 1024",
                 "block_threads<F>(n) / (sizeof(F) == 8 && threads < 32 ? 32 : threads)",
                 "cols_c<F>(n) == 1 ? min_blocks<F>(n, cols_threads<F>(n)) : 1"):
        assert text in pass_h, text
    assert "return 4096 / n < n ? 4096 / n : n;" in (CSRC / "fft_axis.cu").read_text()
    synth = (CSRC / "synth.cu").read_text()
    for text in ("sizeof(F) == 8 ? (reg::elems(n) == 16 ? 128 : 256) : n == 2048 ? 128 : 256",
                 "sizeof(F) == 8 ? 2 : n == 2048 ? 3 : reg::elems(n) == 8 ? 3 : 2"):
        assert text in synth, text
    for stem in ("fft_axis", "c2r", "synth", "boxmuller"):  # the double twins
        twin = (CSRC / f"{stem}_f64.cu").read_text()
        assert "#define ZT_F64" in twin and f'#include "{stem}.cu"' in twin


def test_float32_tiles_are_unchanged():
    """The float tiles that PERF.md's float32 times were measured with."""
    got = {n: (Tiles(n, 4).cols_tx, Tiles(n, 4).cols_c, Tiles(n, 4).cols_threads)
           for n in PLAN}
    assert got == {16: (32, 1, 32), 32: (32, 1, 128), 64: (32, 2, 128),
                   128: (32, 1, 256), 256: (32, 1, 512), 512: (32, 2, 1024),
                   1024: (16, 1, 1024), 2048: (8, 1, 1024)}
    assert [Tiles(n, 4).b1_threads for n in PLAN] == [256] * 7 + [128]


@pytest.mark.parametrize("n", list(PLAN))
@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
def test_tiles_fit_the_sm(n, itemsize):
    """Every kernel's block, at every n and for either element type: runs
    of 32 to 128 bytes along a column tile, at most 1024 threads, shared
    memory of all the blocks a SM is budgeted for within 227 KB, and a
    register budget that holds the thread's elements with room for the
    butterflies' temporaries (no spill: chip_smoke.py checks ptxas)."""
    t = Tiles(n, itemsize)
    assert 32 <= t.cols_tx * itemsize <= 128
    assert t.cols_tx % t.cols_c == 0
    if itemsize == 8:
        assert t.cols_c == 1  # a double thread carries one column
        assert t.cols_tx == {512: 16, 1024: 8, 2048: 4}.get(n, 16)
    for threads, blocks, smem, c in (
            (t.cols_threads, t.cols_min_blocks, t.cols_smem, t.cols_c),
            (t.rows_threads, t.rows_min_blocks, t.rows_smem, 1),
            (t.b1_rows * t.T, t.b1_min_blocks, t.b1_smem, 1)):
        assert 1 <= threads <= 1024 and blocks >= 1
        assert smem <= Tiles.SMEM
        # what the budgeted blocks take together fits one SM
        assert min(blocks, 32) * smem <= Tiles.SMEM
        regs = t.registers(threads, blocks)
        assert regs >= 64
        # the elements and as much again for twiddles, temporaries and
        # addresses, up to the 255 a thread can have
        assert regs >= min(255, 2 * t.data_registers(c) - (32 if c == 2 else 0))


@pytest.mark.parametrize("n", list(PLAN))
@pytest.mark.parametrize("layout", ["cols", "rows"])
def test_double_exchanges_add_no_bank_conflicts(n, layout):
    """The padding of the exchanges (one element after 2^S indices) was
    chosen for 4-byte words.  A count of the shared-memory wavefronts of
    every store and load of every warp says it serves 8-byte words as
    well: the column layout is free of conflicts at every n for both
    types (a double thread's one column is float's pair of columns), the
    row layout up to n = 256, and for n >= 512 its worst instruction is
    two-way in float and in double alike."""
    f32, f64 = (exchange_wavefronts(n, size, layout) for size in (4, 8))
    assert f64 == f32
    assert f32 == (2.0 if layout == "rows" and n >= 512 else 1.0)
