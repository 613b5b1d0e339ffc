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
from torch_fft_model import CSRC, PLAN, stockham

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
def test_schedule_matches_torch_fft_and_y_tiled_pallas(n, sign):
    """Along y (the cols layout, as y_dft and zx's z pass run it) against
    torch.fft and y_tiled_pallas; along x (the rows layout) against
    torch.fft."""
    zslab = _pair((1, 2, n, 1, 8), np.float32, n - sign)
    got = _model_axis(zslab, sign, -3, "cols")
    c = torch.complex(torch.from_numpy(zslab[:, 0]), torch.from_numpy(zslab[:, 1]))
    want = (torch.fft.ifft(c, dim=-3, norm="forward") if sign > 0
            else torch.fft.fft(c, dim=-3))
    _close(got, torch.stack([want.real, want.imag], 1).numpy(), "float32")
    jwant = np.asarray(y_tiled_pallas(jnp.asarray(zslab), sign, tile=8, interpret=True))
    _close(got, jwant, "float32")
    rows = _pair((3, 2, n), np.float32, n + sign)
    got = _model_axis(rows, sign, -1, "rows")
    c = torch.complex(torch.from_numpy(rows[:, 0]), torch.from_numpy(rows[:, 1]))
    want = torch.fft.ifft(c, norm="forward") if sign > 0 else torch.fft.fft(c)
    _close(got, torch.stack([want.real, want.imag], 1).numpy(), "float32")


@pytest.mark.parametrize("n", list(PLAN))
@pytest.mark.parametrize("sign", [+1, -1])
def test_schedule_zx_matches_zx_pallas(n, sign):
    """z in the cols layout, then x in the rows layout, as zt_zx_dft runs
    them, against zx_folded_pallas (n <= 512) or zx_tiled_pallas."""
    spm = _pair((1, 2, 1, n, n), np.float32, 3 * n + sign)
    got = _model_axis(_model_axis(spm, sign, -2, "cols"), sign, -1, "rows")
    fn = zx_folded_pallas if n <= 512 else zx_tiled_pallas
    _close(got, np.asarray(fn(jnp.asarray(spm), sign, interpret=True)), "float32")
