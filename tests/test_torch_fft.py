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
shared-memory exchanges of both kernels) is modelled here in plain torch
(``_stockham``) and held against torch.fft and the Pallas kernels at every
power-of-two n in [16, 2048]; nothing in the package calls the model.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.ops import mmfft as jmmfft
from zeldovich_tpu.ops.pallas_fft import y_tiled_pallas, zx_folded_pallas, zx_tiled_pallas
from zeldovich_tpu_torch.ops import mmfft
from zeldovich_tpu_torch.ops.fft import y_dft, zx_dft
from zeldovich_tpu_torch.ops.synth import twiddles

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


# -- the kernels' schedule (csrc/fft_reg.cuh, csrc/fft_axis.cu) ---------------

PLAN = {16: (16,), 32: (8, 4), 64: (8, 8), 128: (16, 8), 256: (16, 16),
        512: (8, 8, 8), 1024: (16, 8, 8), 2048: (16, 16, 8)}
CSRC = Path(__file__).parent.parent / "zeldovich_tpu_torch" / "csrc"


def _shift(layout, n, p):
    """fft_axis.cu's padding shifts: cols_shift and rows_shift."""
    if layout == "cols":
        return PLAN[n][p].bit_length() - 1
    return 2 if p > 0 else 5 if n >= 512 else PLAN[n][0].bit_length() - 1


def _brev(v, bits):
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def _dft_regs(v, sign):
    """The in-register radix-R DFT: radix-2 decimation in frequency with
    the float32 constants cos(2 pi m / 16), output read in bit-reversed
    order.  v: (..., R) complex64."""
    R = v.shape[-1]
    v = v.clone()
    cos16 = [np.float32(np.cos(2 * np.pi * m / 16)) for m in range(16)]

    def stage(lo, L):
        if L == 1:
            return
        h = L // 2
        for i in range(h):
            a, b = v[..., lo + i].clone(), v[..., lo + i + h].clone()
            v[..., lo + i] = a + b
            d, m = a - b, i * 16 // L
            if m == 4:
                d = torch.complex(-sign * d.imag, sign * d.real)
            elif m:
                w = torch.complex(torch.tensor(cos16[m]),
                                  torch.tensor(sign * cos16[(m + 12) % 16]))
                d = d * w
            v[..., lo + i + h] = d
        stage(lo, h)
        stage(lo + h, h)

    stage(0, R)
    return v[..., [_brev(r, R.bit_length() - 1) for r in range(R)]]


def _stockham(x, sign, layout):
    """The kernels' DFT of the last axis of x (complex64), thread by
    thread: T = n / E threads of E elements, pass p of radix R reads
    j + r n/R, multiplies by w^(r (j mod Ns) n/(Ns R)) from the half table,
    writes (j / Ns) Ns R + j mod Ns + r Ns through the padded exchange."""
    n = x.shape[-1]
    plan, lead = PLAN[n], x.shape[:-1]
    E = plan[0]
    T = n // E
    table = twiddles(n, torch.device("cpu"), sign)
    w = torch.complex(table[:, 0], table[:, 1])
    t = torch.arange(T)
    v = x[..., (t[:, None] + torch.arange(E) * T).flatten()]  # pass 0 loads
    ns = 1
    for p, R in enumerate(plan):
        nb = E // R
        v = v.reshape(*lead, T, nb, R)
        j = t[:, None] + torch.arange(nb) * T  # the thread's butterflies
        if ns > 1:
            k = torch.arange(R) * ((j % ns) * (n // (ns * R)))[..., None]
            tw = w[k % (n // 2)]
            v = v * torch.where(k >= n // 2, -tw, tw)
        v = _dft_regs(v, sign)
        if p + 1 == len(plan):  # the stores: j + r n/R
            idx = j[..., None] + torch.arange(R) * (n // R)
            out = torch.empty_like(x)
            out[..., idx.flatten()] = v.reshape(*lead, n)
            return out
        s = _shift(layout, n, p)
        d = (j // ns) * ns * R + j % ns
        a = d[..., None] + torch.arange(R) * ns
        a = (a + (a >> s)).flatten()
        assert len(set(a.tolist())) == n and int(a.max()) < n + (n >> s)
        buf = torch.full((*lead, n + (n >> s)), complex("nan"), dtype=x.dtype)
        buf[..., a] = v.reshape(*lead, n)
        R2 = plan[p + 1]
        j2 = t[:, None] + torch.arange(E // R2) * T
        a2 = j2[..., None] + torch.arange(R2) * (n // R2)
        v = buf[..., (a2 + (a2 >> s)).flatten()]
        assert not torch.isnan(v.real).any()  # read only what was written
        ns *= R


def _model_axis(pair, sign, axis, layout):
    c = torch.complex(torch.from_numpy(pair[:, 0]), torch.from_numpy(pair[:, 1]))
    c = _stockham(c.movedim(axis, -1), sign, layout).movedim(-1, axis)
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
