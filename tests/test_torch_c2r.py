"""Kernel B2's plain version (c2r along y) against the JAX package.

``zeldovich_tpu_torch.ops.c2r.c2r_y`` runs its plain version on CPU
tensors (torch.fft.irfft).  References: the Pallas kernel
``c2r_y_folded_pallas`` in interpret mode (float32) and the XLA
``mmfft.c2r_y_pair`` (float64).  ``n`` is explicit in the port (ROADMAP
C2): the Nyquist-free input has n/2 ky rows.

The CUDA kernel is the column pass of csrc/fft_pass.cuh fed by its own
loader (csrc/c2r.cu, C2rLoad); ``_c2r_model`` forms each column as the
loader does and transforms it with the kernels' schedule
(tests/torch_fft_model.py), held against the Pallas kernel and the plain
version at every n of the kernels.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.ops import mmfft
from zeldovich_tpu.ops.pallas_fft import c2r_y_folded_pallas
from zeldovich_tpu_torch.ops.c2r import c2r_y, c2r_y_plain
from torch_fft_model import PLAN, stockham

torch.set_num_threads(1)


def _spm(n, rows, dtype, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, 2, 2, rows, n, n)).astype(dtype)


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("nyquist", [True, False])
def test_b2_plain_matches_pallas_interpret(n, nyquist):
    h = n // 2
    spm = _spm(n, h + 1, np.float32)
    if not nyquist:
        spm[:, :, :, h] = 0.0  # the Pallas reference reads the zero row
    want = np.asarray(c2r_y_folded_pallas(jnp.asarray(spm), interpret=True))
    got = c2r_y(torch.from_numpy(spm if nyquist else spm[:, :, :, :h].copy()), n)
    assert got.shape == want.shape == (2, 2, n, n, n)
    # both are float32 transforms of length n: a few 1e-8 of the scale
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4e-7 * np.abs(want).max())


@pytest.mark.parametrize("nyquist", [True, False])
def test_b2_plain_float64_matches_c2r_y_pair(nyquist):
    n, h = 32, 16
    spm = _spm(n, h + 1, np.float64, seed=8)
    if not nyquist:
        spm[:, :, :, h] = 0.0
    want = np.asarray(mmfft.c2r_y_pair(jnp.asarray(spm)))
    got = c2r_y(torch.from_numpy(spm if nyquist else spm[:, :, :, :h].copy()), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_b2_takes_n_explicitly():
    """n = 18 (n = 2 mod 4): the Nyquist-free form has 9 ky rows, which
    the JAX kernel's parity rule would read as n = 16 with a Nyquist row.
    Told n, the port gives the 9-row and the 10-row forms one answer."""
    n, h = 18, 9
    spm = _spm(n, h + 1, np.float64, seed=4)
    spm[:, :, :, h] = 0.0
    with_nyq = c2r_y(torch.from_numpy(spm), n).numpy()
    without = c2r_y(torch.from_numpy(spm[:, :, :, :h].copy()), n).numpy()
    np.testing.assert_array_equal(with_nyq, without)
    np.testing.assert_allclose(
        without, np.asarray(mmfft.c2r_y_pair(jnp.asarray(spm))), rtol=0,
        atol=1e-12 * np.abs(with_nyq).max(),
    )
    with pytest.raises(ValueError):
        c2r_y(torch.from_numpy(spm[:, :, :, :h - 1].copy()), n)


def test_no_plain_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel path, which raises where it has no kernel."""
    from zeldovich_tpu_torch.ops.synth import halfspace_pack_zx

    spm = torch.empty((2, 2, 2, 9, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        c2r_y(spm, 16)
    with pytest.raises(ValueError, match="no kernel"):
        halfspace_pack_zx(None, None, torch.empty((8, 16, 16), device="meta"))


# -- the kernel's column loader (csrc/c2r.cu, C2rLoad) ------------------------

def _c2r_model(spm, n):
    """B2 as the kernel runs it: element k of each (z, x) column is
    S+(k) for 0 < k < n/2, conj S-(n - k) for k > n/2, and
    (Re D~, Re F~) = ((S+re + S-re) / 2, (S+im - S-im) / 2) for k = 0 and
    k = n/2 (zero without the Nyquist row); then the column layout's
    Stockham passes along y.  spm (narray, 2, 2, ky, Bz, X) float32."""
    h, rows = n // 2, spm.shape[-3]
    k = torch.arange(n)
    row = torch.where(k <= h, k, n - k).clamp(max=rows - 1)  # the row k reads
    spr, spi, smr, smi = (spm[:, pm, ri][:, row] for pm in (0, 1) for ri in (0, 1))
    edge = ((k == 0) | (k == h))[:, None, None]
    low = (k < h)[:, None, None]
    re = torch.where(edge, 0.5 * (spr + smr), torch.where(low, spr, smr))
    im = torch.where(edge, 0.5 * (spi - smi), torch.where(low, spi, -smi))
    if rows == h:  # no Nyquist row: Z(n/2) = 0
        re[:, h] = im[:, h] = 0.0
    col = stockham(torch.complex(re, im).movedim(1, -1), +1, "cols").movedim(-1, 1)
    return torch.stack([col.real, col.imag], dim=1)


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("nyquist", [True, False])
def test_b2_loader_model_matches_pallas_interpret(n, nyquist):
    h = n // 2
    spm = _spm(n, h + 1, np.float32, seed=n + nyquist)
    if not nyquist:
        spm[:, :, :, h] = 0.0  # the Pallas reference reads the zero row
    want = np.asarray(c2r_y_folded_pallas(jnp.asarray(spm), interpret=True))
    got = _c2r_model(torch.from_numpy(spm if nyquist else spm[:, :, :, :h].copy()), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("n", list(PLAN))
@pytest.mark.parametrize("nyquist", [True, False])
def test_b2_loader_model_matches_plain(n, nyquist):
    """Every n of the kernels, on a few (z, x) columns."""
    spm = np.random.default_rng(n).normal(
        size=(2, 2, 2, n // 2 + nyquist, 1, 6)).astype(np.float32)
    spm = torch.from_numpy(spm)
    want = c2r_y_plain(spm, n).numpy()
    np.testing.assert_allclose(_c2r_model(spm, n).numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 2, 2, 8, 16, 16), (1, 2, 2, 16, 3, 10)])
def test_b2_in_place(shape):
    """out=g (ky = n/2: the main path's call) gives the out-of-place result
    in g's own memory; a separate out buffer too."""
    n, rng = 2 * shape[3], np.random.default_rng(9)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    want = c2r_y(g, n)
    ptr = g.data_ptr()
    got = c2r_y(g, n, out=g)
    assert got.data_ptr() == ptr and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    spm = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    out = torch.empty(want.shape)
    assert c2r_y(spm, n, out=out) is out
    torch.testing.assert_close(out, c2r_y(spm, n), rtol=0, atol=0)


def test_b2_out_raises():
    """In place needs ky = n/2 rows: with the Nyquist row (ky = n/2 + 1)
    the output is larger than the input; an out of another shape, or one
    sharing the input's memory, raises too."""
    g = torch.zeros((2, 2, 2, 9, 16, 16))
    with pytest.raises(ValueError, match="in place"):
        c2r_y(g, 16, out=g)
    g = torch.zeros((2, 2, 2, 8, 16, 16))
    with pytest.raises(ValueError, match="want out"):
        c2r_y(g, 16, out=torch.empty((2, 2, 16, 16, 8)))
    with pytest.raises(ValueError, match="shares memory"):
        c2r_y(g, 16, out=g.view(2, 2, 16, 16, 16))
