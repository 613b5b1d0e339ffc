"""Kernel B2's plain version (c2r along y) against the JAX package.

``zeldovich_tpu_torch.ops.c2r.c2r_y`` runs its plain version on CPU
tensors (torch.fft.irfft).  References: the Pallas kernel
``c2r_y_folded_pallas`` in interpret mode (float32) and the XLA
``mmfft.c2r_y_pair`` (float64).  ``n`` is explicit in the port (ROADMAP
C2): the Nyquist-free input has n/2 ky rows.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.ops import mmfft
from zeldovich_tpu.ops.pallas_fft import c2r_y_folded_pallas
from zeldovich_tpu_torch.ops.c2r import c2r_y

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
