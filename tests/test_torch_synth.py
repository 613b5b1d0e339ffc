"""Setup fields and kernel B1's plain version against the JAX package.

B1 (``zeldovich_tpu_torch.ops.synth.halfspace_pack_zx``) runs its plain
version on CPU tensors: the plain half-spectrum synthesis followed by
torch.fft over (z, x).  Its reference is the Pallas kernel
``halfspace_pack_zx_pallas`` run in interpret mode, as the JAX package's
own tests run it, fed the identical setup state through
``tables_from_jax``.  The CUDA kernel itself is checked against the same
plain version on the card by chip_smoke.py.

``_b1_model`` is B1 as the kernel runs it (csrc/synth.cu): the raw
packings (``pack_rows``), the index-pure ky=0 rule (a mirror-half element
is the conjugate of its source mode's opposite packing), x in the row
layout, then z in the column layout of the kernels' schedule
(tests/torch_fft_model.py).
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.ops import mmfft
from zeldovich_tpu.ops import modes_real as jmr
from zeldovich_tpu.ops.pallas_synth import halfspace_pack_zx_pallas
from zeldovich_tpu.utils.params import Parameters
from zeldovich_tpu_torch.ops import modes_real as tmr
from zeldovich_tpu_torch.ops.modes import SynthConfig, SynthTables, tables_from_jax
from zeldovich_tpu_torch.ops.synth import (
    check_kernel_size, halfspace_pack_zx, halfspace_pack_zx_plain,
)
from torch_fft_model import stockham

torch.set_num_threads(1)

ASSETS = Path(__file__).parent.parent / "zeldovich_tpu" / "assets"
PLT = dict(
    ZD_qPLT=1,
    ZD_PLT_filename=str(ASSETS / "eigmodes128"),
    ZD_qPLT_rescale=1,
    ZD_PLT_target_z=5.0,
)


def _keys(ppd, **over):
    d = dict(
        BoxSize=100.0, NP=ppd**3, CPD=100, ICFormat="RVZel",
        InitialConditionsDirectory="/tmp/ic_torch_synth", InitialRedshift=49.0,
        ZD_Seed=97531, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
        ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0,
        ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
    )
    d.update(over)
    return d


def _param(ppd, **over):
    return Parameters.from_dict(_keys(ppd, **over))


def _carry(m):
    """The JAX model's setup state as the port's tensors."""
    t = m.tables
    N = lambda tup: tuple(np.asarray(a) for a in tup)
    coefs = m.plt_coefs
    tables, pk, pc = tables_from_jax(
        N(t.planes), N(t.mz), N(t.cz), N(t.mx), N(t.cx), N(t.mzx), N(t.czx),
        np.asarray(t.pk_n2), None if t.eig is None else np.asarray(t.eig),
        pk_eff=np.asarray(m.pk_eff), plt_coefs=None if coefs is None else N(coefs),
        device="cpu"
    )
    return SynthConfig.from_params(m.param, m.Pk.fixed_power), tables, pk, pc


def _assert_zero_pattern(got, want, tol):
    """Exact zeros of either side are zeros (to tol) of the other.  After
    the transforms exact zeros depend on the FFT algorithm (a folded DFT
    cancels some symmetric sums exactly, an FFT to ~1e-9)."""
    assert np.all(np.abs(got[want == 0]) <= tol)
    assert np.all(np.abs(want[got == 0]) <= tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pk_effective_bit_equal(dtype):
    p = _param(16, ZD_k_cutoff=2.0)
    m = JZeldovich(p, dtype=getattr(jnp, dtype))
    cfg = SynthConfig.from_params(p, m.Pk.fixed_power)
    port = SynthTables.build(p.seed, p.ppd, np.asarray(m.tables.pk_n2), device="cpu")
    got = tmr.pk_effective(cfg, port, getattr(torch, dtype)).numpy()
    np.testing.assert_array_equal(got, np.asarray(m.pk_eff))


@pytest.mark.parametrize("ppd", [16, 24])  # direct gather; trilinear
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plt_coef_fields(ppd, dtype):
    m = JZeldovich(_param(ppd, **PLT), dtype=getattr(jnp, dtype))
    cfg, tables, _, _ = _carry(m)
    got = tmr.plt_coef_fields(cfg, tables, getattr(torch, dtype)).numpy()
    want = np.stack([np.asarray(c) for c in m.plt_coefs])
    if dtype == "float32":
        # same expressions in the same order; library sqrt/pow may round
        # differently by an ulp.  Components that nearly cancel in the
        # interpolation carry absolute error, so the bound is 4 ulp of
        # each plane's largest value
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=4 * 2.0**-23 * np.abs(w).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("case", ["plain", "fixed", "plt"])
def test_b1_plain_matches_pallas_interpret(case):
    over = {"plain": {}, "fixed": {"ZD_qPk_fix_to_mean": 1}, "plt": PLT}[case]
    m = JZeldovich(_param(16, **over), dtype=jnp.float32)
    cfg, tables, pk, coefs = _carry(m)
    t = m.tables

    # k-space first: the untransformed synthesis, zero pattern exact
    spm = tmr.synthesize_half_pair(cfg, tables, torch.float32, pk, coefs).numpy()
    jspm = np.asarray(
        jmr.synthesize_half_pair(m.cfg, t, dtype=jnp.float32, pk_eff=m.pk_eff)
    )
    np.testing.assert_array_equal(spm == 0, jspm == 0)
    np.testing.assert_allclose(spm, jspm, rtol=0, atol=1e-6 * np.abs(jspm).max())

    want = np.asarray(halfspace_pack_zx_pallas(
        m.cfg, t.planes, t.mzx, t.czx, m.pk_eff, fixed_power=m.cfg.fixed_power,
        just_density=m.cfg.just_density, interpret=True, plt_coefs=m.plt_coefs,
    ))
    half = cfg.ppd // 2
    assert np.all(want[:, :, :, half] == 0)  # the row B1 omits
    want = want[:, :, :, :half]
    got = halfspace_pack_zx(cfg, tables, pk, coefs).numpy()
    assert got.shape == want.shape == (cfg.narray, 2, 2, half, 16, 16)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    _assert_zero_pattern(got, want, 1e-6 * scale)


@pytest.mark.parametrize("case", ["plain", "plt"])
def test_b1_plain_float64_matches_xla_composition(case):
    m = JZeldovich(_param(16, **(PLT if case == "plt" else {})), dtype=jnp.float64)
    cfg, tables, pk, coefs = _carry(m)
    spm = jmr.synthesize_half_pair(m.cfg, m.tables, dtype=jnp.float64,
                                   pk_eff=m.pk_eff)
    re, im = spm[..., 0, :, :, :], spm[..., 1, :, :, :]
    for ax in (-2, -1):
        re, im = mmfft.cfft_axis(re, im, ax, +1)
    want = np.asarray(jnp.stack([re, im], axis=-4))[:, :, :, :8]
    got = halfspace_pack_zx(cfg, tables, pk, coefs).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_density_only_packs_one_array():
    m = JZeldovich(_param(16, ZD_qdensity=2), dtype=jnp.float32)
    cfg, tables, pk, _ = _carry(m)
    spm = tmr.synthesize_half_pair(cfg, tables, torch.float32, pk).numpy()
    jspm = np.asarray(jmr.synthesize_half_pair(
        m.cfg, m.tables, dtype=jnp.float32, pk_eff=m.pk_eff))
    assert spm.shape == jspm.shape == (1, 2, 2, 9, 16, 16)
    np.testing.assert_allclose(spm, jspm, rtol=0, atol=1e-6 * np.abs(jspm).max())


@pytest.mark.parametrize("n", [8, 24, 96, 4096])
def test_kernel_sizes_outside_the_range_raise(n):
    with pytest.raises(ValueError, match="ROADMAP"):
        check_kernel_size(n)


# -- the kernel's two launches (csrc/synth.cu) ---------------------------------

def _b1_model(cfg, tables, pk, coefs, ky0=0):
    """(narray, 2, 2, rows, Z, X) for the planes [ky0, ky0 + rows)."""
    raw = tmr.pack_rows(cfg, tables, torch.float32, pk, coefs, ky0)
    c = torch.complex(raw[:, :, 0], raw[:, :, 1])  # (narray, pm, rows, Z, X)
    if ky0 == 0:
        n, h = cfg.ppd, cfg.ppd // 2
        z, x = torch.arange(n)[:, None], torch.arange(n)[None, :]
        mirror = (z > h) | ((z == 0) & (x > h))
        zs = torch.where(z > h, n - z, z).expand(n, n)
        xs = torch.where(mirror, (n - x) % n, x)
        source = c[:, :, 0].flip(1)[:, :, zs, xs].conj()  # the opposite packing
        plane = torch.where(mirror, source, c[:, :, 0])
        plane[:, :, 0, 0] = 0.0  # the origin
        c[:, :, 0] = plane
    c = stockham(c, +1, "rows")  # launch 1: x, with the synthesis
    c = stockham(c.transpose(-1, -2), +1, "cols").transpose(-1, -2)  # launch 2: z
    return torch.stack([c.real, c.imag], dim=2)


@pytest.mark.parametrize("ppd", [16, 32])
@pytest.mark.parametrize("case", ["plain", "fixed", "plt"])
def test_b1_model_matches_pallas_interpret(ppd, case):
    over = {"plain": {}, "fixed": {"ZD_qPk_fix_to_mean": 1}, "plt": PLT}[case]
    m = JZeldovich(_param(ppd, **over), dtype=jnp.float32)
    cfg, tables, pk, coefs = _carry(m)
    t = m.tables
    want = np.asarray(halfspace_pack_zx_pallas(
        m.cfg, t.planes, t.mzx, t.czx, m.pk_eff, fixed_power=m.cfg.fixed_power,
        just_density=m.cfg.just_density, interpret=True, plt_coefs=m.plt_coefs,
    ))[:, :, :, :ppd // 2]
    got = _b1_model(cfg, tables, pk, coefs).numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    _assert_zero_pattern(got, want, 1e-6 * scale)


@pytest.mark.parametrize("ppd", [64, 128])
@pytest.mark.parametrize("case", ["plain", "plt", "density"])
def test_b1_model_matches_plain_on_planes(ppd, case):
    """The planes [0, 2) (the ky=0 rule) and [half - 1, half), each as a
    call of its own (ky0), against the plain version of those planes and
    the full plain version's."""
    from zeldovich_tpu_torch.models.pipeline import Zeldovich
    from zeldovich_tpu_torch.utils.params import Parameters as TParameters

    over = {"plain": {}, "plt": PLT, "density": {"ZD_qdensity": 2}}[case]
    m = Zeldovich(TParameters.from_dict(_keys(ppd, **over)), dtype=torch.float32,
                  device="cpu")
    half = ppd // 2
    full = halfspace_pack_zx_plain(m.cfg, m.tables, m.pk_eff, m.plt_coefs)
    for y0, y1 in ((0, 2), (half - 1, half)):
        pk = tmr.pk_effective(m.cfg, m.tables, torch.float32, (y0, y1))
        assert torch.equal(pk, m.pk_eff[y0:y1])
        coefs = (tmr.plt_coef_fields(m.cfg, m.tables, torch.float32, (y0, y1))
                 if case == "plt" else None)
        want = halfspace_pack_zx_plain(m.cfg, m.tables, pk, coefs, y0)
        torch.testing.assert_close(want, full[:, :, :, y0:y1], rtol=0,
                                   atol=1e-6 * full.abs().max().item())
        got = _b1_model(m.cfg, m.tables, pk, coefs, y0)
        scale = want.abs().max().item()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * scale)
