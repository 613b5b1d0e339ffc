"""Kernel B3 and the separate-kernel half route against the JAX package.

B3 (``zeldovich_tpu_torch.ops.synth.halfspace_pack``) runs its plain
version on CPU tensors (``modes_real.pack_half_raw``).  Its reference is
the Pallas kernel ``halfspace_pack_pallas`` in interpret mode, as the JAX
package's own tests run it, fed the identical setup state through
``tables_from_jax``.  The route ``xspace_half_pair(kspace_half_pair())``
(B3, the ky=0 fixup, zx, B2) is held against the fused route and against
the JAX package's ``mmfft.ifft3_half_pair`` of its
``synthesize_half_pair``.

Tolerances: the k-space as B1's plain test holds it (1e-6 of the scale,
zero pattern exact); x space float32 1e-5 of the scale, float64 1e-12.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.ops import mmfft
from zeldovich_tpu.ops import modes_real as jmr
from zeldovich_tpu.ops.pallas_synth import halfspace_pack_pallas
from zeldovich_tpu.utils.params import Parameters
from zeldovich_tpu_torch.models.pipeline import Zeldovich
from zeldovich_tpu_torch.ops.mmfft import ifft3_half_pair
from zeldovich_tpu_torch.ops.modes import SynthConfig, tables_from_jax
from zeldovich_tpu_torch.ops.modes_real import fix_ky0_packed
from zeldovich_tpu_torch.ops.synth import halfspace_pack

torch.set_num_threads(1)

ASSETS = Path(__file__).parent.parent / "zeldovich_tpu" / "assets"
PLT = dict(
    ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128"),
    ZD_qPLT_rescale=1, ZD_PLT_target_z=5.0,
)
CASES = {
    "plain": {},
    "plt": PLT,
    "fixed": dict(ZD_qPk_fix_to_mean=1),
    "density_only": dict(ZD_qdensity=2),
}
TOL = {"float32": 1e-5, "float64": 1e-12}


def _param(ppd, **over):
    d = dict(
        BoxSize=100.0, NP=ppd**3, CPD=100, ICFormat="RVZel",
        InitialConditionsDirectory="/tmp/ic_torch_halfpack", InitialRedshift=49.0,
        ZD_Seed=97531, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
        ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0,
        ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
    )
    d.update(over)
    return Parameters.from_dict(d)


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


@pytest.mark.parametrize("ppd", [16, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_b3_plain_matches_pallas_interpret(ppd, case):
    m = JZeldovich(_param(ppd, **CASES[case]), dtype=jnp.float32)
    cfg, tables, pk, coefs = _carry(m)
    t = m.tables
    want = np.asarray(halfspace_pack_pallas(
        m.cfg, t.planes, t.mzx, t.czx, m.pk_eff, fixed_power=m.cfg.fixed_power,
        just_density=m.cfg.just_density, interpret=True, plt_coefs=m.plt_coefs,
    ))
    got = halfspace_pack(cfg, tables, pk, coefs).numpy()
    half = ppd // 2
    assert got.shape == want.shape == (cfg.narray, 2, 2, half + 1, ppd, ppd)
    assert np.all(got[:, :, :, half] == 0)  # the y-Nyquist row
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_b3_has_no_plain_route_off_the_cpu():
    m = Zeldovich(_param(16), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="no kernel"):
        halfspace_pack(m.cfg, m.tables, torch.empty((8, 16, 16), device="meta"))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_separate_kernel_half_route(case, dtype):
    p = _param(16, **CASES[case])
    m = Zeldovich(p, dtype=getattr(torch, dtype), device="cpu")
    spm = m.kspace_half_pair()
    got = m.xspace_half_pair(spm).numpy()
    fused = m.xspace_half_pair().numpy()
    assert got.shape == fused.shape == (m.cfg.narray, 2, 16, 16, 16)
    np.testing.assert_allclose(got, fused, rtol=0,
                               atol=TOL[dtype] * np.abs(fused).max())

    jm = JZeldovich(p, dtype=getattr(jnp, dtype))
    jspm = jmr.synthesize_half_pair(jm.cfg, jm.tables, dtype=getattr(jnp, dtype),
                                    pk_eff=jm.pk_eff)
    np.testing.assert_allclose(spm.numpy(), np.asarray(jspm), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jspm)).max())
    want = np.asarray(mmfft.ifft3_half_pair(jspm))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * np.abs(want).max())


def test_kspace_half_pair_refuses_non_hermitian_configurations():
    m = Zeldovich(_param(16, ZD_f_NL=10.0, ZD_n_s=0.96, Omega_M=0.3), dtype=torch.float32,
                  device="cpu")
    with pytest.raises(NotImplementedError, match="full-grid"):
        m.kspace_half_pair()


@pytest.mark.parametrize("case", ["plain", "plt"])
def test_carried_tables_of_a_float64_model(case):
    """tables_from_jax carries a float64 JAX model's state without
    narrowing it: pk_n2, the eigenmodes, pk_eff and the PLT planes stay
    float64, and B3's plain version and the separate-kernel route on them
    give the JAX package's float64 answer to 1e-12."""
    jm = JZeldovich(_param(16, **CASES[case]), dtype=jnp.float64)
    cfg, tables, pk, coefs = _carry(jm)
    assert tables.pk_n2.dtype == pk.dtype == torch.float64
    assert tables.eig is None or tables.eig.dtype == torch.float64
    assert coefs is None or coefs.dtype == torch.float64
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jm.pk_eff))
    spm = fix_ky0_packed(halfspace_pack(cfg, tables, pk, coefs))
    assert spm.dtype == torch.float64
    jspm = jmr.synthesize_half_pair(jm.cfg, jm.tables, dtype=jnp.float64,
                                    pk_eff=jm.pk_eff)
    np.testing.assert_allclose(spm.numpy(), np.asarray(jspm), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(jspm)).max())
    want = np.asarray(mmfft.ifft3_half_pair(jspm))
    got = ifft3_half_pair(spm).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
