"""The full-grid pair path (f_NL, CornerModes with k_cutoff != 1,
ZD_Version=1) against the JAX package.

``zeldovich_tpu_torch`` runs the plain versions of kernels B4, B6/B7 and
B8 on CPU tensors.  References, in the same process:

* ``synthesize_full_fast_pair`` (the phi pass and the f_NL input pass)
  against the JAX function of that name at 16^3;
* ``Zeldovich.xspace_pair`` against JAX ``xspace_pair`` at 32^3 (its B4
  in interpret mode);
* ZD_Version=1 against JAX's complex ``xspace()``: the JAX pair path
  ignores the v1 field (ROADMAP C6), the port does not;
* the CLI's ``ic_*`` files of an f_NL run against JAX ``run_pair``.

Tolerances: float32 1e-5 of the scale, float64 1e-12 (the draws' log and
cos/sin and the transforms round differently; tests/test_torch_boxmuller.py
and tests/test_torch_fft.py state the per-kernel bounds).
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.ops import modes_real as jmr
from zeldovich_tpu.utils.output import read_particles
from zeldovich_tpu.utils.params import Parameters
from zeldovich_tpu_torch.cli import main
from zeldovich_tpu_torch.models.pipeline import Zeldovich
from zeldovich_tpu_torch.ops.modes import SynthTables, tables_from_jax
from zeldovich_tpu_torch.ops.modes_real import synthesize_full_fast_pair

torch.set_num_threads(1)

ASSETS = Path(__file__).parent.parent / "zeldovich_tpu" / "assets"
BASE = dict(
    BoxSize=100.0, CPD=8, ICFormat="RVZel", InitialRedshift=49.0,
    ZD_Seed=97531, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
    ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0,
    ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
)
FNL = dict(ZD_f_NL=30.0, ZD_n_s=0.96, Omega_M=0.3)
PLT = dict(
    ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128"),
    ZD_qPLT_rescale=1, ZD_PLT_target_z=5.0,
)
CASES = {
    "fnl": FNL,
    "fnl_plt": dict(FNL, **PLT),
    "corner_kcut2": dict(ZD_CornerModes=1, ZD_k_cutoff=2.0),
    # the half path's other options, on the full grid through f_NL
    "fnl_qonemode": dict(FNL, ZD_qonemode=1, ZD_one_mode=[1, 2, 3]),
    "fnl_pk_smooth": dict(FNL, ZD_Pk_smooth=2.0),
    "fnl_fixed_power": dict(FNL, ZD_qPk_fix_to_mean=1),
    "fnl_density_only": dict(FNL, ZD_qdensity=2),
}
TOL = {"float32": 1e-5, "float64": 1e-12}


def _param(ppd, outdir="/tmp/ic_torch_fullgrid", **over):
    return Parameters.from_dict(
        dict(BASE, NP=ppd**3, InitialConditionsDirectory=str(outdir), **over)
    )


def _close(got, want, dtype):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * np.abs(want).max())


def test_tables_carry_M_n2():
    """The f_NL M(k) table rides in SynthTables, equal to the JAX one."""
    p = _param(16, **FNL)
    jm = JZeldovich(p, dtype=jnp.float64)
    want = np.asarray(jm.tables.M_n2)
    port = Zeldovich(p, dtype=torch.float64, device="cpu").tables
    np.testing.assert_array_equal(port.M_n2.numpy(), want)
    t = jm.tables
    N = lambda tup: tuple(np.asarray(a) for a in tup)
    carried, _, _ = tables_from_jax(
        N(t.planes), N(t.mz), N(t.cz), N(t.mx), N(t.cx), N(t.mzx), N(t.czx),
        np.asarray(t.pk_n2), M_n2=want, device="cpu"
    )
    np.testing.assert_array_equal(carried.M_n2.numpy(), want)
    assert SynthTables.build(1, 16, np.asarray(t.pk_n2), device="cpu").M_n2 is None


@pytest.mark.parametrize("pass_", ["gen_phi", "phi_pair"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_synthesize_full_fast_pair_matches_jax(pass_, dtype):
    p = _param(16, **FNL, **PLT)
    jm = JZeldovich(p, dtype=getattr(jnp, dtype))
    m = Zeldovich(p, dtype=getattr(torch, dtype), device="cpu")
    kw, jkw = {}, {}
    if pass_ == "gen_phi":
        kw, jkw = dict(gen_phi=True), dict(gen_phi=True)
    else:  # any phi(k) pair: the input pass is linear in it
        phi = np.random.default_rng(4).normal(size=(2, 16, 16, 16)).astype(dtype)
        kw, jkw = dict(phi_pair=torch.from_numpy(phi)), dict(phi_pair=jnp.asarray(phi))
    want = np.asarray(jmr.synthesize_full_fast_pair(
        jm.cfg, jm.tables, dtype=getattr(jnp, dtype), pk_eff=jm.pk_eff, **jkw))
    got = synthesize_full_fast_pair(
        m.cfg, m.tables, getattr(torch, dtype), pk_eff=m.pk_eff, **kw).numpy()
    assert got.shape == ((1, 2) if pass_ == "gen_phi" else (4, 2)) + (16,) * 3
    _close(got, want, dtype)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_xspace_pair_matches_jax(case, dtype):
    p = _param(32, **CASES[case])
    want = np.asarray(JZeldovich(p, dtype=getattr(jnp, dtype)).xspace_pair())
    m = Zeldovich(p, dtype=getattr(torch, dtype), device="cpu")
    assert not m.half_exact
    got = m.xspace_half_pair().numpy()  # falls back to the full grid
    assert got.shape == (m.cfg.narray, 2, 32, 32, 32)
    _close(got, want, dtype)


def test_f_nl_term_is_visible():
    """f_NL = 30 moves x space by far more than the f32 tolerance."""
    with_fnl = Zeldovich(_param(32, **FNL), dtype=torch.float32,
                         device="cpu").xspace_pair().numpy()
    without = Zeldovich(_param(32, **dict(FNL, ZD_f_NL=0.0)), dtype=torch.float32,
                        device="cpu").xspace_pair().numpy()
    assert np.abs(with_fnl - without).max() > 1e-3 * np.abs(without).max()


def test_version1_matches_jax_complex_path():
    p = _param(16, ZD_Version=1)
    x = np.asarray(JZeldovich(p, dtype=jnp.float64).xspace())
    want = np.stack([x.real, x.imag], axis=1)
    m = Zeldovich(p, dtype=torch.float64, device="cpu")
    assert not m.half_exact
    got = m.xspace_half_pair().numpy()
    _close(got, want, "float64")
    v2 = Zeldovich(_param(16), dtype=torch.float64, device="cpu").xspace_half_pair().numpy()
    assert np.abs(got - v2).max() > 0.1 * np.abs(v2).max()


def _write_par(path, ppd, outdir, **over):
    d = dict(BASE, NP=ppd**3, InitialConditionsDirectory=str(outdir), **over)
    path.write_text("".join(
        f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
        for k, v in d.items()
    ))
    return path


def test_cli_f_nl_ic_files_match_jax_run_pair(tmp_path):
    ppd = 32
    jax_dir, cli_dir = tmp_path / "jax", tmp_path / "cli"
    JZeldovich(_param(ppd, jax_dir, **FNL), dtype=jnp.float32).run_pair()
    par = _write_par(tmp_path / "run.par", ppd, cli_dir, **FNL)
    assert main([str(par), "--device", "cpu", "--dtype", "float32"]) == 0

    names = sorted(f.name for f in jax_dir.glob("ic_*"))
    assert names and names == sorted(f.name for f in cli_dir.glob("ic_*"))
    total = 0
    for name in names:
        want = read_particles(jax_dir / name, "RVZel")
        got = read_particles(cli_dir / name, "RVZel")
        total += got.nbytes
        for f in ("i", "j", "k"):
            np.testing.assert_array_equal(got[f], want[f])
        for f in ("displ", "vel"):
            np.testing.assert_allclose(
                got[f], want[f], rtol=0, atol=1e-5 * np.abs(want[f]).max()
            )
    assert total == ppd**3 * 32
