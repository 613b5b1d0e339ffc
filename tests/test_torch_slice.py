"""The port's main path end to end against the JAX package, at 32^3.

``zeldovich_tpu_torch`` Zeldovich.xspace_half_pair (plain versions of
kernels B1 and B2 on CPU tensors) against the JAX package's
xspace_half_pair, and the port's CLI ic_* files against the JAX
package's run_pair, read back with read_particles.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.utils.output import read_particles
from zeldovich_tpu.utils.params import Parameters
from zeldovich_tpu_torch.cli import main
from zeldovich_tpu_torch.models.outofcore import OutOfCoreZeldovich
from zeldovich_tpu_torch.models.pipeline import Zeldovich

torch.set_num_threads(1)

ASSETS = Path(__file__).parent.parent / "zeldovich_tpu" / "assets"
BASE = dict(
    BoxSize=100.0, CPD=8, ICFormat="RVZel", InitialRedshift=49.0,
    ZD_Seed=97531, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
    ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0,
    ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
)
PLT = dict(
    ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128"),
    ZD_qPLT_rescale=1, ZD_PLT_target_z=5.0,
)


def _param(ppd, outdir, **over):
    return Parameters.from_dict(
        dict(BASE, NP=ppd**3, InitialConditionsDirectory=str(outdir), **over)
    )


def _write_par(path, ppd, outdir, **over):
    d = dict(BASE, NP=ppd**3, InitialConditionsDirectory=str(outdir), **over)
    path.write_text("".join(
        f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
        for k, v in d.items()
    ))
    return path


@pytest.mark.parametrize("plt", [False, True], ids=["plain", "plt"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
def test_xspace_half_pair_matches_jax(tmp_path, plt, dtype, tol):
    p = _param(32, tmp_path, **(PLT if plt else {}))
    want = np.asarray(JZeldovich(p, dtype=getattr(jnp, dtype)).xspace_half_pair())
    got = Zeldovich(p, dtype=getattr(torch, dtype),
                    device="cpu").xspace_half_pair().numpy()
    assert got.shape == want.shape == (4 if plt else 2, 2, 32, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("model", [Zeldovich, OutOfCoreZeldovich])
@pytest.mark.parametrize("step", ["xspace_half_pair", "xspace_pair"])
def test_models_default_to_the_jax_packages_float64(tmp_path, model, step):
    """With no dtype, the port's models compute in float64 as the JAX
    package's Zeldovich(param) does, and agree with it to 1e-12."""
    p = _param(16, tmp_path, **PLT)
    want = np.asarray(getattr(JZeldovich(p), step)())
    m = model(p, device="cpu")
    assert m.dtype == torch.float64
    got = getattr(m, step)().numpy()
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    if model is OutOfCoreZeldovich:
        assert m.stage_layout()[1] == np.float64


def test_cli_ic_files_match_jax_run_pair(tmp_path):
    ppd = 32
    jax_dir, cli_dir, run_dir = (tmp_path / d for d in ("jax", "cli", "run"))
    jm = JZeldovich(_param(ppd, jax_dir), dtype=jnp.float32)
    want_qa = jm.run_pair().report(jm.Pk)
    par = _write_par(tmp_path / "run.par", ppd, cli_dir)
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

    # the QA statistics, and the CLI's bytes are run_pair's bytes
    p = _param(ppd, run_dir)
    model = Zeldovich(p, dtype=torch.float32, device="cpu")
    got_qa = model.run_pair().report(model.Pk)
    assert got_qa["rms_density"] == pytest.approx(want_qa["rms_density"], rel=1e-6)
    np.testing.assert_allclose(got_qa["max_disp"], want_qa["max_disp"], rtol=1e-6)
    assert got_qa["rms_density_prediction"] == want_qa["rms_density_prediction"]
    for name in names:
        assert (run_dir / name).read_bytes() == (cli_dir / name).read_bytes()


@pytest.mark.parametrize("plt", [False, True], ids=["plain", "plt"])
@pytest.mark.parametrize("ppd", [16, 32])
def test_native_float64_stands_in_for_df64(tmp_path, ppd, plt):
    """``--dtype df64`` is native float64 in the port.  The JAX package's
    df64 step (float32 draws, float64-grade transforms; its target is a
    displacement error below 1e-6) agrees with the port's float64 step to
    2e-6 of the scale (measured: 1.0e-7 to 1.4e-7 at these sizes), and the
    port is at the JAX float64 answer itself to 1e-12: native float64 is
    at least as close to it as df64 is."""
    p = _param(ppd, tmp_path, **(PLT if plt else {}))
    df64 = np.asarray(JZeldovich(p, dtype=jnp.float32).xspace_half_df64())
    f64 = np.asarray(JZeldovich(p, dtype=jnp.float64).xspace_half_pair())
    got = Zeldovich(p, dtype=torch.float64, device="cpu").xspace_half_pair().numpy()
    assert got.dtype == df64.dtype == np.float64 and got.shape == df64.shape
    scale = np.abs(f64).max()
    np.testing.assert_allclose(got, f64, rtol=0, atol=1e-12 * scale)
    err = np.abs(got - df64).max() / scale
    print(f"port float64 vs JAX df64 at {ppd}^3: {err:.3e} of the scale")
    assert err <= 2e-6
    assert np.abs(got - f64).max() <= np.abs(df64 - f64).max()
