"""The port at ppd that are not powers of two, against the JAX package.

At 8^3, 12^3 (the JAX package's own test sizes), 24^3 and 48^3 no FFT
kernel takes the length, so on the card the port
runs B3, B4 and B5 and the matrix-product DFTs of ``ops/mmfft.py``; on
CPU tensors B3, B4 and B5 run their plain versions and the matrix
products run exactly as on the card.  Held against the JAX package in the
same process, on the same parameters:

* the half step through the model API (``Zeldovich.xspace_half_pair``),
  plain and PLT, against JAX ``Zeldovich.xspace_half_pair`` (its pair
  route: ``synthesize_half_pair`` and ``mmfft.ifft3_half_pair``), with no
  call to B1 or B2's wrapper;
* the full grid with f_NL, and CornerModes with k_cutoff = 2, against JAX
  ``xspace_pair``;
* ``OutOfCoreZeldovich`` over several slabs against JAX in core through
  the same writer (the JAX out-of-core identity slab path, ROADMAP C1, is
  not involved);
* the CLI, whose ic_* files match the JAX CLI's: the particle indices
  exact, displacements and velocities (RVdoubleZel) within 1e-12.

Tolerances: float64 1e-12 of the largest value, float32 1e-5.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.cli import main as jmain
from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.utils.output import OutputWriter, read_particles
from zeldovich_tpu.utils.params import Parameters
from zeldovich_tpu.utils.streamio import stream_xspace as jstream_xspace
from zeldovich_tpu_torch.cli import main
from zeldovich_tpu_torch.models import pipeline
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
FNL = dict(ZD_f_NL=30.0, ZD_n_s=0.96, Omega_M=0.3)
CORNER = dict(ZD_CornerModes=1, ZD_k_cutoff=2.0)
TOL = {"float32": 1e-5, "float64": 1e-12}


def _param(ppd, outdir="/tmp/ic_torch_sizes", **over):
    return Parameters.from_dict(
        dict(BASE, NP=ppd**3, InitialConditionsDirectory=str(outdir), **over))


def _close(got, want, dtype):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * np.abs(want).max())


def _no_fused_route(monkeypatch):
    """B1's and B2's wrappers may not be called: the half step at these
    sizes is the separate route."""
    def refuse(*a, **k):
        raise AssertionError("B1/B2 called at a ppd the FFT kernels do not take")

    monkeypatch.setattr(pipeline, "halfspace_pack_zx", refuse)
    monkeypatch.setattr(pipeline, "c2r_y", refuse)


@pytest.mark.parametrize("ppd,case,dtype", [
    (8, "plain", "float64"), (12, "plt", "float64"),
    (24, "plain", "float64"), (24, "plt", "float64"), (48, "plain", "float64"),
    (48, "plt", "float64"), (24, "plain", "float32"),
])
def test_half_step_matches_jax(ppd, case, dtype, monkeypatch):
    _no_fused_route(monkeypatch)
    p = _param(ppd, **(PLT if case == "plt" else {}))
    want = np.asarray(JZeldovich(p, dtype=jnp.float64).xspace_half_pair())
    m = Zeldovich(p, dtype=getattr(torch, dtype), device="cpu")
    got = m.xspace_half_pair().numpy()
    _close(got, want, dtype)
    # the model API's separate route on a spectrum it leaves as it is
    spm = m.kspace_half_pair()
    before = spm.clone()
    _close(m.xspace_half_pair(spm).numpy(), want, dtype)
    assert torch.equal(spm, before)


@pytest.mark.parametrize("ppd,case", [(12, "fnl"), (24, "fnl"), (24, "corner"),
                                      (48, "fnl")])
def test_full_grid_matches_jax(ppd, case):
    p = _param(ppd, **(FNL if case == "fnl" else CORNER))
    want = np.asarray(JZeldovich(p, dtype=jnp.float64).xspace_pair())
    m = Zeldovich(p, dtype=torch.float64, device="cpu")
    assert not m.half_exact
    _close(m.xspace_pair().numpy(), want, "float64")
    # the plain route (torch.fft) agrees with the matrix products
    _close(m.xspace_pair(plain=True).numpy(), want, "float64")


def _compare_dirs(got_dir, want_dir, fmt, tol):
    names = sorted(f.name for f in want_dir.glob("ic_*"))
    assert names and names == sorted(f.name for f in got_dir.glob("ic_*"))
    for name in names:
        want = read_particles(want_dir / name, fmt)
        got = read_particles(got_dir / name, fmt)
        for f in ("i", "j", "k"):
            np.testing.assert_array_equal(got[f], want[f])
        for f in ("displ", "vel"):
            np.testing.assert_allclose(got[f], want[f], rtol=0,
                                       atol=tol * np.abs(want[f]).max())


@pytest.mark.parametrize("case", ["plain", "fnl"])
def test_out_of_core_matches_jax_in_core(tmp_path, case):
    ppd, over = 24, dict(FNL if case == "fnl" else {}, ICFormat="RVdoubleZel")
    p = _param(ppd, tmp_path / "jax", **over)
    jm = JZeldovich(p, dtype=jnp.float64)
    p.output_path.mkdir(parents=True)
    jstream_xspace(jm.xspace_pair(), OutputWriter(p), pair=True)
    m = OutOfCoreZeldovich(_param(ppd, tmp_path / "ooc", **over),
                           slab_bytes=4 * ppd * ppd * 2 * 16, device="cpu")
    assert m.slab == 4 and m.dtype == torch.float64  # six slabs, float64
    m.run()
    _compare_dirs(tmp_path / "ooc", tmp_path / "jax", "RVdoubleZel", 1e-12)


def _write_par(path, ppd, outdir, **over):
    d = dict(BASE, NP=ppd**3, InitialConditionsDirectory=str(outdir), **over)
    path.write_text("".join(
        f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
        for k, v in d.items()))
    return path


def test_cli_matches_the_jax_cli(tmp_path):
    """Both CLIs in float64 (their default) at 24^3 PLT, doubles out."""
    over = dict(PLT, ICFormat="RVdoubleZel")
    jpar = _write_par(tmp_path / "jax.par", 24, tmp_path / "jax", **over)
    par = _write_par(tmp_path / "port.par", 24, tmp_path / "port", **over)
    assert jmain([str(jpar)]) == 0
    assert main([str(par), "--device", "cpu"]) == 0
    _compare_dirs(tmp_path / "port", tmp_path / "jax", "RVdoubleZel", 1e-12)


@pytest.mark.parametrize("ppd,over,said", [
    (24, {}, True), (16, {}, False), (24, FNL, False),
])
def test_memory_plan_names_the_separate_route(tmp_path, capsys, ppd, over, said):
    """At a ppd the FFT kernels do not take, the half step holds the packed
    spectrum beside the output: the memory plan says so, twice the
    k-space line (float64: 16 bytes a complex element); the full grid
    (f_NL) transforms in place and says nothing more."""
    par = _write_par(tmp_path / "p.par", ppd, tmp_path / "ic", **over)
    assert main([str(par), "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    gib = 2 * (ppd / 1024.0) ** 3 * 2 * 16
    line = (f"ppd {ppd} takes the matrix-product DFTs (the FFT kernels take powers of "
            f"two in [16, 2048]): the half-spectrum step holds {gib:5.3f} GiB")
    assert (line in err) is said
    assert ("matrix-product" in err) is said
