"""PART1/PART2 through the port's CLI, in-core and out-of-core.

In-core, ``--part 1`` writes the full k-space grid (``kspace_pair``) as
the JAX package's chunk directory ``zeldovich.kspace.ckpt``; the JAX
``load_kspace`` reads it and it equals JAX ``kspace_pair()``.  Out-of-core,
``--part 1`` writes the pass-1 stage as the memmap ``zeldovich.kspace.mm``.
``--part 2`` resumes, removes the checkpoint, and its ``ic_*`` equal a
one-shot run's.  The in-core one-shot run takes the half-spectrum route
and the resumed run the full grid, so particles are compared to 1e-5 of
the scale, not byte for byte (ROADMAP C5).
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.utils.checkpoint import load_kspace
from zeldovich_tpu.utils.output import read_particles
from zeldovich_tpu.utils.params import Parameters
from zeldovich_tpu_torch.cli import main
from zeldovich_tpu_torch.utils.checkpoint import save_kspace

torch.set_num_threads(1)

ASSETS = Path(__file__).parent.parent / "zeldovich_tpu" / "assets"
BASE = dict(
    BoxSize=100.0, CPD=8, ICFormat="RVZel", InitialRedshift=49.0,
    ZD_Seed=97531, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
    ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0,
    ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
)
CASES = {
    "plain": {},
    "plt": dict(ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128")),
    "fnl": dict(ZD_f_NL=30.0, ZD_n_s=0.96, Omega_M=0.3),
}


def _write_par(path, outdir, ppd=16, **over):
    d = dict(BASE, NP=ppd**3, InitialConditionsDirectory=str(outdir), **over)
    path.write_text("".join(
        f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
        for k, v in d.items()
    ))
    return path


def _same_particles(got_dir, want_dir):
    names = sorted(f.name for f in want_dir.glob("ic_*"))
    assert names and names == sorted(f.name for f in got_dir.glob("ic_*"))
    for name in names:
        want = read_particles(want_dir / name, "RVZel")
        got = read_particles(got_dir / name, "RVZel")
        for f in ("i", "j", "k"):
            np.testing.assert_array_equal(got[f], want[f])
        for f in ("displ", "vel"):
            np.testing.assert_allclose(got[f], want[f], rtol=0,
                                       atol=1e-5 * np.abs(want[f]).max())


def test_save_kspace_round_trips_through_jax_load(tmp_path):
    k = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 2, 8, 8, 8)))
    save_kspace(k, tmp_path / "ck", target_bytes=4 * 2 * 2 * 8 * 8 * 8)
    assert len(list((tmp_path / "ck").glob("k_*.npy"))) == 2
    np.testing.assert_array_equal(load_kspace(tmp_path / "ck"), k.numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_in_core_part1_part2(tmp_path, case, capsys):
    over = CASES[case]
    par = _write_par(tmp_path / "p.par", tmp_path / "run", **over)
    one = _write_par(tmp_path / "one.par", tmp_path / "one", **over)
    flags = ["--device", "cpu"]
    assert main([str(par), *flags, "--part", "1"]) == 0
    ckpt = tmp_path / "run" / "zeldovich.kspace.ckpt"
    assert f"Checkpoint written to {ckpt}" in capsys.readouterr().err
    assert not list((tmp_path / "run").glob("ic_*"))
    want = np.asarray(JZeldovich(
        Parameters.from_file(par), dtype=jnp.float32).kspace_pair())
    got = load_kspace(ckpt)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    assert main([str(par), *flags, "--part", "2"]) == 0
    err = capsys.readouterr().err
    assert "This is zeldovich part 2" in err and "Loading k-space checkpoint" in err
    assert not ckpt.exists()
    assert main([str(one), *flags]) == 0
    _same_particles(tmp_path / "run", tmp_path / "one")


@pytest.mark.parametrize("case", ["plain", "fnl"])
def test_out_of_core_part1_part2(tmp_path, case, capsys):
    over = CASES[case]
    par = _write_par(tmp_path / "p.par", tmp_path / "run", **over)
    one = _write_par(tmp_path / "one.par", tmp_path / "one", **over)
    flags = ["--device", "cpu", "--out-of-core", "--slab-mb", "1"]
    assert main([str(par), *flags, "--part", "1"]) == 0
    mm = tmp_path / "run" / "zeldovich.kspace.mm"
    err = capsys.readouterr().err
    assert f"Checkpoint written to {mm}" in err and "Out-of-core streamed run" in err
    assert mm.stat().st_size == (2 * 2 * 16**3) * 4
    assert main([str(par), *flags, "--part", "2"]) == 0
    assert not mm.exists()
    assert main([str(one), "--device", "cpu"]) == 0  # in core, one shot
    _same_particles(tmp_path / "run", tmp_path / "one")


def test_part2_with_another_dtype_exits_1(tmp_path, capsys):
    par = _write_par(tmp_path / "p.par", tmp_path / "run")
    assert main([str(par), "--device", "cpu", "--part", "1"]) == 0
    assert main([str(par), "--device", "cpu", "--part", "2",
                 "--dtype", "float64"]) == 1
    assert "same .par and --dtype" in capsys.readouterr().err
