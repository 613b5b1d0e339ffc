"""PART1/PART2 through the port's CLI, in-core and out-of-core.

In-core, ``--part 1`` writes the full k-space grid (``kspace_pair``) as
the JAX package's chunk directory ``zeldovich.kspace.ckpt``; the JAX
``load_kspace`` reads it and it equals JAX ``kspace_pair()``.  Out-of-core,
``--part 1`` writes the pass-1 stage as the memmap ``zeldovich.kspace.mm``.
``--part 2`` resumes, removes the checkpoint, and its ``ic_*`` equal a
one-shot run's.  The in-core one-shot run takes the half-spectrum route
and the resumed run the full grid, so particles are compared to 1e-5 of
the scale, not byte for byte (ROADMAP C5).

``--part 2`` also resumes the JAX CLI's default in-core checkpoint, the
complex ``(narray, Y, Z, X)`` grid of ``Zeldovich.kspace()`` (ROADMAP
C9): the loader turns it into the pair layout one y-chunk at a time.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.utils.checkpoint import load_kspace
from zeldovich_tpu.utils.checkpoint import save_kspace as jax_save_kspace
from zeldovich_tpu.utils.output import read_particles
from zeldovich_tpu.utils.params import Parameters
from zeldovich_tpu_torch.cli import main
from zeldovich_tpu_torch.utils.checkpoint import load_kspace_pair, save_kspace

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
    flags = ["--device", "cpu", "--dtype", "float32"]
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
    flags = ["--device", "cpu", "--out-of-core", "--slab-mb", "1", "--dtype", "float32"]
    assert main([str(par), *flags, "--part", "1"]) == 0
    mm = tmp_path / "run" / "zeldovich.kspace.mm"
    err = capsys.readouterr().err
    assert f"Checkpoint written to {mm}" in err and "Out-of-core streamed run" in err
    assert mm.stat().st_size == (2 * 2 * 16**3) * 4
    assert main([str(par), *flags, "--part", "2"]) == 0
    assert not mm.exists()
    assert main([str(one), "--device", "cpu", "--dtype", "float32"]) == 0  # in core, one shot
    _same_particles(tmp_path / "run", tmp_path / "one")


def test_part2_with_another_dtype_exits_1(tmp_path, capsys):
    par = _write_par(tmp_path / "p.par", tmp_path / "run")
    assert main([str(par), "--device", "cpu", "--part", "1"]) == 0  # float64
    assert main([str(par), "--device", "cpu", "--part", "2",
                 "--dtype", "float32"]) == 1
    assert "same .par and --dtype" in capsys.readouterr().err


def _same_particles_tol(got_dir, want_dir, tol):
    names = sorted(f.name for f in want_dir.glob("ic_*"))
    assert names and names == sorted(f.name for f in got_dir.glob("ic_*"))
    for name in names:
        want = read_particles(want_dir / name, "RVdoubleZel")
        got = read_particles(got_dir / name, "RVdoubleZel")
        for f in ("i", "j", "k"):
            np.testing.assert_array_equal(got[f], want[f])
        for f in ("displ", "vel"):
            np.testing.assert_allclose(got[f], want[f], rtol=0,
                                       atol=tol * np.abs(want[f]).max())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
def test_part2_resumes_a_jax_complex_checkpoint(tmp_path, case, dtype, tol, capsys):
    """JAX ``Zeldovich.kspace()`` saved by the JAX ``save_kspace`` (what
    ``python -m zeldovich_tpu --part 1`` writes on a backend with complex
    support) resumes under the port's ``--part 2``; the ``ic_*`` equal a
    one-shot port run of the same .par and dtype: float32 within the slice
    tolerance of tests/test_torch_slice.py, float64 to 1e-12 of the scale.
    ZD_Version=2 only: the JAX pair path ignores ZD_Version=1 (ROADMAP C6),
    and v1 checkpoints are not held here."""
    over = dict(CASES[case], ICFormat="RVdoubleZel")
    par = _write_par(tmp_path / "p.par", tmp_path / "run", **over)
    one = _write_par(tmp_path / "one.par", tmp_path / "one", **over)
    ckpt = tmp_path / "run" / "zeldovich.kspace.ckpt"
    k = JZeldovich(Parameters.from_file(par), dtype=getattr(jnp, dtype)).kspace()
    assert k.shape == (4 if case == "plt" else 2, 16, 16, 16)
    assert k.dtype == {"float32": jnp.complex64, "float64": jnp.complex128}[dtype]
    (tmp_path / "run").mkdir()
    # 4 y-chunks, so the conversion is seen to go chunk by chunk
    jax_save_kspace(k, ckpt, target_bytes=k.nbytes // 4)
    assert len(list(ckpt.glob("k_*.npy"))) == 4
    flags = ["--device", "cpu", "--dtype", dtype]
    assert main([str(par), *flags, "--part", "2"]) == 0
    assert "Loading k-space checkpoint" in capsys.readouterr().err
    assert not ckpt.exists()
    assert main([str(one), *flags]) == 0
    _same_particles_tol(tmp_path / "run", tmp_path / "one", tol)


def test_load_kspace_pair_converts_chunk_by_chunk(tmp_path, monkeypatch):
    """A complex (narray, Y, Z, X) checkpoint loads as stack([re, im],
    axis=1); each y-chunk file is read once and no complex array larger
    than a chunk is made."""
    rng = np.random.default_rng(5)
    k = (rng.normal(size=(2, 8, 4, 4)) + 1j * rng.normal(size=(2, 8, 4, 4)))
    jax_save_kspace(k.astype(np.complex64), tmp_path / "ck", target_bytes=2 * 2 * 16 * 8)
    assert len(list((tmp_path / "ck").glob("k_*.npy"))) == 4
    loads, real_load = [], np.load
    monkeypatch.setattr(np, "load", lambda f, *a, **kw: loads.append(
        real_load(f, *a, **kw)) or loads[-1])
    got = load_kspace_pair(tmp_path / "ck")
    assert [c.shape for c in loads] == [(2, 2, 4, 4)] * 4
    assert got.dtype == np.float32 and got.shape == (2, 2, 8, 4, 4)
    want = np.stack([k.real, k.imag], axis=1).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    # a pair checkpoint loads as it is
    save_kspace(torch.from_numpy(want), tmp_path / "pair")
    np.testing.assert_array_equal(load_kspace_pair(tmp_path / "pair"), want)


@pytest.mark.parametrize("kind", ["other precision", "other shape", "half grid"])
def test_part2_refuses_a_complex_checkpoint_it_cannot_take(tmp_path, capsys, kind):
    par = _write_par(tmp_path / "p.par", tmp_path / "run")
    (tmp_path / "run").mkdir()
    shape, dtype = {"other precision": ((2, 16, 16, 16), np.complex128),
                    "other shape": ((2, 8, 16, 16), np.complex64),
                    "half grid": ((2, 2, 2, 9, 16, 16), np.float32)}[kind]
    jax_save_kspace(np.zeros(shape, dtype), tmp_path / "run" / "zeldovich.kspace.ckpt")
    assert main([str(par), "--device", "cpu", "--dtype", "float32", "--part", "2"]) == 1
    err = capsys.readouterr().err
    assert "same .par and --dtype" in err and str(shape) in err
    assert not list((tmp_path / "run").glob("ic_*"))


@pytest.mark.parametrize("case", list(CASES))
def test_part2_takes_a_complex128_checkpoint_with_no_dtype(tmp_path, case, capsys):
    """The JAX CLI's default checkpoint, the complex128 (narray, Y, Z, X)
    grid of a float64 ``Zeldovich.kspace()``, resumes under the port's
    ``--part 2`` with no --dtype (float64 is the default of both), and the
    ``ic_*`` doubles equal a one-shot run's to 1e-12 of the scale."""
    over = dict(CASES[case], ICFormat="RVdoubleZel")
    par = _write_par(tmp_path / "p.par", tmp_path / "run", **over)
    one = _write_par(tmp_path / "one.par", tmp_path / "one", **over)
    ckpt = tmp_path / "run" / "zeldovich.kspace.ckpt"
    k = JZeldovich(Parameters.from_file(par)).kspace()  # the JAX default: float64
    assert k.dtype == jnp.complex128
    (tmp_path / "run").mkdir()
    jax_save_kspace(k, ckpt)
    assert main([str(par), "--device", "cpu", "--part", "2"]) == 0
    err = capsys.readouterr().err
    assert "Loading k-space checkpoint" in err and "A6" not in err
    assert not ckpt.exists()
    assert main([str(one), "--device", "cpu"]) == 0
    _same_particles_tol(tmp_path / "run", tmp_path / "one", 1e-12)


def test_part1_checkpoint_is_float64_by_default(tmp_path):
    """--part 1 with no --dtype writes the float64 pair grid, equal to the
    JAX package's float64 ``kspace_pair()`` to 1e-12; out of core the
    float64 stage."""
    par = _write_par(tmp_path / "p.par", tmp_path / "run")
    assert main([str(par), "--device", "cpu", "--part", "1"]) == 0
    got = load_kspace(tmp_path / "run" / "zeldovich.kspace.ckpt")
    want = np.asarray(JZeldovich(Parameters.from_file(par)).kspace_pair())
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    assert main([str(par), "--device", "cpu", "--out-of-core", "--part", "1"]) == 0
    assert (tmp_path / "run" / "zeldovich.kspace.mm").stat().st_size == 2 * 2 * 16**3 * 8


# -- out of core: the stage's meta file and its check (ROADMAP C11) -------

OOC = ["--device", "cpu", "--out-of-core", "--slab-mb", "1"]


def _dtype_flags(dtype):
    return [] if dtype == "float64" else ["--dtype", dtype]  # float64: the default


@pytest.mark.parametrize("part1,part2", [("float64", "float32"), ("float32", "float64")])
def test_out_of_core_part2_with_another_dtype_exits_1(tmp_path, capsys, part1, part2):
    """A stage of the other precision is refused with the in-core message
    (a float64 stage read as float32 gave NaN particles; a float32 stage
    read as float64 an uncaught mmap error)."""
    par = _write_par(tmp_path / "p.par", tmp_path / "run")
    assert main([str(par), *OOC, *_dtype_flags(part1), "--part", "1"]) == 0
    assert main([str(par), *OOC, *_dtype_flags(part2), "--part", "2"]) == 1
    err = capsys.readouterr().err
    assert "same .par and --dtype" in err and f"pair {part1}" in err
    assert not list((tmp_path / "run").glob("ic_*"))
    assert (tmp_path / "run" / "zeldovich.kspace.mm").exists()  # kept to resume


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_out_of_core_part2_refuses_the_jax_complex_stage(tmp_path, capsys, dtype):
    """The JAX CLI's out-of-core PART1 stage on a backend with complex
    numbers is the complex128 (narray, Y, Z, X) grid, the byte count of a
    float64 pair stage, with no meta file: it is never read as pairs.  Made
    as ``python -m zeldovich_tpu --out-of-core --part 1`` makes it (float64,
    ``pair`` False where the backend has complex numbers)."""
    from zeldovich_tpu.models.outofcore import OutOfCoreZeldovich as JOutOfCore

    par = _write_par(tmp_path / "p.par", tmp_path / "run")
    jm = JOutOfCore(Parameters.from_file(par), dtype=jnp.float64, pair=False,
                    slab_bytes=1 << 20)
    (tmp_path / "run").mkdir()
    mm = tmp_path / "run" / "zeldovich.kspace.mm"
    jm.stage_pass1(stage=jm.stage_memmap(mm, "w+")).flush()
    assert mm.stat().st_size == 2 * 16**3 * 16 and not list(mm.parent.glob("*.json"))
    capsys.readouterr()
    assert main([str(par), *OOC, *_dtype_flags(dtype), "--part", "2"]) == 1
    err = capsys.readouterr().err
    assert "same .par and --dtype" in err and "no meta file" in err
    assert "assumed" not in err and not list((tmp_path / "run").glob("ic_*"))


def test_out_of_core_part2_resumes_its_stage_with_the_same_bytes(tmp_path, capsys):
    """PART1 writes the stage's meta file beside it; a matching PART2
    resumes, removes both, and writes the bytes of a one-shot out-of-core
    run."""
    import json

    par = _write_par(tmp_path / "p.par", tmp_path / "run", **CASES["fnl"])
    one = _write_par(tmp_path / "one.par", tmp_path / "one", **CASES["fnl"])
    assert main([str(par), *OOC, "--part", "1"]) == 0
    mm = tmp_path / "run" / "zeldovich.kspace.mm"
    meta = mm.with_name(mm.name + ".meta.json")
    assert json.loads(meta.read_text()) == {
        "layout": "pair", "shape": [2, 2, 16, 16, 16], "dtype": "float64"}
    assert main([str(par), *OOC, "--part", "2"]) == 0
    assert "assumed" not in capsys.readouterr().err
    assert not mm.exists() and not meta.exists()
    assert main([str(one), *OOC]) == 0
    want = {f.name: f.read_bytes() for f in (tmp_path / "one").glob("ic_*")}
    assert want and {f.name: f.read_bytes()
                     for f in (tmp_path / "run").glob("ic_*")} == want


def test_out_of_core_part2_takes_a_jax_pair_stage(tmp_path, capsys, monkeypatch):
    """A stage with no meta file of the run's size whose y-Nyquist planes
    are zero, the JAX package's pair stage (its general slab synthesis,
    ROADMAP C1), resumes as the pair layout with one stderr line."""
    from zeldovich_tpu.models.outofcore import OutOfCoreZeldovich as JOutOfCore

    par = _write_par(tmp_path / "p.par", tmp_path / "run")
    one = _write_par(tmp_path / "one.par", tmp_path / "one")
    monkeypatch.setenv("ZT_SLAB_IDENTITY", "0")
    jm = JOutOfCore(Parameters.from_file(par), dtype=jnp.float64, pair=True,
                    slab_bytes=1 << 20)
    (tmp_path / "run").mkdir()
    mm = tmp_path / "run" / "zeldovich.kspace.mm"
    jm.stage_pass1(stage=jm.stage_memmap(mm, "w+")).flush()
    assert main([str(par), *OOC, "--part", "2"]) == 0
    assert "no meta file: assumed to be the pair float64" in capsys.readouterr().err
    assert not mm.exists()
    assert main([str(one), *OOC]) == 0
    _same_particles(tmp_path / "run", tmp_path / "one")
