"""The port's checkpoints over a mesh of ranks (``utils/checkpoint.py``):
``save_sharded``/``load_sharded`` (``--distributed --part 1/2``) and the
gathered chunk directory of ``--sharded --part 1/2``, on the CPU over one
gloo rank in this process (tests/test_torch_multihost.py runs them over 2
and 4 ranks).

* a shard checkpoint round-trips, is refused for another world size, y
  split, shape or dtype, or a missing shard, and a re-save wipes stale
  shards (the JAX package's tests/test_checkpoint_sharded.py, :19-60);
* the gathered directory is ``save_kspace``'s, file for file, and a rank
  reads only its rows of it (pair or the JAX CLI's complex grid);
* ``--sharded --part 1`` and a one-device ``--part 2``, or the other way
  round, write the bytes of the one-device run of the same arithmetic; the
  JAX CLI's complex checkpoint resumes under ``--sharded --part 2`` within
  1e-12 of the largest value of JAX's own run.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import torch

from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.utils.checkpoint import save_kspace as jax_save_kspace
from zeldovich_tpu.utils.output import read_particles
from zeldovich_tpu.utils.params import Parameters as JParameters
from zeldovich_tpu_torch.cli import main
from zeldovich_tpu_torch.parallel.mesh import make_mesh
from zeldovich_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

ASSETS = Path(__file__).parent.parent / "zeldovich_tpu" / "assets"
BASE = dict(
    BoxSize=100.0, CPD=8, ICFormat="RVdoubleZel", InitialRedshift=49.0,
    ZD_Seed=97531, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
    ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0, ZD_qdensity=1,
    ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
)
PLT = dict(ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128"))


@pytest.fixture
def mesh():
    m = make_mesh("cpu")
    yield m
    m.close()


def _grid(shape=(2, 2, 16, 8, 8), seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape))


def test_save_load_sharded_round_trip(tmp_path, mesh):
    k = _grid()
    checkpoint.save_sharded(k, tmp_path / "ck", mesh)
    assert sorted(f.name for f in (tmp_path / "ck").iterdir()) == [
        "meta.json", "shard_r0.npy"]
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta == {"shape": [2, 2, 16, 8, 8], "dtype": "<f8", "world": 1,
                    "y_ranges": [[0, 16]]}
    back = checkpoint.load_sharded(tmp_path / "ck", mesh, k.shape, "float64", "cpu")
    assert torch.equal(back, k)


@pytest.mark.parametrize("key,value", [
    ("world", 2), ("y_ranges", [[0, 8], [8, 16]]), ("shape", [2, 2, 32, 8, 8]),
    ("dtype", "<f4"), ("shard", None)])
def test_load_sharded_refuses_another_cut(tmp_path, mesh, key, value):
    """Another world size, y split, shape or dtype, or a missing shard:
    CheckpointMismatch naming the checkpoint."""
    checkpoint.save_sharded(_grid(), tmp_path / "ck", mesh)
    meta_path = tmp_path / "ck" / "meta.json"
    if key == "shard":
        (tmp_path / "ck" / "shard_r0.npy").unlink()
    else:
        meta = json.loads(meta_path.read_text())
        meta[key] = value
        meta_path.write_text(json.dumps(meta))
    with pytest.raises(checkpoint.CheckpointMismatch, match="checkpoint"):
        checkpoint.load_sharded(tmp_path / "ck", mesh, (2, 2, 16, 8, 8), "float64", "cpu")


def test_save_sharded_wipes_stale_shards(tmp_path, mesh):
    checkpoint.save_sharded(_grid(), tmp_path / "ck", mesh)
    stale = tmp_path / "ck" / "shard_r999.npy"  # no such rank
    stale.write_bytes(b"junk")
    checkpoint.save_sharded(_grid(seed=1), tmp_path / "ck", mesh)  # must not mix
    assert not stale.exists()
    back = checkpoint.load_sharded(tmp_path / "ck", mesh, (2, 2, 16, 8, 8), "float64",
                                   "cpu")
    assert torch.equal(back, _grid(seed=1))


def test_gathered_checkpoint_is_save_kspaces(tmp_path, mesh):
    """Over one rank the gathered directory is save_kspace's, file for file
    (chunks of whole rows, meta.json last)."""
    k = _grid()
    checkpoint.save_kspace_gathered(k, tmp_path / "g", mesh, target_bytes=4096)
    checkpoint.save_kspace(k, tmp_path / "one", target_bytes=4096)
    names = sorted(f.name for f in (tmp_path / "one").iterdir())
    assert len(names) > 2 and names == sorted(f.name for f in (tmp_path / "g").iterdir())
    for n in names:
        assert (tmp_path / "g" / n).read_bytes() == (tmp_path / "one" / n).read_bytes()


@pytest.mark.parametrize("kind", ["pair", "complex"])
@pytest.mark.parametrize("rows", [(0, 16), (4, 12), (6, 7), (15, 16)])
def test_load_kspace_pair_reads_a_ranks_rows(tmp_path, kind, rows):
    """Rows [y0, y1) of a pair or a JAX complex checkpoint, read from the
    chunks that hold them, as the pair layout."""
    k = _grid((2, 2, 16, 4, 4)).numpy()
    if kind == "pair":
        checkpoint.save_kspace(torch.from_numpy(k), tmp_path / "ck", target_bytes=512)
    else:
        jax_save_kspace(k[:, 0] + 1j * k[:, 1], tmp_path / "ck", target_bytes=1024)
    assert len(list((tmp_path / "ck").glob("k_*.npy"))) > 2
    got = checkpoint.load_kspace_pair(tmp_path / "ck", rows=rows)
    np.testing.assert_array_equal(got, k[:, :, rows[0]:rows[1]])


def _write_par(path, outdir, **over):
    d = dict(BASE, NP=16**3, InitialConditionsDirectory=str(outdir), **over)
    path.write_text("".join(
        f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
        for k, v in d.items()))
    return str(path)


def _files(d):
    files = {f.name: f.read_bytes() for f in Path(d).iterdir() if f.is_file()}
    assert any(n.startswith("ic_") for n in files) and "density16" in files
    return files


@pytest.mark.parametrize("over", [{}, PLT], ids=["plain", "plt"])
def test_sharded_part1_resumes_one_device(tmp_path, over):
    """--sharded --part 1 (the gathered chunk directory), then a one-device
    --part 2: the bytes of the one-device --part 1/--part 2 run."""
    run = _write_par(tmp_path / "s.par", tmp_path / "run", **over)
    one = _write_par(tmp_path / "o.par", tmp_path / "one", **over)
    assert main([run, "--device", "cpu", "--sharded", "--part", "1"]) == 0
    assert (tmp_path / "run" / "zeldovich.kspace.ckpt" / "k_00000.npy").exists()
    assert main([run, "--device", "cpu", "--part", "2"]) == 0
    for part in ("1", "2"):
        assert main([one, "--device", "cpu", "--part", part]) == 0
    assert _files(tmp_path / "run") == _files(tmp_path / "one")


@pytest.mark.parametrize("over", [{}, PLT], ids=["plain", "plt"])
def test_one_device_part1_resumes_sharded(tmp_path, over):
    """A one-device --part 1, then --sharded --part 2 (each rank its rows,
    the z/x DFT before y): the bytes of the one-device --out-of-core run;
    the checkpoint is consumed."""
    run = _write_par(tmp_path / "s.par", tmp_path / "run", **over)
    one = _write_par(tmp_path / "o.par", tmp_path / "one", **over)
    assert main([run, "--device", "cpu", "--part", "1"]) == 0
    assert main([run, "--device", "cpu", "--sharded", "--part", "2"]) == 0
    assert not (tmp_path / "run" / "zeldovich.kspace.ckpt").exists()
    assert main([one, "--device", "cpu", "--out-of-core"]) == 0
    assert _files(tmp_path / "run") == _files(tmp_path / "one")


def test_sharded_part2_resumes_the_jax_complex_checkpoint(tmp_path):
    """The JAX CLI's default checkpoint, complex128 (narray, Y, Z, X) of
    Zeldovich.kspace(), resumes under --sharded --part 2: the particles
    within 1e-12 of the largest value of JAX's one-shot run."""
    run = _write_par(tmp_path / "s.par", tmp_path / "run")
    (tmp_path / "run").mkdir()
    keys = dict(BASE, NP=16**3, InitialConditionsDirectory=str(tmp_path / "jax"))
    k = np.asarray(JZeldovich(JParameters.from_dict(keys)).kspace())
    assert k.dtype == np.complex128 and k.shape == (2, 16, 16, 16)
    jax_save_kspace(k, tmp_path / "run" / "zeldovich.kspace.ckpt", target_bytes=k.nbytes // 4)
    assert main([run, "--device", "cpu", "--sharded", "--part", "2"]) == 0
    JZeldovich(JParameters.from_dict(keys)).run()
    names = sorted(f.name for f in (tmp_path / "jax").glob("ic_*"))
    assert names == sorted(f.name for f in (tmp_path / "run").glob("ic_*"))
    for name in names:
        got = read_particles(tmp_path / "run" / name, "RVdoubleZel")
        want = read_particles(tmp_path / "jax" / name, "RVdoubleZel")
        for f in ("displ", "vel"):
            np.testing.assert_allclose(got[f], want[f], rtol=0,
                                       atol=1e-12 * np.abs(want[f]).max())


def test_sharded_part2_refuses_a_checkpoint_of_another_dtype(tmp_path, capsys):
    run = _write_par(tmp_path / "s.par", tmp_path / "run")
    assert main([run, "--device", "cpu", "--dtype", "float32", "--part", "1"]) == 0
    assert main([run, "--device", "cpu", "--sharded", "--part", "2"]) == 1
    err = capsys.readouterr().err
    assert "checkpoint holds float32" in err and "same .par and --dtype" in err
    assert not list((tmp_path / "run").glob("ic_*"))
    assert not torch.distributed.is_initialized()
