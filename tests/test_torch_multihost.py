"""The port's multi-process runs (``--distributed``, ``--sharded
--out-of-core``, the sharded checkpoints) on the CPU over gloo, against the
port's one-device runs and the JAX package.

Processes of 2 and 4 ranks (``tests/torch_multihost_worker.py``, started
with the spawn method) run every case's CLI runs in order, joined over
loopback TCP with the triple ``--coordinator 127.0.0.1:P --num-processes
W --process-id i`` (or, where a case says torchrun, the environment
torchrun gives its ranks).  While they run, this process makes the
references: the port's one-device CLI run of the same arithmetic and the
JAX package's ``Zeldovich(param).run()``.  Every case writes RVdoubleZel
(float64 doubles) and the density file, in float64.

* the ic_* and density files are byte for byte the one-device run's: the
  in-core run's on the half route (B1, exchange, B2: the same kernels on
  the same planes), the ``--out-of-core`` run's on the full grid and out
  of core (the same slab synthesis, the z/x DFT before y);
* the particles lie within 1e-12 of the largest value of JAX's run (the
  packages' transforms differ in rounding, ROADMAP C5);
* rank 0's QA report (reduced over the ranks) is the one-device run's;
* with ``--distributed`` and out of core each rank wrote exactly its own
  z planes and no rank called ``recv``; with ``--sharded`` in core rank 0
  wrote every plane;
* a ``--part 2`` over 4 ranks refuses the checkpoint 2 ranks cut;
* ``--distributed --profile DIR`` writes one trace a rank into DIR.
"""

import contextlib
import io
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch
import torch.multiprocessing as mp

from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.utils.output import OutputWriter as JOutputWriter
from zeldovich_tpu.utils.output import read_particles
from zeldovich_tpu.utils.params import Parameters as JParameters
from zeldovich_tpu_torch.cli import main
from zeldovich_tpu_torch.utils.output import OutputWriter, setup_output_dir
from zeldovich_tpu_torch.utils.params import Parameters

sys.path.insert(0, str(Path(__file__).parent))
import torch_multihost_worker  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).parent.parent
ASSETS = ROOT / "zeldovich_tpu" / "assets"
BASE = dict(
    BoxSize=100.0, CPD=8, ICFormat="RVdoubleZel", InitialRedshift=49.0,
    ZD_Seed=97531, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
    ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0, ZD_qdensity=1,
    ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
)
FNL = dict(ZD_f_NL=30.0, ZD_n_s=0.96, Omega_M=0.3)
PLT = dict(ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128"))
D = ["--distributed"]
OOC = ["--out-of-core", "--slab-mb", "0"]
P1, P2 = ["--part", "1"], ["--part", "2"]
IN_CORE, OUT_OF_CORE = [], OOC
#: name -> (ppd, keys, world, the CLI runs in order, the one-device run of
#: the same arithmetic, how the ranks join).  The full grid (f_NL; ppd 24,
#: which no FFT kernel takes) transforms z/x before y: the out-of-core
#: run's order.  --sharded --part 1 gathers the grid into the one-device
#: chunk directory; the sharded --part 2 transforms as the full grid does.
CASES = {
    "plain_w2": (16, {}, 2, [D], IN_CORE, "triple"),
    "plain_w4": (16, {}, 4, [D], IN_CORE, "triple"),
    "plt_w2": (16, PLT, 2, [D], IN_CORE, "triple"),
    "fnl_w2": (16, FNL, 2, [D], OUT_OF_CORE, "triple"),
    "ppd24_w2": (24, {}, 2, [D], OUT_OF_CORE, "triple"),
    "ooc_plain_w2": (16, {}, 2, [D + OOC], OUT_OF_CORE, "triple"),
    "ooc_fnl_w2": (16, FNL, 2, [D + OOC], OUT_OF_CORE, "triple"),
    "ooc_fnl_w4": (16, FNL, 4, [D + OOC], OUT_OF_CORE, "triple"),
    "ooc_disk_fnl_w2": (16, FNL, 2, [D + OOC + ["--backing", "disk"]], OUT_OF_CORE,
                        "triple"),
    "part_w2": (16, {}, 2, [D + P1, D + P2], OUT_OF_CORE, "triple"),
    "part_fnl_w4": (16, FNL, 4, [D + P1, D + P2], OUT_OF_CORE, "triple"),
    "part_ooc_fnl_w2": (16, FNL, 2, [D + OOC + P1, D + OOC + P2], OUT_OF_CORE,
                        "triple"),
    "torchrun_w2": (16, {}, 2, [D], IN_CORE, "torchrun"),
    "sharded_ooc_w2": (16, {}, 2, [["--sharded"] + OOC], OUT_OF_CORE, "torchrun"),
    "sharded_part_w2": (16, PLT, 2, [["--sharded"] + P1, ["--sharded"] + P2],
                        OUT_OF_CORE, "torchrun"),
    # PROFILE: --profile into <case>.trace beside the case's directory
    "profile_w2": (16, {}, 2, [D + ["PROFILE"]], IN_CORE, "triple"),
}
#: --part 1 over 2 ranks, then --part 2 over 4 (must exit 1)
RESTARTS = {"restart_w4": D, "restart_ooc_w4": D + OOC}
TOL = 1e-12
JOIN_S = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _keys(ppd, over, outdir):
    return dict(BASE, NP=ppd**3, InitialConditionsDirectory=str(outdir), **over)


def _write_par(path, keys):
    path.write_text("".join(
        f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
        for k, v in keys.items()))
    return str(path)


def _files(d):
    files = {f.name: f.read_bytes() for f in Path(d).iterdir() if f.is_file()}
    assert any(n.startswith("ic_") for n in files) and any(
        n.startswith("density") for n in files)
    return files


def _report(err):
    """The QA report's lines of a run's stderr."""
    keep = ("The rms density", "This could be compared", "The maximum component",
            "this implies a maximum CPD")
    return [ln for ln in err.splitlines() if ln.strip().startswith(keep)]


def _one_device(par, flags):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main([par, "--device", "cpu", *flags]) == 0
    return err.getvalue()


def _argv(base, name, flags):
    """The CLI flags of a case's run, PROFILE made ``--profile <trace dir>``."""
    trace = ["--profile", str(base / f"{name}.trace")]
    return [a for f in flags for a in (trace if f == "PROFILE" else [f])]


def _jobs(base, pars):
    """The job lists of the 2-rank and the 4-rank processes."""
    jobs = {2: [], 4: []}
    for name, (_, _, world, runs, _, join) in CASES.items():
        for i, flags in enumerate(runs):
            jobs[world].append(dict(kind="cli", name=f"{name}.{i}", port=_free_port(),
                                    torchrun=join == "torchrun",
                                    argv=[pars[name], "--device", "cpu",
                                          *_argv(base, name, flags)]))
    for name, flags in RESTARTS.items():
        jobs[2].append(dict(kind="cli", name=f"{name}.0", port=_free_port(),
                            argv=[pars[name], "--device", "cpu", *flags, *P1]))
        jobs[4].append(dict(kind="cli", name=f"{name}.1", port=_free_port(),
                            after=str(base / f"{name}.0.r0.json"),
                            argv=[pars[name], "--device", "cpu", *flags, *P2]))
    for name, over in (("stage_plain", {}), ("stage_fnl", FNL)):
        jobs[2].append(dict(kind="stage", name=name, port=_free_port(),
                            keys=_keys(16, over, base / name), slab_bytes=1 << 12,
                            no_collective=not over))
    # --sharded --part 1 over 2 ranks, resumed by a one-device --part 2; a
    # one-device --part 1 resumed by --sharded --part 2 over 2 ranks
    jobs[2].append(dict(kind="cli", name="gathered.0", port=_free_port(), torchrun=True,
                        argv=[pars["gathered"], "--device", "cpu", "--sharded", *P1]))
    jobs[2].append(dict(kind="cli", name="resumed.1", port=_free_port(), torchrun=True,
                        argv=[pars["resumed"], "--device", "cpu", "--sharded", *P2]))
    return jobs


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    base = tmp_path_factory.mktemp("multihost")
    pars = {name: _write_par(base / f"{name}.par", _keys(c[0], c[1], base / name))
            for name, c in CASES.items()}
    for name in (*RESTARTS, "gathered", "resumed", "one_part"):
        pars[name] = _write_par(base / f"{name}.par", _keys(16, {}, base / name))
    _one_device(pars["resumed"], P1)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=torch_multihost_worker.run, daemon=True,
                         args=(rank, world, jobs, str(base)))
             for world, jobs in _jobs(base, pars).items() for rank in range(world)]
    for p in procs:
        p.start()
    try:
        refs, jax_dirs = {}, {}
        for name, (ppd, over, _, _, flags, _) in CASES.items():
            key = (ppd, str(over), tuple(flags))
            if key not in refs:
                ref = base / f"ref{len(refs)}"
                par = _write_par(base / f"ref{len(refs)}.par", _keys(ppd, over, ref))
                refs[key] = (ref, _report(_one_device(par, flags)))
            jkey = (ppd, str(over))
            if jkey not in jax_dirs:
                jax_dirs[jkey] = base / f"jax{len(jax_dirs)}"
                JZeldovich(JParameters.from_dict(_keys(ppd, over, jax_dirs[jkey]))).run()
        _one_device(pars["one_part"], P1)
        _one_device(pars["one_part"], P2)
        for p in procs:
            p.join(JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    _one_device(pars["gathered"], P2)
    return base, refs, jax_dirs


def _ranks(base, job, world):
    import json

    res = [json.loads((base / f"{job}.r{r}.json").read_text()) for r in range(world)]
    for r in res:
        assert "error" not in r, r["error"]
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_writes_its_own_planes(multihost, case):
    """Each run exits 0 on every rank; its writers wrote the planes of
    their rank's z-slab and nothing else (with --sharded in core rank 0
    every plane), and with --distributed no rank received a slab."""
    base = multihost[0]
    ppd, _, world, runs, _, _ = CASES[case]
    zl = ppd // world
    for i, flags in enumerate(runs):
        res = _ranks(base, f"{case}.{i}", world)
        assert [r["rc"] for r in res] == [0] * world, res[0]["stderr"][-3000:]
        if "--part" in flags and flags[-1] == "1":
            assert all(r["planes"] == [] for r in res)
            continue
        if "--sharded" in flags and "--out-of-core" not in flags:
            assert res[0]["planes"] == list(range(ppd))
            assert all(r["planes"] == [] for r in res[1:])
            continue
        for rank, r in enumerate(res):
            assert r["planes"] == list(range(rank * zl, (rank + 1) * zl)), rank
            assert r["recvs"] == 0
        if "--distributed" in flags:
            assert f"({world} processes, {world} devices)" in res[0]["stderr"]


@pytest.mark.parametrize("case", list(CASES))
def test_files_are_the_one_device_runs_bytes(multihost, case):
    """The output files are the one-device run's, and no stage, phi stage or
    checkpoint is left behind (a --part 2 consumes its checkpoint, a
    completed --backing disk run removes each rank's stages)."""
    base, refs, _ = multihost
    ppd, over, _, _, flags, _ = CASES[case]
    ref, _ = refs[ppd, str(over), tuple(flags)]
    assert not [f.name for f in (base / case).iterdir()
                if f.name.startswith("zeldovich.")]
    got = _files(base / case)
    assert got.keys() == _files(ref).keys()
    for name, data in _files(ref).items():
        assert got[name] == data, f"{name} differs from the one-device run's"


@pytest.mark.parametrize("case", list(CASES))
def test_reduced_report_is_the_one_device_report(multihost, case):
    base, refs, _ = multihost
    ppd, over, world, runs, flags, _ = CASES[case]
    rank0 = _ranks(base, f"{case}.{len(runs) - 1}", world)[0]["stderr"]
    want = refs[ppd, str(over), tuple(flags)][1]
    assert len(want) == 4 and _report(rank0) == want


@pytest.mark.parametrize("config", [(16, {}), (16, PLT), (16, FNL), (24, {})],
                         ids=["plain16", "plt16", "fnl16", "plain24"])
def test_particles_match_jax(multihost, config):
    """Every case of the configuration, decoded, within 1e-12 of the
    largest value of JAX's one-process run."""
    base, _, jax_dirs = multihost
    ppd, over = config
    want_dir = jax_dirs[ppd, str(over)]
    names = sorted(f.name for f in want_dir.glob("ic_*"))
    cases = [c for c, v in CASES.items() if (v[0], v[1]) == config]
    assert names and cases
    for case in cases:
        for name in names:
            got = read_particles(base / case / name, "RVdoubleZel")
            want = read_particles(want_dir / name, "RVdoubleZel")
            for f in ("i", "j", "k"):
                np.testing.assert_array_equal(got[f], want[f])
            for f in ("displ", "vel"):
                np.testing.assert_allclose(got[f], want[f], rtol=0,
                                           atol=TOL * np.abs(want[f]).max(),
                                           err_msg=f"{case} {name} {f}")


def test_distributed_profile_writes_a_trace_a_rank(multihost):
    """--distributed --profile over 2 processes: one trace a rank, each
    naming the phases, and the bytes of the same run without --profile."""
    import json

    base = multihost[0]
    d = base / "profile_w2.trace"
    for rank in range(2):
        (trace,) = d.glob(f"rank{rank}.*.pt.trace.json")
        names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
                 if e.get("cat") == "user_annotation"}
        assert {"Model setup (P(k), RNG tables, eigenmodes)", "Inverse FFT",
                "Output"} <= names
    assert len(list(d.iterdir())) == 2
    assert _files(base / "profile_w2") == _files(base / "plain_w2")


@pytest.mark.parametrize("case", list(RESTARTS))
def test_part2_over_another_world_size_exits_1(multihost, case):
    """--part 1 over 2 ranks, then --part 2 over 4: every rank exits 1, rank
    0 names the checkpoint, and the checkpoint stays for the right restart."""
    base = multihost[0]
    assert [r["rc"] for r in _ranks(base, f"{case}.0", 2)] == [0, 0]
    res = _ranks(base, f"{case}.1", 4)
    assert [r["rc"] for r in res] == [1] * 4
    assert "checkpoint" in res[0]["stderr"] and "world 2" in res[0]["stderr"]
    assert not list((base / case).glob("ic_*"))
    if "ooc" in case:  # two ranks' stages and their meta files
        kept = (base / case).glob("zeldovich.kspace.mm.p*")
        assert sorted(f.name for f in kept) == [
            "zeldovich.kspace.mm.p0", "zeldovich.kspace.mm.p0.meta.json",
            "zeldovich.kspace.mm.p1", "zeldovich.kspace.mm.p1.meta.json"]
    else:  # two ranks' shards and the meta file
        kept = (base / case / "zeldovich.kspace.ckpt").iterdir()
        assert sorted(f.name for f in kept) == ["meta.json", "shard_r0.npy",
                                                "shard_r1.npy"]


def test_sharded_and_one_device_checkpoints_resume_each_other(multihost):
    """--sharded --part 1 over 2 ranks gathers the one-device chunk
    directory: a one-device --part 2 writes the one-device --part 1/2
    bytes; --sharded --part 2 over 2 ranks resumes a one-device --part 1
    with the bytes of the one-device --out-of-core run (its order)."""
    base, refs, _ = multihost
    assert [r["rc"] for r in _ranks(base, "gathered.0", 2)] == [0, 0]
    assert _files(base / "gathered") == _files(base / "one_part")
    assert [r["rc"] for r in _ranks(base, "resumed.1", 2)] == [0, 0]
    ooc = refs[16, "{}", tuple(OUT_OF_CORE)][0]
    assert _files(base / "resumed") == _files(ooc)
    assert not (base / "resumed" / "zeldovich.kspace.ckpt").exists()  # consumed


@pytest.mark.parametrize("name", ["stage_plain", "stage_fnl"])
def test_each_rank_stages_its_share(multihost, name):
    """DistributedOutOfCore over 2 ranks: each rank's stage is its y-slab,
    1/2 of the grid; put together they are the one-device pass-1 stage bit
    for bit; the plain pass 1 ran no collective (the worker made every
    collective raise)."""
    from zeldovich_tpu_torch.models.outofcore import OutOfCoreZeldovich

    base = multihost[0]
    res = _ranks(base, name, 2)
    assert [r["layout"] for r in res] == [[2, 2, 8, 16, 16]] * 2
    got = np.concatenate([np.load(base / f"{name}.r{r}.npy") for r in range(2)], axis=2)
    over = FNL if name == "stage_fnl" else {}
    want = OutOfCoreZeldovich(Parameters.from_dict(_keys(16, over, base / name)),
                              slab_bytes=1 << 12, device="cpu").stage_pass1()
    assert res[0]["slab"] == 1
    np.testing.assert_array_equal(got, want)


def test_the_entry_point_takes_the_triple(tmp_path):
    """Two ``python -m zeldovich_tpu_torch`` processes with the loopback
    triple write the one-device run's bytes."""
    par = _write_par(tmp_path / "m.par", _keys(16, {}, tmp_path / "mh"))
    one = _write_par(tmp_path / "o.par", _keys(16, {}, tmp_path / "one"))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "zeldovich_tpu_torch", par, "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i)], cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    errs = [p.communicate(timeout=180)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], errs[0][-3000:]
    assert "Distributed run over mesh {'rank': 2} (gloo, cpu)" in errs[0]
    assert "zeldovich took" in errs[0] and "zeldovich took" not in errs[1]
    _one_device(one, [])
    assert _files(tmp_path / "mh") == _files(tmp_path / "one")


# -- the writer's parallel mode and the mergeable statistics ---------------


def _slabs(ppd=16):
    rng = np.random.default_rng(3)
    return rng.normal(size=(ppd, 2, ppd, ppd)) + 1j * rng.normal(size=(ppd, 2, ppd, ppd))


@pytest.mark.parametrize("icformat", ["RVZel", "RVdoubleZel", "Zeldovich", "ZelSimple"])
def test_parallel_writer_matches_append(tmp_path, icformat):
    """pwrite-at-offset mode == serial append mode, for every output
    format, incl. CPD < PPD file mapping (output.cpp:208-212); the JAX
    package's test of its writer (tests/test_multihost.py) on the port's."""
    ppd, slabs = 16, _slabs()
    files = {}
    for name, parallel, order in (("a", False, range(ppd)),
                                  ("b", True, np.random.default_rng(0).permutation(ppd))):
        p = Parameters.from_dict(dict(_keys(ppd, {}, tmp_path / name), CPD=5,
                                      ICFormat=icformat))
        setup_output_dir(p)
        w = OutputWriter(p, parallel=parallel)
        for z in order:
            w.write_slab(int(z), slabs[z])
        w.close()
        files[name] = {f.name: f.read_bytes() for f in (tmp_path / name).iterdir()}
    assert files["a"].keys() == files["b"].keys() and len(files["a"]) > 2
    assert files["a"] == files["b"]


def test_merged_stats_match_jax_and_one_writer(tmp_path):
    """stats_vector/merge_stats over 2 writers of 8 planes each equal the
    JAX package's merge of the same slabs and one writer of all 16."""
    ppd, slabs = 16, _slabs()
    keys = _keys(ppd, {}, tmp_path / "w")
    (tmp_path / "w").mkdir()
    vecs, jvecs = [], []
    for half in (range(0, 8), range(8, 16)):
        w = OutputWriter(Parameters.from_dict(keys), parallel=True)
        jw = JOutputWriter(JParameters.from_dict(keys), parallel=True)
        for z in half:
            w.write_slab(z, slabs[z])
            jw.write_slab(z, slabs[z])
        w.close()
        jw.close()
        vecs.append(w.stats_vector())
        jvecs.append(jw.stats_vector())
    np.testing.assert_array_equal(np.stack(vecs), np.stack(jvecs))
    merged = OutputWriter(Parameters.from_dict(keys), parallel=True)
    merged.merge_stats(np.stack(vecs))
    jmerged = JOutputWriter(JParameters.from_dict(keys), parallel=True)
    jmerged.merge_stats(np.stack(jvecs))
    one = OutputWriter(Parameters.from_dict(keys), parallel=True)
    for z in range(ppd):
        one.write_slab(z, slabs[z])
    one.close()
    np.testing.assert_array_equal(merged.stats_vector(), jmerged.stats_vector())
    assert merged.bytes_written == one.bytes_written
    np.testing.assert_array_equal(merged.max_disp, one.max_disp)
    np.testing.assert_allclose(merged.density_variance, one.density_variance,
                               rtol=1e-14)
    merged.close()
    jmerged.close()
