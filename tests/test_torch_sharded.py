"""The port's sharded steps (``--sharded``, ``zeldovich_tpu_torch/parallel``)
on the CPU over gloo, against the JAX package.

One spawn a world size (1, 2 and 4 ranks, ``tests/torch_sharded_worker.py``,
joined over a ``FileStore`` in ``tmp_path``: no ports) runs every case; the
ranks' z-slabs, put together in z order, are held against three references
computed in the pytest process while the ranks run:

* the JAX package's sharded step (``xspace_half_pair_sharded``, which falls
  back to ``xspace_pair_sharded``) on the conftest's virtual mesh of 8 CPU
  devices (4 at ppd 12, which 8 does not divide);
* the JAX one-device step (``xspace_half_pair``);
* the port's one-device step (``Zeldovich.xspace_half_pair``).

Tolerances: float64 1e-12 of the largest value, float32 1e-5 (as in
tests/test_torch_slice.py and tests/test_torch_fullgrid.py).  The full-grid
route transforms over z and x before y, the one-device steps y first, so
values agree to rounding, not bit for bit.  The CLI cases run ``--sharded``
through ``torch.distributed.run`` with two ranks and compare ``ic_*``
bytes with a one-rank run of the same arithmetic: the in-core run on the
half route, the ``--out-of-core`` run on the full grid (its slab synthesis
and transform order are the sharded route's).  The span cases run the
32^3 PLT step over 2 and 4 ranks under a CPU profiler: the exchange's
``shard.exchange`` record and its counts, the rank's ``static.plt_coefs``,
the slabs bit for bit those of a run without a profiler; and the
benchmark's two readers of the exchange span (``bench_torch/metrics/``).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.multiprocessing as mp

from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.parallel.mesh import make_mesh as jax_mesh
from zeldovich_tpu.utils.params import Parameters as JParameters
from zeldovich_tpu_torch.cli import main
from zeldovich_tpu_torch.models.pipeline import Zeldovich
from zeldovich_tpu_torch.utils.params import Parameters

sys.path.insert(0, str(Path(__file__).parent))
import torch_sharded_worker  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).parent.parent
ASSETS = ROOT / "zeldovich_tpu" / "assets"
BASE = dict(
    BoxSize=100.0, CPD=8, ICFormat="RVZel", InitialRedshift=49.0,
    InitialConditionsDirectory="/tmp/ic_torch_sharded",
    ZD_Seed=97531, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
    ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0,
    ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
)
FNL = dict(ZD_f_NL=30.0, ZD_n_s=0.96, Omega_M=0.3)
PLT = dict(ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128"))
#: name -> (ppd, keys, route): the half route at 16 and 32, the full grid
#: for f_NL, CornerModes with k_cutoff 2 and ppd 24 (no FFT kernel takes
#: it), the half route's function at ppd 12 (its ky planes split unevenly
#: over 4 ranks)
CONFIGS = {
    "plain16": (16, {}, "step"), "plain32": (32, {}, "step"),
    "plt16": (16, PLT, "step"), "plt32": (32, PLT, "step"),
    "density16": (16, dict(ZD_qdensity=2), "step"),
    "density32": (32, dict(ZD_qdensity=2), "step"),
    "fnl16": (16, FNL, "step"),
    "corner16": (16, dict(ZD_CornerModes=1, ZD_k_cutoff=2.0), "step"),
    "plain24": (24, {}, "step"),
    "half12": (12, {}, "half"),
    "fnl_kspace16": (16, FNL, "kspace"),
}
TOL = {"float64": 1e-12, "float32": 1e-5}
WORLDS = (1, 2, 4)
JOIN_S = 240
#: the JAX references compile at XLA's backend optimization level 0: the
#: same operations, compiled in about half the time at these sizes
XLA_O0 = {"xla_backend_optimization_level": 0}


def _keys(ppd, over):
    return dict(BASE, NP=ppd**3, **over)


def _jax(f):
    return np.asarray(jax.jit(f).lower().compile(XLA_O0)())


def _refs(name, dtype):
    """The JAX sharded, the JAX one-device and the port's one-device
    result of a case, full grids (a fresh JAX model each: a jitted call
    must not find another trace's values cached on it)."""
    ppd, over, route = CONFIGS[name]
    keys = _keys(ppd, over)

    def jz():
        return JZeldovich(JParameters.from_dict(keys), dtype=getattr(jnp, dtype))

    mesh = jax_mesh(devices=jax.devices()[:4 if ppd == 12 else 8])
    port = Zeldovich(Parameters.from_dict(keys), dtype=getattr(torch, dtype), device="cpu")
    if route == "kspace":
        a, b = jz(), jz()
        return (_jax(lambda: a.kspace_pair_sharded(mesh)), _jax(b.kspace_pair),
                port.kspace_pair().numpy())
    a, b = jz(), jz()
    return (_jax(lambda: a.xspace_half_pair_sharded(mesh)), _jax(b.xspace_half_pair),
            port.xspace_half_pair().numpy())


def run_cases(base: Path, dtype: str):
    """Every case in dtype at each world size, the references computed in
    this process while the ranks run: ({(case, world): the ranks' slabs
    put together}, {case: the three references})."""
    cases = [(c, _keys(*CONFIGS[c][:2]), dtype, CONFIGS[c][2]) for c in CONFIGS]
    ctx = mp.get_context("spawn")
    procs = []
    for world in WORLDS:
        (base / f"w{world}").mkdir()
        for rank in range(world):
            p = ctx.Process(target=torch_sharded_worker.run, daemon=True, args=(
                rank, world, str(base / f"store{world}"), cases, str(base / f"w{world}")))
            p.start()
            procs.append(p)
    try:
        refs = {c: _refs(c, dtype) for c in CONFIGS}
        for p in procs:
            p.join(JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    got = {}
    for world in WORLDS:
        out = base / f"w{world}"
        assert sorted(f.name for f in out.glob("done.r*")) == [f"done.r{r}" for r in range(world)]
        for c in CONFIGS:
            slabs = [np.load(out / f"{c}.r{r}.npy") for r in range(world)]
            axis = -3 if CONFIGS[c][2] == "kspace" else -2  # y-slabs, z-slabs
            got[c, world] = np.concatenate(slabs, axis=axis)
    return got, refs


def check_case(got, refs, case, world, dtype):
    x = got[case, world]
    for what, want in zip(("jax sharded", "jax one device", "port one device"),
                          refs[case]):
        assert x.shape == want.shape and x.dtype == want.dtype, what
        np.testing.assert_allclose(x, want, rtol=0, atol=TOL[dtype] * np.abs(want).max(),
                                   err_msg=what)


@pytest.fixture(scope="module")
def sharded64(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("sharded64"), "float64")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CONFIGS))
def test_sharded_step_matches_jax_and_one_device(sharded64, case, world):
    """float64 (tests/test_torch_sharded_f32.py: float32)."""
    check_case(*sharded64, case, world, "float64")


def _write_par(path, outdir, ppd=16, **over):
    d = dict(_keys(ppd, over), InitialConditionsDirectory=str(outdir))
    path.write_text("".join(
        f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
        for k, v in d.items()
    ))
    return path


def _ic_bytes(d):
    files = {f.name: f.read_bytes() for f in d.glob("ic_*")}
    assert files
    return files


@pytest.mark.parametrize("case,one_rank", [
    ("plain", ["--device", "cpu"]),  # the half route: the in-core run's arithmetic
    ("fnl", ["--device", "cpu", "--out-of-core", "--slab-mb", "1"]),  # the full grid's
])
def test_two_rank_cli_writes_the_one_rank_bytes(tmp_path, case, one_rank):
    """``torch.distributed.run`` with 2 gloo ranks: rank 0 writes both
    ranks' z-slabs, and every ic_* byte is the one-rank run's."""
    over = FNL if case == "fnl" else {}
    par = _write_par(tmp_path / "s.par", tmp_path / "sharded", **over)
    one = _write_par(tmp_path / "o.par", tmp_path / "one", **over)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "zeldovich_tpu_torch", str(par), "--device",
         "cpu", "--sharded"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "Sharded run over mesh {'rank': 2} (gloo, cpu)" in run.stderr
    assert run.stderr.count("zeldovich took") == 1  # rank 0's line alone
    assert main([str(one), *one_rank]) == 0
    assert _ic_bytes(tmp_path / "sharded") == _ic_bytes(tmp_path / "one")


def test_one_rank_cli_in_process(tmp_path, capsys):
    """Without torchrun --sharded is one rank over a real gloo group: the
    in-core run's bytes, and a line naming the command that runs more."""
    par = _write_par(tmp_path / "s.par", tmp_path / "sharded")
    one = _write_par(tmp_path / "o.par", tmp_path / "one")
    assert main([str(par), "--device", "cpu", "--sharded"]) == 0
    err = capsys.readouterr().err
    assert "Sharded run over mesh {'rank': 1} (gloo, cpu)" in err
    assert "python -m torch.distributed.run --nproc-per-node" in err
    assert not torch.distributed.is_initialized()
    assert main([str(one), "--device", "cpu"]) == 0
    assert _ic_bytes(tmp_path / "sharded") == _ic_bytes(tmp_path / "one")


def _checkpoint_of_two_ranks(outdir, out_of_core):
    """The meta files a --distributed --part 1 over two ranks leaves (the
    in-core shard directory, or rank 0's out-of-core stage)."""
    outdir.mkdir()
    if out_of_core:
        meta = {"layout": "pair y-slab", "shape": [2, 2, 8, 16, 16], "dtype": "float64",
                "world": 2, "y_range": [0, 8]}
        (outdir / "zeldovich.kspace.mm.p0").write_bytes(bytes(8 * 2 * 2 * 8 * 16 * 16))
        (outdir / "zeldovich.kspace.mm.p0.meta.json").write_text(json.dumps(meta))
        return
    ckpt = outdir / "zeldovich.kspace.ckpt"
    ckpt.mkdir()
    (ckpt / "meta.json").write_text(json.dumps(
        {"shape": [2, 2, 16, 16, 16], "dtype": "<f8", "world": 2,
         "y_ranges": [[0, 8], [8, 16]]}))
    for r in range(2):
        np.save(ckpt / f"shard_r{r}.npy", np.zeros((2, 2, 8, 16, 16)))


@pytest.mark.parametrize("flags,over,says", [
    (["--distributed", "--out-of-core"], dict(ZD_Version=1),
     "ZD_Version=1 is host-generated"),
    (["--distributed"], dict(ZD_Version=1), "ZD_Version=1 is host-generated"),
    (["--distributed", "--part", "2"], {}, "checkpoint"),
    ([], dict(ZD_Version=1), "ZD_Version=1 is host-generated"),
])
def test_sharded_refusals_exit_1(tmp_path, capsys, flags, over, says):
    """ZD_Version=1 has no sharded path, in core or out of core; a --part 2
    restart over one rank refuses the checkpoint two ranks cut (in core
    here; out of core in test_restart_at_another_world_size_exits_1)."""
    restart = "--part" in flags
    if restart:
        _checkpoint_of_two_ranks(tmp_path / "ic", out_of_core=False)
    par = _write_par(tmp_path / "p.par", tmp_path / "ic", **over)
    assert main([str(par), "--device", "cpu", "--sharded", *flags]) == 1
    assert says in capsys.readouterr().err
    if restart:  # the checkpoint stays, no particle is written
        assert (tmp_path / "ic" / "zeldovich.kspace.ckpt" / "meta.json").exists()
        assert not list((tmp_path / "ic").glob("ic_*"))
    else:
        assert not (tmp_path / "ic").exists()  # refused before the output directory
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("flags", [["--distributed", "--out-of-core"],
                                   ["--sharded", "--out-of-core", "--slab-mb", "0"]])
def test_restart_at_another_world_size_exits_1(tmp_path, capsys, flags):
    """An out-of-core --part 2 over one rank refuses the stage that two
    ranks cut, naming the checkpoint, and leaves it in place."""
    _checkpoint_of_two_ranks(tmp_path / "ic", out_of_core=True)
    par = _write_par(tmp_path / "p.par", tmp_path / "ic")
    assert main([str(par), "--device", "cpu", *flags, "--part", "2"]) == 1
    err = capsys.readouterr().err
    assert "stage checkpoint" in err and "world 2" in err and "world 1" in err
    assert (tmp_path / "ic" / "zeldovich.kspace.mm.p0").exists()
    assert not list((tmp_path / "ic").glob("ic_*"))
    assert not torch.distributed.is_initialized()


def test_ky_planes_split_as_evenly_as_they_go():
    from zeldovich_tpu_torch.parallel.pencil_mmfft import split_sizes

    assert split_sizes(6, 4) == [2, 2, 1, 1]
    assert split_sizes(8, 16) == [1] * 8 + [0] * 8
    assert split_sizes(256, 1) == [256]


@pytest.mark.parametrize("over,world,error,says", [
    (dict(ZD_Version=1), 1, NotImplementedError, "ZD_Version=1 is host-generated"),
    ({}, 3, ValueError, "grid 16 not divisible by 3 ranks"),
])
def test_check_sharded_refuses(over, world, error, says):
    """The one check that the CLI and the model's sharded steps share:
    ZD_Version=1 has no sharded path, and the ranks must divide ppd."""
    from types import SimpleNamespace

    model = Zeldovich(Parameters.from_dict(_keys(16, over)), dtype=torch.float64,
                      device="cpu")
    mesh = SimpleNamespace(rank=0, world=world)
    for call in (model.check_sharded, model.kspace_pair_sharded,
                 model.xspace_half_pair_sharded):
        with pytest.raises(error, match=says):
            call(mesh)


# -- spans of the sharded half route, and the benchmark's readers of them --------
#: the 32^3 PLT step (four arrays), over 2 and 4 ranks
SPAN_WORLDS = (2, 4)


@pytest.fixture(scope="module")
def span_runs(tmp_path_factory):
    """``torch_sharded_worker.spans`` at 32^3 PLT over each world size:
    {world: [(span records, traced slab, untraced slab) of each rank]}."""
    base = tmp_path_factory.mktemp("spans")
    keys = _keys(32, PLT)
    ctx = mp.get_context("spawn")
    procs = []
    for world in SPAN_WORLDS:
        (base / f"w{world}").mkdir()
        for rank in range(world):
            p = ctx.Process(target=torch_sharded_worker.spans, daemon=True, args=(
                rank, world, str(base / f"store{world}"), keys, str(base / f"w{world}")))
            p.start()
            procs.append(p)
    try:
        for p in procs:
            p.join(JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    out = {}
    for world in SPAN_WORLDS:
        d = base / f"w{world}"
        out[world] = [(json.loads((d / f"spans.r{r}.json").read_text()),
                       np.load(d / f"traced.r{r}.npy"), np.load(d / f"plain.r{r}.npy"))
                      for r in range(world)]
    return out


@pytest.mark.parametrize("world", SPAN_WORLDS)
def test_exchange_span_counts_calls_and_bytes(span_runs, world):
    """Under a profiler each rank keeps one ``shard.exchange`` record a
    step: one call a block (narray 4 x component x sign), and the bytes it
    sends to the other ranks, its ky planes' parts of their z-slabs."""
    from zeldovich_tpu_torch.parallel.pencil_mmfft import split_sizes

    n, blocks = 32, 4 * 2 * 2
    rows, zl = split_sizes(n // 2, world), n // world
    for rank, (recs, _, _) in enumerate(span_runs[world]):
        (ex,) = [r for r in recs if r["name"] == "shard.exchange"]
        assert ex["counts"] == {"calls": blocks,
                                "bytes": blocks * rows[rank] * (world - 1) * zl * n * 8}


@pytest.mark.parametrize("world", SPAN_WORLDS)
def test_sharded_fields_open_the_plt_span(span_runs, world):
    """The rank's PLT planes (``sharded_fields``) are one
    ``static.plt_coefs`` span, as the one-device planes are."""
    for recs, _, _ in span_runs[world]:
        assert [r["parent"] for r in recs if r["name"] == "static.plt_coefs"] == [None]


@pytest.mark.parametrize("world", SPAN_WORLDS)
def test_spans_leave_the_slabs_unchanged(span_runs, world):
    """Each rank's z-slab under the profiler is the one without it, bit
    for bit."""
    for _, traced, plain in span_runs[world]:
        assert traced.shape == plain.shape and traced.tobytes() == plain.tobytes()


def _reader(name):
    import importlib.util

    path = ROOT / "bench_torch" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell_config():
    return json.loads((ROOT / "bench_torch" / "configs" / "abacus_base_plt4.json").read_text())


def _run(requests, events=(), ranges=()):
    """What a reader gets of a traced run (bench_torch/tracing.py::Run):
    the four-card cell, its requests, trace events and ``shard.exchange``
    ranges."""
    from types import SimpleNamespace

    return SimpleNamespace(cell={"chips": 4}, config=_cell_config(), requests=requests,
                           events=list(events),
                           ranges=lambda name: list(ranges) if name == "shard.exchange" else [])


@pytest.mark.parametrize("name", ["exchange_ms", "exchange_roofline"])
def test_exchange_readers_find_nothing_without_records(name):
    """A run whose requests hold no ``shard.exchange`` record (the
    parent's, or one without a profiler) leaves both metrics out."""
    kernel = {"name": "ncclDevKernel_SendRecv", "cat": "kernel", "t0": 0.1, "t1": 0.2}
    run = _run([{"t0": -2.0, "t1": -1.0}], [kernel], [{"t0": 0.0, "t1": 1.0}])
    assert _reader(name).read(run) is None


def test_exchange_roofline_reckons_the_cells_bytes():
    """At the cell's shapes (1024^3, four arrays, float64, four ranks)
    rank 0 moves 128 x 768 x 1024 x 8 bytes each way a call, 16 calls a
    realization (~12.9 GB); the share is their time at 450 GB/s over the
    NCCL kernels' time inside the spans' ranges, other kernels and NCCL
    kernels outside the ranges left out."""
    from torch.profiler import ProfilerActivity, profile

    from zeldovich_tpu_torch.utils.timers import span

    roof, ms = _reader("exchange_roofline"), _reader("exchange_ms")
    assert roof.call_bytes(_cell_config(), 4) == 128 * 768 * 1024 * 8
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("shard.exchange", calls=16):
            time.sleep(0.01)
    t1 = time.perf_counter()
    events = [{"name": "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
               "cat": "kernel", "t0": 1.0, "t1": 1.04},
              {"name": "c2r_cols_kernel", "cat": "kernel", "t0": 1.0, "t1": 1.03},
              {"name": "ncclDevKernel_AllReduce_Sum_i32", "cat": "kernel", "t0": 2.0,
               "t1": 3.0}]
    run = _run([{"t0": t0, "t1": t1}], events, [{"t0": 0.99, "t1": 1.05}])
    want = 100.0 * 16 * 128 * 768 * 1024 * 8 / 450e9 / 0.04
    assert roof.read(run) == pytest.approx(want, rel=1e-9)
    assert 10.0 <= ms.read(run) < 1e3 * (t1 - t0) + 1e-9
