"""The port's CLI: it never loads jax nor any module of the JAX package
(zeldovich_tpu), and its error paths exit 1."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zeldovich_tpu_torch import cli

torch.set_num_threads(1)

REPO = Path(__file__).parent.parent
ASSETS = REPO / "zeldovich_tpu" / "assets"


def _write_par(path, outdir, ppd=16, **over):
    d = dict(
        BoxSize=100.0, NP=ppd**3, CPD=8, ICFormat="RVZel",
        InitialConditionsDirectory=str(outdir), InitialRedshift=49.0,
        ZD_Seed=1234, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
        ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0,
        ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
        ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128"),
    )
    d.update(over)
    path.write_text("".join(
        f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
        for k, v in d.items()
    ))
    return path


#: prints the loaded modules of jax and of the JAX package, exits 3 if any
_CHECK_MODULES = (
    "jax = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib'))\n"
    "zt = sorted(m for m in sys.modules if m.split('.')[0] == 'zeldovich_tpu')\n"
    "print('JAXMODS', jax)\n"
    "print('ZTMODS', zt)\n"
    "sys.exit(rc if not jax and not zt else 3)\n"
)


def _run_python(tmp_path, code):
    proc = subprocess.run(
        [sys.executable, "-c", "import sys\n" + code + _CHECK_MODULES], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAXMODS []" in proc.stdout
    assert "ZTMODS []" in proc.stdout
    return proc


def _run_without_jax(tmp_path, par, *calls):
    """The CLI in a fresh interpreter, once for each list of flags in
    calls (once without flags when none is given); asserts that neither
    jax nor any zeldovich_tpu module ever loaded."""
    calls = [list(c) for c in calls] or [[]]
    code = (
        "import zeldovich_tpu_torch\n"
        "from zeldovich_tpu_torch.cli import main\n"
        "rc = 0\n"
        f"for flags in {calls!r}:\n"
        f"    rc = rc or main([{str(par)!r}, '--device', 'cpu', *flags])\n"
    )
    return _run_python(tmp_path, code)


def test_import_and_cpu_run_leave_jax_unloaded(tmp_path):
    par = _write_par(tmp_path / "p.par", tmp_path / "ic")
    proc = _run_without_jax(tmp_path, par)
    assert len(list((tmp_path / "ic").glob("ic_*"))) == 8
    assert "zeldovich took" in proc.stderr


def test_out_of_core_disk_run_leaves_jax_unloaded(tmp_path):
    par = _write_par(tmp_path / "p.par", tmp_path / "ic")
    proc = _run_without_jax(tmp_path, par, ["--out-of-core", "--backing", "disk"])
    assert len(list((tmp_path / "ic").glob("ic_*"))) == 8
    assert not list((tmp_path / "ic").glob("*.mm"))
    assert "Out-of-core streamed run" in proc.stderr


FNL = dict(ZD_f_NL=10.0, ZD_n_s=0.96, Omega_M=0.3)


@pytest.mark.parametrize("flow", ["fnl", "v1", "part", "part_out_of_core"])
def test_cpu_flows_leave_the_jax_package_unloaded(tmp_path, flow):
    """f_NL and ZD_Version=1 (the full grid), --part 1 then --part 2 in
    core and out of core: no module of jax or of zeldovich_tpu loads."""
    over = {"fnl": dict(ZD_qPLT=0, **FNL), "v1": dict(ZD_qPLT=0, ZD_Version=1)}
    par = _write_par(tmp_path / "p.par", tmp_path / "ic", **over.get(flow, {}))
    ooc = ["--out-of-core"] if flow == "part_out_of_core" else []
    calls = [ooc + ["--part", "1"], ooc + ["--part", "2"]] if flow.startswith("part") else []
    proc = _run_without_jax(tmp_path, par, *calls)
    assert len(list((tmp_path / "ic").glob("ic_*"))) == 8
    assert not list((tmp_path / "ic").glob("zeldovich.*"))
    assert "zeldovich took" in proc.stderr


def test_import_chip_smoke_leaves_the_jax_package_unloaded(tmp_path):
    proc = _run_python(tmp_path, f"sys.path.insert(0, {str(REPO)!r})\n"
                                 "import chip_smoke\nchip_smoke.phase_card\nrc = 0\n")
    assert "ZTMODS []" in proc.stdout


def test_f_nl_runs_on_the_cpu(tmp_path, capsys):
    """An f_NL .par runs the full-grid path (the JAX package's fallback)."""
    par = _write_par(tmp_path / "p.par", tmp_path / "ic", ZD_qPLT=0, **FNL)
    assert cli.main([str(par), "--device", "cpu"]) == 0
    assert len(list((tmp_path / "ic").glob("ic_*"))) == 8
    assert "zeldovich took" in capsys.readouterr().err


@pytest.mark.parametrize("over,narrays", [
    (dict(ZD_qPLT=0), 2), (dict(ZD_qPLT=0, **FNL), 3), (dict(ZD_qPLT=1, **FNL), 5),
])
def test_memory_plan_counts_the_phi_grid(tmp_path, capsys, over, narrays):
    """The memory-plan line counts narray + 1 arrays under f_NL, as the
    JAX CLI does: the phi grid lives beside the k-space arrays.  In
    float64 (16 bytes a complex element) unless --dtype float32 asks."""
    par = _write_par(tmp_path / "p.par", tmp_path / "ic", **over)
    for flags, itemsize, name in (([], 16, "float64"), (["--dtype", "float32"], 8, "float32")):
        assert cli.main([str(par), "--device", "cpu", *flags]) == 0
        gib = (16 / 1024.0) ** 3 * narrays * itemsize
        assert (f"Device-resident k-space state: {gib:5.3f} GiB "
                f"({narrays} complex arrays, {name})") in capsys.readouterr().err


@pytest.mark.parametrize(
    "flags,says",
    [(["--coordinator", "localhost:1234", "--num-processes", "2", "--process-id", "2"],
      "--process-id 2 is not a rank of --num-processes 2"),
     (["--coordinator", "localhost:1234"], "go together"),
     (["--num-processes", "2"], "go together"),
     (["--process-id", "0"], "go together")],
)
def test_unported_flags_exit_1(tmp_path, capsys, flags, says):
    """Every flag of the JAX CLI is ported; the multi-process triple must
    come whole and name a rank of its world.  Each such run is refused
    before any process group or output directory exists."""
    par = _write_par(tmp_path / "p.par", tmp_path / "ic")
    assert cli.main([str(par), "--device", "cpu", *flags]) == 1
    assert says in capsys.readouterr().err
    assert not (tmp_path / "ic").exists()


def test_pair_flag_changes_no_output_byte(tmp_path, capsys):
    """--pair (the JAX CLI's complex-free route) is accepted and ignored:
    the port is always the pair route."""
    runs = {}
    for name, flags in (("none", []), ("pair", ["--pair"])):
        par = _write_par(tmp_path / f"{name}.par", tmp_path / name)
        assert cli.main([str(par), "--device", "cpu", *flags]) == 0
        runs[name] = {f.name: f.read_bytes() for f in (tmp_path / name).glob("ic_*")}
    assert "not ported" not in capsys.readouterr().err
    assert len(runs["none"]) == 8 and runs["pair"] == runs["none"]


F32 = ["--dtype", "float32"]


@pytest.mark.parametrize("fmt,flags,warned", [
    ("RVdoubleZel", [], False), ("RVdoubleZel", F32, True),
    ("RVdoubleZel", ["--dtype", "float64"], False), ("RVZel", [], False),
    ("RVZel", F32, False), ("Zeldovich", [], False), ("Zeldovich", F32, True),
    ("ZelSimple", F32, False), ("RVdoubleZel", ["--dtype", "df64"], False),
])
def test_float32_default_is_announced_for_a_double_format(tmp_path, capsys, fmt,
                                                          flags, warned):
    """The default is float64, as the JAX CLI's, and says nothing.  Only a
    run that asks for --dtype float32 and a double ic_* format gets one
    stderr line saying that its doubles carry float32 rounding; no message
    names ROADMAP A6 any more."""
    par = _write_par(tmp_path / "p.par", tmp_path / "ic", ICFormat=fmt,
                     ZD_qPLT=int(fmt.startswith("RV")))  # PLT needs velocities
    assert cli.main([str(par), "--device", "cpu", *flags]) == 0
    err = capsys.readouterr().err
    line = [ln for ln in err.splitlines() if "float32 rounding" in ln]
    assert len(line) == (1 if warned else 0)
    assert "A6" not in err
    if warned:
        assert "--dtype float32" in line[0] and "--dtype float64" in line[0]


@pytest.mark.parametrize("fmt", ["RVdoubleZel", "RVZel"])
@pytest.mark.parametrize("flow", ["in core", "out of core"])
def test_no_dtype_computes_in_float64(tmp_path, capsys, fmt, flow):
    """With no --dtype the run computes in float64, as python -m
    zeldovich_tpu does: its ic_* bytes equal a --dtype float64 run's (the
    doubles of RVdoubleZel, and the floats of RVZel, which are rounded
    from float64 values), and differ from a --dtype float32 run's."""
    ooc = ["--out-of-core", "--slab-mb", "1"] if flow == "out of core" else []
    runs = {}
    for name, flags in (("none", []), ("f64", ["--dtype", "float64"]), ("f32", F32)):
        par = _write_par(tmp_path / f"{name}.par", tmp_path / name, ICFormat=fmt)
        assert cli.main([str(par), "--device", "cpu", *ooc, *flags]) == 0
        runs[name] = {f.name: f.read_bytes() for f in (tmp_path / name).glob("ic_*")}
    err = capsys.readouterr().err
    assert err.count("complex arrays, float64") == 2 and "complex arrays, float32" in err
    assert len(runs["none"]) == 8 and runs["none"] == runs["f64"]
    assert runs["none"] != runs["f32"]


def test_df64_runs_as_native_float64(tmp_path, capsys):
    """--dtype df64 (in the JAX package float32 draws with emulated
    float64-grade transforms) exits 0, says on one stderr line that it runs
    as native float64, and gives a --dtype float64 run's bytes."""
    runs = {}
    for name in ("df64", "float64"):
        par = _write_par(tmp_path / f"{name}.par", tmp_path / name, ICFormat="RVdoubleZel")
        assert cli.main([str(par), "--device", "cpu", "--dtype", name]) == 0
        runs[name] = {f.name: f.read_bytes() for f in (tmp_path / name).glob("ic_*")}
        err = capsys.readouterr().err
        said = [ln for ln in err.splitlines() if "df64" in ln]
        assert len(said) == (1 if name == "df64" else 0)
        assert not said or "native float64" in said[0]
        assert "not ported" not in err and "complex arrays, float64" in err
    assert len(runs["df64"]) == 8 and runs["df64"] == runs["float64"]


@pytest.mark.parametrize("flags", [[], ["--dtype", "float64"], ["--dtype", "df64"],
                                   ["--out-of-core"], ["--part", "1"], ["--part", "2"]])
def test_float64_on_the_card_is_not_refused(tmp_path, capsys, monkeypatch, flags):
    """No float64 flow exits early for the card any more: with a card
    reported, the CLI goes on to build its model on it (and fails there in
    this test, which has none), and no message names ROADMAP A6."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    par = _write_par(tmp_path / "p.par", tmp_path / "ic")
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda|nvidia"):
        cli.main([str(par), *flags])
    err = capsys.readouterr().err
    assert "A6" not in err and "Generating ICs for ppd = 16" in err


@pytest.mark.parametrize("flags", [
    ["--out-of-core"], ["--out-of-core", "--slab-mb", "1"], ["--part", "1"],
])
def test_ported_flags_run(tmp_path, capsys, flags):
    """--out-of-core and --part no longer exit 1."""
    par = _write_par(tmp_path / "p.par", tmp_path / "ic", ZD_qPLT=0)
    assert cli.main([str(par), "--device", "cpu", *flags]) == 0
    assert "not ported" not in capsys.readouterr().err


def test_cuda_without_a_card_exits_1(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    par = _write_par(tmp_path / "p.par", tmp_path / "ic")
    assert cli.main([str(par)]) == 1  # --device cuda is the default
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "ic").exists()  # nothing ran on the CPU instead


def test_missing_parameter_file_exits_1(tmp_path, capsys):
    assert cli.main([str(tmp_path / "nope.par"), "--device", "cpu"]) == 1
    assert "not found" in capsys.readouterr().err
