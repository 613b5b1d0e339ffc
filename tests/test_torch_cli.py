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
    JAX CLI does: the phi grid lives beside the k-space arrays."""
    par = _write_par(tmp_path / "p.par", tmp_path / "ic", **over)
    assert cli.main([str(par), "--device", "cpu"]) == 0
    gib = (16 / 1024.0) ** 3 * narrays * 8
    assert (f"Device-resident k-space state: {gib:5.3f} GiB "
            f"({narrays} complex arrays, float32)") in capsys.readouterr().err


@pytest.mark.parametrize(
    "flags,item",
    [(["--sharded"], "A10"), (["--distributed"], "A10"),
     (["--profile", "d"], "A11"), (["--dtype", "df64"], "A6"),
     (["--coordinator", "localhost:1234"], "A10"), (["--num-processes", "2"], "A10"),
     (["--process-id", "0"], "A10")],
)
def test_unported_flags_exit_1(tmp_path, capsys, flags, item):
    par = _write_par(tmp_path / "p.par", tmp_path / "ic")
    assert cli.main([str(par), "--device", "cpu", *flags]) == 1
    assert f"ROADMAP {item}" in capsys.readouterr().err


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


@pytest.mark.parametrize("fmt,flags,warned", [
    ("RVdoubleZel", [], True), ("RVdoubleZel", ["--dtype", "float32"], False),
    ("RVdoubleZel", ["--dtype", "float64"], False), ("RVZel", [], False),
    ("Zeldovich", [], True), ("ZelSimple", [], False),
])
def test_float32_default_is_announced_for_a_double_format(tmp_path, capsys, fmt,
                                                          flags, warned):
    """The port computes in float32 unless told otherwise, where the JAX
    CLI defaults to float64: a .par that asks for a double ic_* format
    without --dtype gets one stderr line saying so, and no other run does."""
    par = _write_par(tmp_path / "p.par", tmp_path / "ic", ICFormat=fmt,
                     ZD_qPLT=int(fmt.startswith("RV")))  # PLT needs velocities
    assert cli.main([str(par), "--device", "cpu", *flags]) == 0
    err = capsys.readouterr().err
    line = [ln for ln in err.splitlines() if "float32 rounding" in ln]
    assert len(line) == (1 if warned else 0)
    if warned:
        assert "--dtype float64 --device cpu" in line[0] and "A6" in line[0]


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
