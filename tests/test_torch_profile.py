"""The port's ``--profile DIR`` (torch.profiler) on the CPU: one trace a
rank and run, the phases of the timer report as named ranges, the same
``ic_*`` bytes as without the flag, nothing written for a refused run."""

import argparse
import contextlib
import json
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zeldovich_tpu_torch import cli
from zeldovich_tpu_torch.utils.timers import PhaseTimers

torch.set_num_threads(1)

ASSETS = Path(__file__).parent.parent / "zeldovich_tpu" / "assets"
FNL = dict(ZD_f_NL=10.0, ZD_n_s=0.96, Omega_M=0.3)
#: name -> (.par keys over the base, CLI flags)
FLOWS = {
    "plain": ({}, []),
    "plt": (dict(ZD_qPLT=1), []),
    "fnl": (FNL, []),
    "float32": ({}, ["--dtype", "float32"]),
    "out_of_core": ({}, ["--out-of-core", "--slab-mb", "64"]),
}


def _write_par(path, outdir, **over):
    d = dict(
        BoxSize=100.0, NP=16**3, CPD=8, ICFormat="RVZel",
        InitialConditionsDirectory=str(outdir), InitialRedshift=49.0,
        ZD_Seed=1234, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
        ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0,
        ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
        ZD_qPLT=0, ZD_PLT_filename=str(ASSETS / "eigmodes128"),
    )
    d.update(over)
    path.write_text("".join(
        f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
        for k, v in d.items()
    ))
    return str(path)


def _ic(d):
    files = {f.name: f.read_bytes() for f in Path(d).glob("ic_*")}
    assert len(files) == 8
    return files


def _phases(err):
    """The phase names of the timer report ("<name> took <s> seconds")."""
    return set(re.findall(r"^(.+) took [0-9.]+ seconds$", err, re.M))


def _traces(d, rank=0):
    return sorted(Path(d).glob(f"rank{rank}.*.pt.trace.json"))


def _annotations(trace):
    events = json.loads(Path(trace).read_text())["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_profile_writes_one_trace_and_the_same_bytes(tmp_path, capsys, flow):
    """The run with --profile exits 0 and writes the ic_* bytes of the run
    without it, and exactly one rank0 trace, which parses and names every
    phase the run's report prints."""
    over, flags = FLOWS[flow]
    plain = _write_par(tmp_path / "a.par", tmp_path / "a", **over)
    assert cli.main([plain, "--device", "cpu", *flags]) == 0
    capsys.readouterr()
    traced = _write_par(tmp_path / "b.par", tmp_path / "b", **over)
    d = tmp_path / "trace"
    assert cli.main([traced, "--device", "cpu", *flags, "--profile", str(d)]) == 0
    err = capsys.readouterr().err
    assert _ic(tmp_path / "b") == _ic(tmp_path / "a")
    assert [p.name for p in d.iterdir()] == [p.name for p in _traces(d)]
    (trace,) = _traces(d)
    phases = _phases(err)
    assert "Model setup (P(k), RNG tables, eigenmodes)" in phases
    assert phases <= _annotations(trace)


@pytest.mark.parametrize("ooc", [[], ["--out-of-core"]], ids=["in_core", "out_of_core"])
def test_part_1_then_2_keep_both_traces(tmp_path, ooc):
    """--part 1 then --part 2 into one DIR: two traces, one a run, and the
    part-2 bytes are the one-shot run's."""
    one = _write_par(tmp_path / "one.par", tmp_path / "one")
    assert cli.main([one, "--device", "cpu", *ooc]) == 0
    par = _write_par(tmp_path / "p.par", tmp_path / "ic")
    d = tmp_path / "trace"
    for part in ("1", "2"):
        assert cli.main([par, "--device", "cpu", *ooc, "--part", part,
                         "--profile", str(d)]) == 0
        assert len(_traces(d)) == int(part)
    assert _ic(tmp_path / "ic") == _ic(tmp_path / "one")
    names = [_annotations(t) for t in _traces(d)]
    writing = "Out-of-core streamed run" if ooc else "Writing k-space checkpoint"
    assert writing in names[0] or writing in names[1]


@pytest.mark.parametrize("case", ["missing", "invalid", "partial_triple"])
def test_a_refused_run_writes_no_trace(tmp_path, capsys, case):
    """A run refused before its memory plan exits 1 and creates no DIR."""
    par = tmp_path / "p.par"
    flags = []
    if case == "invalid":
        _write_par(par, tmp_path / "ic", ZD_Version=7)
    elif case == "partial_triple":
        _write_par(par, tmp_path / "ic")
        flags = ["--num-processes", "2"]
    d = tmp_path / "trace"
    assert cli.main([str(par), "--device", "cpu", *flags, "--profile", str(d)]) == 1
    assert capsys.readouterr().err
    assert not d.exists() and not (tmp_path / "ic").exists()


def test_card_run_without_a_card_profiler_exits_1(tmp_path, capsys, monkeypatch):
    """--device cuda --profile where torch.profiler cannot trace the card
    exits 1 before the model is built: no run carries on with a trace of
    the host alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    par = _write_par(tmp_path / "p.par", tmp_path / "ic")
    d = tmp_path / "trace"
    assert cli.main([par, "--profile", str(d)]) == 1
    err = capsys.readouterr().err
    assert "cannot trace the card" in err and "Model setup" not in err
    assert not d.exists() and not (tmp_path / "ic").exists()


@pytest.mark.parametrize("body", ["returns_0", "returns_1", "raises"])
def test_a_card_trace_without_card_activity_fails(tmp_path, capsys, monkeypatch, body):
    """A card run whose trace holds no activity of the card: a run that
    finished exits 1 saying so (CUPTI that traced nothing is no hidden
    failure); a run that failed on its own keeps its own exit code or
    exception, with no word of the trace.  The trace is written each time."""
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU, ProfilerActivity.CUDA})

    def steps(*_):
        torch.ones(4).sum()
        if body == "raises":
            raise ValueError("the run's own error")
        return int(body[-1])

    monkeypatch.setattr(cli, "_steps", steps)
    par = _write_par(tmp_path / "p.par", tmp_path / "ic")
    d = tmp_path / "trace"
    with (pytest.raises(ValueError, match="own error") if body == "raises"
          else contextlib.nullcontext()):
        # main's run past its checks, on a torch that has no card
        args = argparse.Namespace(param_file=par, part=None, dtype="float64",
                                  device="cuda", profile=str(d))
        assert cli._run(args, None, 0.0) == 1
    said = "holds no activity of the card" in capsys.readouterr().err
    assert said == (body == "returns_0")
    assert len(_traces(d)) == 1


@pytest.mark.parametrize("device,waits", [("cuda", True), ("cpu", False)])
def test_a_card_trace_waits_before_the_run(tmp_path, monkeypatch, device, waits):
    """On the card the run starts CUPTI_SETTLE_S after the profiler (a
    kernel right after the start can lose the trace's device activity);
    a trace of the host alone does not wait, nor asks for the card's
    activity."""
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU, ProfilerActivity.CUDA})
    slept = []
    monkeypatch.setattr(cli.time, "sleep", slept.append)
    with cli._traced(str(tmp_path / "trace"), device, 0) as saw_the_card:
        assert slept == ([cli.CUPTI_SETTLE_S] if waits else [])
    # this torch has no card: a card trace holds none of its activity
    assert saw_the_card() is not waits


def test_phase_opens_a_named_range():
    """PhaseTimers.phase opens a record_function range of its name, which
    a CPU profile shows, and still times the phase."""
    timers = PhaseTimers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.phase("Inverse FFT"):
            torch.ones(8).sum()
    names = [e.key for e in prof.key_averages()]
    assert "Inverse FFT" in names
    assert timers["Inverse FFT"].elapsed > 0
