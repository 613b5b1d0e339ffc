"""The port's spans (``utils/timers.py::span``) on the CPU: nothing but a
given timer with no profiler running; under one, a record and a named
range of each span, the spans of an out-of-core CLI run on the main and
the writer threads, the set-up spans of a PLT model, the writer thread's
ranges in a ``--profile`` trace, the same ``ic_*`` bytes traced and not,
and the benchmark's readers of the span records on each cell's CPU
rehearsal."""

import json
import sys
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_profile import _traces, _write_par
from zeldovich_tpu_torch import cli
from zeldovich_tpu_torch.models.pipeline import Zeldovich
from zeldovich_tpu_torch.utils import timers
from zeldovich_tpu_torch.utils.output import OutputWriter
from zeldovich_tpu_torch.utils.params import Parameters
from zeldovich_tpu_torch.utils.timers import STimer, span

torch.set_num_threads(1)

BENCH = Path(__file__).parent.parent / "bench_torch"
PHASE = "Out-of-core streamed run"
#: 64^3 float64 out of core in 1 MB slabs: 8 slabs a pass
OOC = ["--device", "cpu", "--out-of-core", "--slab-mb", "1"]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("timed", [False, True], ids=["no_timer", "timer"])
def test_span_without_a_profiler_records_nothing(monkeypatch, timed):
    """With no profiler running a span opens no range and keeps no
    record; a given timer still adds each span's seconds."""
    opened = []
    monkeypatch.setattr(timers._profiler, "record_function", opened.append)
    before = len(timers.records())
    timer = STimer() if timed else None
    for _ in range(2):
        with span("test.off", timer, bytes=8) as counts:
            torch.ones(64).sum()
    assert counts == {"bytes": 8}
    assert not timers.tracing() and opened == []
    assert len(timers.records()) == before
    if timed:
        assert timer.elapsed > 0


@pytest.fixture(scope="module")
def nested(tmp_path_factory):
    """(records, Chrome trace events) of a span nested in another under a
    CPU profiler."""
    with _cpu_profile() as prof:
        with span("test.outer", slabs=3):
            with span("test.inner") as counts:
                torch.ones(1 << 16).cumsum(0)
                counts["bytes"] = 512
    path = tmp_path_factory.mktemp("nested") / "trace.json"
    prof.export_chrome_trace(str(path))
    recs = {r["name"]: r for r in timers.records() if r["name"].startswith("test.")}
    events = json.loads(path.read_text())["traceEvents"]
    return recs, [e for e in events if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("name, parent, counts", [
    ("test.outer", None, {"slabs": 3}),
    ("test.inner", "test.outer", {"bytes": 512}),
])
def test_span_under_a_profiler_records_and_opens_a_range(nested, name, parent, counts):
    """A span's record holds its name, thread, t0 < t1, parent and counts;
    its range is in the Chrome trace, as long as the record within 1 ms."""
    recs, ranges = nested
    rec = recs[name]
    assert rec["thread"] == "MainThread" and rec["t0"] < rec["t1"]
    assert rec["parent"] == (None if parent is None else recs[parent]["index"])
    assert rec["counts"] == counts
    (event,) = [e for e in ranges if e["name"] == name]
    assert abs(float(event["dur"]) * 1e-6 - (rec["t1"] - rec["t0"])) < 1e-3


def test_spans_of_many_threads_keep_their_own_parents():
    """Threads that open spans at once under a profiler, with the
    interpreter switching threads as often as it can: every record is
    kept once, with an index of its own, and each inner span's parent is
    its own thread's outer span, the outer one's the span its thread
    adopted."""
    threads, each = 16, 50
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            with span("test.root"):
                root = timers.current()

                def work():
                    timers.adopt(root)
                    for _ in range(each):
                        with span("test.outer"):
                            with span("test.inner"):
                                pass
                pool = [threading.Thread(target=work, name=f"test-{i}")
                        for i in range(threads)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    recs = [r for r in timers.records() if r["thread"].startswith("test-")]
    assert len(recs) == 2 * threads * each
    assert len({r["index"] for r in recs}) == len(recs)
    by_index = {r["index"]: r for r in recs}
    for r in recs:
        if r["name"] == "test.inner":
            outer = by_index[r["parent"]]
            assert outer["name"] == "test.outer" and outer["thread"] == r["thread"]
        else:
            assert r["parent"] == root


@pytest.fixture(scope="module")
def ooc_run(tmp_path_factory):
    """A 64^3 out-of-core CLI run under a CPU profiler and the same run
    without: (its span records, the traced writer's bytes_written, the
    ic_* bytes of each)."""
    d = tmp_path_factory.mktemp("ooc")
    written = []
    close = OutputWriter.close

    def noted_close(self):
        written.append(self.bytes_written)
        close(self)

    ic = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(OutputWriter, "close", noted_close)
        for traced in (True, False):
            par = _write_par(d / f"{traced}.par", d / str(traced), NP=64**3, CPD=8)
            if traced:
                with _cpu_profile():
                    assert cli.main([par, *OOC]) == 0
                phase = [r for r in timers.records() if r["name"] == PHASE][-1]
                recs = timers.records(phase["t0"], phase["t1"])
            else:
                assert cli.main([par, *OOC]) == 0
            ic[traced] = {f.name: f.read_bytes() for f in (d / str(traced)).glob("ic_*")}
    return recs, written[0], ic


@pytest.mark.parametrize("name, least", [
    ("ooc.pass1", 1), ("stage.sink", 8), ("stage.gather", 8),
    ("output.combine", 1), ("output.submit_wait", 1),
])
def test_out_of_core_run_records_main_thread_spans(ooc_run, name, least):
    """Pass 1 with a stage write of each of its 8 slabs inside it, pass
    2's gathers, the pair -> complex step and the waits on the writer, on
    the main thread."""
    recs = [r for r in ooc_run[0] if r["name"] == name]
    assert len(recs) >= least
    assert {r["thread"] for r in recs} == {"MainThread"}
    if name == "ooc.pass1":
        (pass1,) = recs
        sinks = [r for r in ooc_run[0]
                 if r["name"] == "stage.sink" and r["parent"] == pass1["index"]]
        assert len(sinks) == 8


def test_writer_thread_spans_lead_back_to_the_phase(ooc_run):
    """output.pack and output.write run on the writer thread, a pair a
    z-plane, each with a parent chain that ends at the CLI's phase; their
    bytes are what the writer counted."""
    recs, written, _ = ooc_run
    by_index = {r["index"]: r for r in recs}
    writes = [r for r in recs if r["name"] == "output.write"]
    packs = [r for r in recs if r["name"] == "output.pack"]
    assert len(writes) == len(packs) == 64
    for r in writes + packs:
        assert r["thread"] == "zt-slab-writer"
        while r["parent"] is not None:
            r = by_index[r["parent"]]
        assert r["name"] == PHASE
    assert sum(r["counts"]["bytes"] for r in writes) == written > 0


def test_traced_run_writes_the_same_bytes(ooc_run):
    traced, untraced = ooc_run[2][True], ooc_run[2][False]
    assert len(traced) == 8 and traced == untraced


#: a PLT model's set-up spans: (thread, parent span's name) of each
SETUP_SPANS = {
    "setup.power": ("MainThread", None),
    "setup.eigmodes": ("zt-eigmodes", None),
    "setup.rng_tables": ("MainThread", None),
    "setup.eig_wait": ("MainThread", "setup.rng_tables"),
    "static.plt_coefs": ("MainThread", None),
}


@pytest.mark.parametrize("name", list(SETUP_SPANS))
def test_plt_model_records_setup_spans(tmp_path, name):
    """A PLT model's set-up tables, split three ways, and its coefficient
    planes, each a span of its own on the main thread; the table read on
    its worker thread (``bytes``: the 128^3 table's payload), the wait for
    it inside ``setup.rng_tables``."""
    par = _write_par(tmp_path / "a.par", tmp_path / "a", ZD_qPLT=1)
    with _cpu_profile():
        t0 = time.perf_counter()
        m = Zeldovich(Parameters.from_file(par), device="cpu")
        _ = m.plt_coefs
    recs = timers.records(t0)
    found = [r for r in recs if r["name"] == name]
    thread, parent = SETUP_SPANS[name]
    assert len(found) == 1 and found[0]["thread"] == thread
    by_index = {r["index"]: r for r in recs}
    assert (found[0]["parent"] if parent is None
            else by_index[found[0]["parent"]]["name"]) == parent
    if name == "setup.eigmodes":
        assert found[0]["counts"] == {"bytes": 128 * 128 * 65 * 4 * 8}


@pytest.mark.parametrize("plt", [1, 0], ids=["plt", "plain"])
def test_table_read_takes_the_open_span_as_parent(tmp_path, plt):
    """Made inside an open span, a PLT model's ``setup.eigmodes`` takes it
    as parent; a model without PLT records neither the read nor the
    wait."""
    par = _write_par(tmp_path / "a.par", tmp_path / "a", ZD_qPLT=plt)
    with _cpu_profile():
        t0 = time.perf_counter()
        with span("test.outer"):
            outer = timers.current()
            Zeldovich(Parameters.from_file(par), device="cpu")
    recs = [r for r in timers.records(t0) if r["name"] in ("setup.eigmodes", "setup.eig_wait")]
    if not plt:
        assert recs == []
        return
    (read,) = [r for r in recs if r["name"] == "setup.eigmodes"]
    assert read["parent"] == outer and read["thread"] == "zt-eigmodes"
    assert [r["thread"] for r in recs if r["name"] == "setup.eig_wait"] == ["MainThread"]


@pytest.mark.parametrize("ppd, over", [(16, {}), (64, {}),
                                      (16, dict(ZD_f_NL=30.0, ZD_n_s=0.96, Omega_M=0.3)),
                                      (16, dict(ZD_CornerModes=1))],
                         ids=["16", "64", "fnl16", "corner16"])
def test_setup_power_counts_one_pass(tmp_path, ppd, over):
    """``setup.power`` counts the k values through the spline (one pass:
    at k_cutoff 1 the (ppd/2)^2 - 1 n2 in (0, (ppd/2)^2) that the k_cutoff
    sphere keeps; under f_NL and CornerModes the whole table, 3 (ppd/2)^2
    past n2 = 0), the entries set to 0 without one (the rest of the
    3 (ppd/2)^2 + 1), the Romberg sigma integrals (Pk_sigma: the input
    sigma once, the final sigma once) and the M(k) table's entries (the
    whole table under f_NL, 0 without it)."""
    par = _write_par(tmp_path / "a.par", tmp_path / "a", NP=ppd**3, **over)
    with _cpu_profile():
        t0 = time.perf_counter()
        Zeldovich(Parameters.from_file(par), device="cpu")
    (rec,) = [r for r in timers.records(t0) if r["name"] == "setup.power"]
    h2 = (ppd // 2) ** 2
    live = 3 * h2 + 1 if over else h2
    m_points = 3 * h2 + 1 if "ZD_f_NL" in over else 0
    assert rec["counts"] == {"spline_points": live - 1, "n2_zeroed": 3 * h2 + 1 - live,
                             "sigma_integrals": 2, "m_points": m_points}


@pytest.mark.parametrize("plt", [1, 0], ids=["plt", "plain"])
def test_fnl_step_records_its_spans(tmp_path, plt):
    """An f_NL step through the model API: one ``fnl.phi_pass`` with its
    two 3-D transforms, holding the first ``full.synth`` (phi, one array);
    then the main assembly's ``full.synth`` (four arrays with PLT, two
    without), each over its y-chunks (one at 16^3)."""
    par = _write_par(tmp_path / "a.par", tmp_path / "a", ZD_f_NL=30.0, ZD_n_s=0.96,
                     Omega_M=0.3, ZD_qPLT=plt)
    m = Zeldovich(Parameters.from_file(par), device="cpu")
    with _cpu_profile():
        t0 = time.perf_counter()
        m.xspace_half_pair()
    recs = [r for r in timers.records(t0) if r["name"] in ("fnl.phi_pass", "full.synth")]
    assert [r["name"] for r in recs] == ["full.synth", "fnl.phi_pass", "full.synth"]
    phi_synth, phi_pass, synth = recs
    assert phi_pass["counts"] == {"transforms": 2} and phi_pass["parent"] is None
    assert phi_synth["counts"] == {"arrays": 1, "chunks": 1}
    assert phi_synth["parent"] == phi_pass["index"]
    assert synth["counts"] == {"arrays": 4 if plt else 2, "chunks": 1}
    assert synth["parent"] is None and synth["t0"] >= phi_pass["t1"]


def test_profile_holds_writer_thread_ranges(tmp_path):
    """--profile traces every thread: its trace of an out-of-core run
    holds output.write ranges on a thread other than the phase's."""
    par = _write_par(tmp_path / "a.par", tmp_path / "a")
    d = tmp_path / "trace"
    assert cli.main([par, *OOC, "--profile", str(d)]) == 0
    (trace,) = _traces(d)
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    (phase,) = [e for e in events if e["name"] == PHASE]
    writes = [e for e in events if e["name"] == "output.write"]
    assert writes and all(e["tid"] != phase["tid"] for e in writes)


CELL_METRICS = {
    "demo_ooc.jobs": ["ooc_pass1_share.file", "stage_host_share.file",
                      "copy_wait_share.file", "combine_share.file",
                      "writer_wait_share.file", "write_MBps.file"],
    "abacus_small_plt.realizations": ["setup_power_ms.mem", "setup_rng_ms.mem",
                                      "setup_eig_ms.mem", "static_plt_ms.mem",
                                      "setup_eig_wait_ms.mem"],
    "abacus_base_plt4.sharded_realizations": ["exchange_ms.mem", "static_plt_ms.mem",
                                              "setup_eig_wait_ms.mem"],
    "odd576.realizations": ["mmfft_ms.mem", "setup_power_ms.mem", "setup_rng_ms.mem",
                            "setup_eig_ms.mem", "static_plt_ms.mem",
                            "setup_eig_wait_ms.mem"],
}

#: the rehearsal's ppd of a cell where not 16: the 576^3 cell at a ppd that
#: is not a power of two either, so that it takes the separate half route
#: (at 16 it would take B1/B2)
REHEARSAL_PPD = {"odd576.realizations": 24}


@pytest.fixture(scope="module")
def rehearsals(tmp_path_factory):
    """Each cell's traced CPU rehearsal at its ppd (``REHEARSAL_PPD``, else
    16; a closure: run once a cell)."""
    sys.path.insert(0, str(BENCH))
    import rehearse
    import run

    done = {}

    def result(cell):
        if cell not in done:
            done[cell] = run.measure(cell, 2**31 + 2**30 + 5, 0.3, True, "cpu",
                                     resize=rehearse.shrink(REHEARSAL_PPD.get(cell, 16)),
                                     run_dir=tmp_path_factory.mktemp("bench"))
        return done[cell]
    return result


@pytest.mark.parametrize("cell, metric", [(c, m) for c, ms in CELL_METRICS.items()
                                          for m in ms])
def test_reader_returns_a_number(rehearsals, cell, metric):
    """Each reader of the span records reads a number on its cell's CPU
    rehearsal, which stays correct."""
    res = rehearsals(cell)
    assert res["correct"]
    value = res["metrics"][metric]["value"]
    assert isinstance(value, float) and value >= 0
