"""The cell ``odd576.realizations`` on the CPU: the AbacusSummit small box
at a ppd that is not a power of two, through the model API's separate half
route (B3, the ky=0 fixup, the matrix-product DFTs of ``ops/mmfft.py``).

Its configuration cut to 24^3 and 48^3 (``rehearse.shrink``) is correct
against ``bench_torch/reference.py`` (plain float64 torch, no JAX) and its
float32 control is refused; the model takes the separate route there; the
configuration's own arithmetic at 576^3; the spans ``mmfft.zx`` and
``mmfft.c2r`` with their counts, and none on the B1/B2 route; the bound
that ``mmfft_roofline`` reads from them, against a reckoning by hand; and
the cell's reference, ``reference_sphere.py``, which decides the modes on
the k_cutoff sphere as the program does where ``reference.py`` does not,
and differs from it in that one line only.
"""

import difflib
import inspect
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zeldovich_tpu_torch.models import pipeline
from zeldovich_tpu_torch.models.pipeline import Zeldovich
from zeldovich_tpu_torch.ops.synth import fft_kernels_take
from zeldovich_tpu_torch.utils import timers
from zeldovich_tpu_torch.utils.params import Parameters

BENCH = Path(__file__).resolve().parent.parent / "bench_torch"
sys.path.insert(0, str(BENCH))

import checks  # noqa: E402
import control  # noqa: E402
import reference  # noqa: E402
import reference_sphere  # noqa: E402
import rehearse  # noqa: E402
import run  # noqa: E402
from mixes import par_keys  # noqa: E402
from zeldovich_tpu_torch.utils.power import n2_cutoff  # noqa: E402

torch.set_num_threads(1)

CELL = "odd576.realizations"
SEED = 2**31 + 2**30 + 25
NARRAY = 4  # PLT: density and displacements, then the velocities
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


def _sphere_zeroed(ppd, box, nyq):
    """Whether a float64 sphere rule with this Nyquist wavenumber zeroes
    the modes on the sphere, n2 = (ppd/2)^2."""
    fund = 2.0 * math.pi / box
    return (ppd // 2) ** 2 * (fund * fund) >= nyq * nyq


def _config(ppd):
    config = json.loads((BENCH / "configs" / "odd576.json").read_text())
    if ppd is not None:
        rehearse.shrink(ppd)(config)
    return config


def _model(ppd, tmp_path, seed=12345, box=None):
    config = _config(ppd)
    if box is not None:
        config["par"]["BoxSize"] = box
    keys = par_keys(run.ROOT, config, seed, tmp_path / "unused")
    return Zeldovich(Parameters.from_dict(keys), dtype=torch.float64, device="cpu"), keys


def _mmfft_records(fn):
    """fn() under a CPU profiler, and the mmfft.* span records it left."""
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
    recs = [r for r in timers.records(t0, t1) if r["name"].startswith("mmfft.")]
    return out, recs, (t0, t1)


@pytest.mark.parametrize("ppd", (24, 48))
def test_cell_is_correct_at_a_ppd_that_is_not_a_power_of_two(ppd, tmp_path):
    res = run.measure(CELL, SEED, 0.3, False, "cpu", run_dir=tmp_path / "run",
                      resize=rehearse.shrink(ppd))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"mem_Mpart_s", "peak_dev_GiB", "setup_s"}


def test_float32_control_is_refused(tmp_path):
    res = control.control(CELL, SEED, 0.3, "cpu", resize=rehearse.shrink(24),
                          run_dir=tmp_path / "run")
    assert not res["correct"], res["checks"]


def test_model_takes_the_separate_route(tmp_path, monkeypatch):
    """At 24^3 PLT float64 the step is B3 once and the matrix products,
    never B1 or B2, and its output is within the cell's limits of the
    reference."""
    calls = {"halfspace_pack": 0, "halfspace_pack_zx": 0, "c2r_y": 0}

    def counted(name):
        f = getattr(pipeline, name)

        def g(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return g

    for name in calls:
        monkeypatch.setattr(pipeline, name, counted(name))
    m, keys = _model(24, tmp_path)
    out = m.xspace_half_pair()
    assert calls == {"halfspace_pack": 1, "halfspace_pack_zx": 0, "c2r_y": 0}
    assert tuple(out.shape) == (NARRAY, 2, 24, 24, 24)
    numbers = checks.check_pairs(out, reference_sphere.fields(keys, run.ROOT, device="cpu"), 24)
    good, shown = checks.verdict(numbers, LIMITS)
    assert good, shown


def test_configuration_arithmetic():
    """576^3 particles at the source's spacing, 500/1728 Mpc/h, and a ppd
    the FFT kernels do not take."""
    par = _config(None)["par"]
    ppd = round(par["NP"] ** (1 / 3))
    assert ppd == 576 and par["NP"] == 576**3 == (1728 // 3) ** 3
    assert par["BoxSize"] / ppd == pytest.approx(500 / 1728, rel=1e-15)
    assert not fft_kernels_take(576) and fft_kernels_take(512)
    assert int(par["ZD_qPLT"]) == 1 and _config(None)["dtype"] == "float64"


def test_one_zx_and_one_c2r_span_a_realization(tmp_path):
    """The separate route's two passes are one span each, with the length,
    the operand's complex elements and the chunk loop's passes."""
    m, _ = _model(24, tmp_path)
    _, recs, _ = _mmfft_records(m.xspace_half_pair)
    assert [r["name"] for r in recs] == ["mmfft.zx", "mmfft.c2r"]
    # the packed spectrum (narray, +/-, re/im, ky = 13, z, x): as pairs of
    # 8 blocks of (13, 24, 24) complex elements; the c2r's operand the same
    elems = NARRAY * 2 * 13 * 24 * 24
    zx, c2r = recs
    assert zx["counts"] == {"n": 24, "elems": elems, "chunks": NARRAY * 2}
    assert c2r["counts"] == {"n": 24, "elems": elems, "chunks": NARRAY}
    assert zx["t1"] <= c2r["t0"]


def test_no_mmfft_span_on_the_fused_route(tmp_path):
    """At 32^3 the step is B1/B2 (their plain versions here): no
    matrix-product pass runs, so no mmfft span."""
    m, _ = _model(32, tmp_path)
    out, recs, _ = _mmfft_records(m.xspace_half_pair)
    assert tuple(out.shape) == (NARRAY, 2, 32, 32, 32) and recs == []


def test_roofline_bound_is_the_transforms(tmp_path):
    """``mmfft_roofline`` reads one realization's spans at 24^3 as 5 n
    log2 n a complex DFT (two an element for zx, one for the c2r) and the
    operand's bytes read once and written once, over the card's busy time
    in the spans."""
    m, _ = _model(24, tmp_path)
    _, recs, (t0, t1) = _mmfft_records(m.xspace_half_pair)
    assert len(recs) == 2
    busy = {"mmfft.zx": [2e-3], "mmfft.c2r": [1e-3]}
    fake = SimpleNamespace(config={"dtype": "float64"}, requests=[{"t0": t0, "t1": t1}],
                           busy_in=busy.__getitem__)
    elems, n, s = NARRAY * 2 * 13 * 24 * 24, 24, 8
    moved = 4 * elems * s / 3.35e12
    zx = max(moved, 2 * 5 * n * math.log2(n) * elems / n / 33.5e12)
    c2r = max(moved, 5 * n * math.log2(n) * elems / n / 33.5e12)
    read = run.load_reader("mmfft_roofline.mem")
    assert read(fake) == pytest.approx(100 * (zx + c2r) / 3e-3, rel=1e-12)
    assert run.load_reader("mmfft_roofline.mem")(
        SimpleNamespace(config={"dtype": "float64"}, requests=[], busy_in=busy.__getitem__)
    ) is None


def test_reference_sphere_is_the_reference_at_this_size(tmp_path):
    """The cell names ``reference_sphere``; at the rehearsal's 24^3 both
    Nyquist forms round alike, and its fields are ``reference.py``'s bit
    for bit."""
    assert _config(None)["reference"] == "reference_sphere"
    _, keys = _model(24, tmp_path)
    for (a, fa), (b, fb) in zip(reference.fields(keys, run.ROOT, device="cpu"),
                                reference_sphere.fields(keys, run.ROOT, device="cpu")):
        assert a == b and torch.equal(fa, fb)


def test_reference_sphere_parts_from_reference_at_one_line_only():
    """``reference_sphere.fields`` is a copy of ``reference.fields`` until
    both references take the C++'s Nyquist form (ROADMAP E10): the two
    bodies may differ in the line that derives the Nyquist wavenumber and
    nowhere else, so a change to one that is not made to the other fails
    here."""
    a = inspect.getsource(reference.fields).splitlines()
    b = inspect.getsource(reference_sphere.fields).splitlines()
    changed = [line for line in difflib.unified_diff(a, b, lineterm="", n=0)
               if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    assert changed == ["-    nyq = math.pi * ppd / box",
                       "+    nyq = math.pi / (box / ppd)  # pi / separation, as parameters.cpp "
                       "derives it"]


#: 24^3 boxes on which pi ppd / BoxSize and pi / (BoxSize / ppd) round the
#: sphere's modes apart: reference.py keeps them where the C++ zeroes them,
#: then the other way round
TIE_BOXES = (6.943061805555556, 6.943057638888889)


@pytest.mark.parametrize("box", TIE_BOXES)
def test_sphere_modes_decided_as_the_program(box, tmp_path):
    """On a box where the two forms of the Nyquist wavenumber round the
    sphere apart, the program is within the cell's limits of
    ``reference_sphere`` and far outside them of ``reference.py``."""
    cpp = _sphere_zeroed(24, box, math.pi / (box / 24))
    assert cpp != _sphere_zeroed(24, box, math.pi * 24 / box)
    m, keys = _model(24, tmp_path, box=box)
    assert (m.cfg.n2_cutoff <= 12 * 12) == cpp
    out = m.xspace_half_pair()
    good, shown = checks.verdict(
        checks.check_pairs(out, reference_sphere.fields(keys, run.ROOT, device="cpu"), 24),
        LIMITS)
    assert good, shown
    plain = checks.check_pairs(out, reference.fields(keys, run.ROOT, device="cpu"), 24)
    assert plain["density_gap"] > 1e3 * LIMITS["density_gap"]


def test_sphere_at_the_cells_size():
    """At 576^3 in 500/3 Mpc/h the program zeroes the sphere's modes
    (n2_cutoff = 288^2), as ``reference_sphere``'s form does, where
    ``reference.py``'s form keeps them."""
    par = _config(None)["par"]
    box = par["BoxSize"]
    assert n2_cutoff(Parameters.from_dict(par_keys(run.ROOT, _config(None), 1,
                                                   Path("unused")))) == 288**2
    assert _sphere_zeroed(576, box, math.pi / (box / 576))
    assert not _sphere_zeroed(576, box, math.pi * 576 / box)
