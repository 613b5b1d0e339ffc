"""Local f_NL on the full-grid route against the plain reference
``bench_torch/reference_fnl.py`` on the CPU.

* The port's ``Zeldovich.xspace_half_pair()`` (which falls back to the
  full grid under f_NL) against ``reference_fnl.fields`` at 16^3 and
  32^3, f_NL = +-100, PLT on and off, two seeds, float64.  Tolerance
  1e-12 of each field's largest value: the port draws with its own log
  and sin/cos and transforms with its own DFTs, the reference with
  torch's, so each value rounds differently (the measured gap is
  ~3e-14); a term left out or a sign flipped is far above it.
* ``reference_fnl`` against the JAX package's full-grid step at 16^3,
  which pins the definition both follow; the same 1e-12.
* The benchmark's cell ``abacus_small_png.realizations`` through
  ``run.measure`` at 32^3 (``rehearse.shrink``), against the limits of
  its limits file: the sound run's density and displacements, its
  velocities through ``checks.check_pairs`` with the one slot that holds
  no field set aside, the float32 control and the f_NL term left out,
  and the reference module the configuration names.  ``check_pairs``
  holds array 2's real part to literal zeros; under f_NL that slot
  carries the Nyquist modes' anti-Hermitian part (the reference's step 9),
  which at 32^3 reads above the velocity limit, so the whole run's
  ``vel_gap`` is not asserted here.

The parameters are the AbacusSummit small box's (the benchmark's
``abacus_small_plt``) with local f_NL and the base cosmology c000's n_s
and Omega_M, cut to ppd as ``rehearse.shrink`` cuts a cell.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.utils.params import Parameters as JParameters
from zeldovich_tpu_torch.models import pipeline
from zeldovich_tpu_torch.models.pipeline import Zeldovich
from zeldovich_tpu_torch.utils.params import Parameters

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_torch"
sys.path.insert(0, str(BENCH))

import checks  # noqa: E402
import control  # noqa: E402
import reference_fnl  # noqa: E402
import rehearse  # noqa: E402
import run  # noqa: E402

torch.set_num_threads(1)

SMALL_BOX = "abacus_small_plt.realizations"
CELL = "abacus_small_png.realizations"
#: local f_NL with AbacusSummit c000's n_s and Omega_M (Planck 2018)
FNL = {"ZD_f_NL": 100.0, "ZD_n_s": 0.9649, "Omega_M": 0.3152}
TOL = 1e-12


def _par(ppd, **over):
    """The small box's .par keys with ``FNL``, cut to ppd as
    ``rehearse.shrink`` cuts them, file names absolute."""
    config = run.load_cell(SMALL_BOX)[2]
    rehearse.shrink(ppd)(config)
    par = dict(config["par"], **FNL)
    par.update(InitialConditionsDirectory=str(ROOT / "unused"), **over)
    for k in ("ZD_Pk_filename", "ZD_PLT_filename"):
        par[k] = str(ROOT / par[k])
    return par


def _fields_close(out, par):
    """Each reference field against its slot of the step's output."""
    names = []
    for name, ref in reference_fnl.fields(par, ROOT, device="cpu"):
        a, c = checks.PAIR_SLOTS[name]
        scale = ref.abs().max().item()
        assert scale > 0, name
        gap = (out[a, c] - ref).abs().max().item()
        assert gap <= TOL * scale, (name, gap / scale)
        names.append(name)
    return names


@pytest.mark.parametrize("seed", [97531, 2**31 - 5])
@pytest.mark.parametrize("plt", [0, 1], ids=["plain", "plt"])
@pytest.mark.parametrize("f_nl", [100.0, -100.0], ids=["fnl+100", "fnl-100"])
@pytest.mark.parametrize("ppd", [16, 32])
def test_port_matches_reference(ppd, f_nl, plt, seed):
    par = _par(ppd, ZD_f_NL=f_nl, ZD_qPLT=plt, ZD_Seed=seed)
    m = Zeldovich(Parameters.from_dict(par), dtype=torch.float64, device="cpu")
    assert not m.half_exact
    out = m.xspace_half_pair()
    assert tuple(out.shape) == (4 if plt else 2, 2, ppd, ppd, ppd)
    names = _fields_close(out, par)
    assert names == list(reference_fnl.FIELDS if plt else reference_fnl.FIELDS[:4])


@pytest.mark.parametrize("plt", [0, 1], ids=["plain", "plt"])
def test_reference_matches_jax(plt):
    par = _par(16, ZD_qPLT=plt, ZD_Seed=97531)
    want = np.asarray(JZeldovich(JParameters.from_dict(par), dtype=jnp.float64).xspace_pair())
    _fields_close(torch.from_numpy(want.copy()), par)


def test_f_nl_moves_the_fields():
    """f_NL = 100 moves the reference's density by far more than its
    tolerance: the comparisons above see the term."""
    with_fnl = dict(reference_fnl.fields(_par(16, ZD_qPLT=0), ROOT, device="cpu"))
    without = dict(reference_fnl.fields(_par(16, ZD_qPLT=0, ZD_f_NL=0), ROOT, device="cpu"))
    d = (with_fnl["density"] - without["density"]).abs().max()
    assert d > 1e-6 * without["density"].abs().max()


@pytest.mark.parametrize("key, value", [("ZD_CornerModes", 1), ("ZD_Version", 1),
                                        ("ZD_k_cutoff", 2.0), ("ZD_qPLT_rescale", 1)])
def test_reference_refuses_what_it_does_not_compute(key, value):
    with pytest.raises(NotImplementedError, match=key):
        next(reference_fnl.fields(_par(16, **{key: value}), ROOT, device="cpu"))


# -- the benchmark's cell ---------------------------------------------------------
def _limits():
    return run.load_cell(CELL)[4]


def _measure(tmp_path, seed=2**31 + 7, resize=None, **given):
    small = rehearse.shrink(32)

    def both(config):
        small(config)
        if resize is not None:
            resize(config)
    return run.measure(CELL, seed, 0.3, False, "cpu", run_dir=tmp_path / "run",
                       resize=both, **given)


def test_cell_configuration_is_the_small_box_with_f_nl():
    """The cell's keys are the small box's with local f_NL, and it names
    ``reference_fnl``."""
    small, png = run.load_cell(SMALL_BOX)[2], run.load_cell(CELL)[2]
    assert png["par"] == dict(small["par"], **FNL)
    assert png["reference"] == "reference_fnl" and png["dtype"] == "float64"


def test_cell_takes_the_reference_it_names(tmp_path, monkeypatch):
    named = []
    load = run.load_reference

    def spy(name):
        named.append(name)
        return load(name)
    monkeypatch.setattr(run, "load_reference", spy)
    _measure(tmp_path)
    assert named == ["reference_fnl"]


@pytest.mark.parametrize("seed", [2**31 + 7, 3220000123])
def test_cell_sound_run_density_and_displacements(tmp_path, seed):
    res = _measure(tmp_path, seed)
    limits = _limits()
    assert res["failed"] == 0 and res["attempted"] > 0
    for name in ("shape_mismatch", "density_gap", "disp_gap"):
        assert res["checks"][name]["value"] <= limits[name], (name, res["checks"])


@pytest.mark.parametrize("seed", [97531, 3220000123])
def test_cell_step_fields_within_the_limits(seed):
    """Every field of the port's step against ``reference_fnl`` through the
    harness's ``check_pairs``, within the cell's limits, once array 2's
    real part (no field; the packing's (0, vel_x) array) is set aside."""
    config = run.load_cell(CELL)[2]
    rehearse.shrink(32)(config)
    par = dict(config["par"], ZD_Seed=seed, InitialConditionsDirectory=str(ROOT / "unused"))
    for k in ("ZD_Pk_filename", "ZD_PLT_filename"):
        par[k] = str(ROOT / par[k])
    out = Zeldovich(Parameters.from_dict(par), dtype=torch.float64,
                    device="cpu").xspace_half_pair()
    assert out[2, 0].abs().max() > 0  # the Nyquist modes' part, under f_NL
    out[2, 0] = 0.0
    nums = checks.check_pairs(out, reference_fnl.fields(par, ROOT, device="cpu"), 32)
    ok, shown = checks.verdict(nums, _limits())
    assert ok, shown


def test_cell_control_is_refused(tmp_path):
    """The float32 control is refused by the displacements, not by the
    slot that holds no field alone."""
    res = control.control(CELL, 2**31 + 7, 0.3, "cpu", resize=rehearse.shrink(32),
                          run_dir=tmp_path / "run")
    assert not res["correct"]
    assert res["checks"]["disp_gap"]["value"] > _limits()["disp_gap"], res["checks"]


def test_cell_refuses_the_f_nl_term_left_out(tmp_path, monkeypatch):
    """``phi_nl`` keeps phi's linear part: the density is refused."""
    def linear(phi, f_NL, inv_n3):
        phi.select(-4, 0).mul_(inv_n3)
        phi.select(-4, 1).zero_()
        return phi
    monkeypatch.setattr(pipeline, "phi_nl", linear)
    res = _measure(tmp_path)
    assert not res["correct"]
    assert res["checks"]["density_gap"]["value"] > _limits()["density_gap"], res["checks"]


@pytest.mark.parametrize("moved, reads", [
    ({}, 50.0),
    ({"c2r_y": 1}, None),
    ({"zx_dft": 5}, None),
    ({"halfspace_boxmuller": 0, "zx_dft": 0, "y_dft": 0, "plt_coefs": 0}, None),
], ids=["whole", "another_route", "counts_off", "nothing"])
def test_fullgrid_roofline_reads_whole_realizations(moved, reads):
    """The reader's bound of two realizations over twice that time reads
    50%, and nothing where the counters are not two whole realizations."""
    from types import SimpleNamespace

    reader = run.load_file(BENCH / "metrics" / "fullgrid_roofline.py", "fullgrid_roofline")
    config = run.load_cell(CELL)[2]
    launches = {"halfspace_pack_zx": 0, "c2r_y": 0, "halfspace_boxmuller": 2,
                "zx_dft": 6, "y_dft": 6, "plt_coefs": 2}
    launches.update(moved)
    bound = reader.realization_s(config)
    got = reader.read(SimpleNamespace(launches=launches, config=config,
                               port_kernel_s=lambda: 2 * bound / 0.5))
    assert got == pytest.approx(reads) if reads else got is None
