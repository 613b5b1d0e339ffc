"""The port's own copies of the JAX package's host modules.

``zeldovich_tpu_torch``, ``scripts/torch_*.py`` and ``chip_smoke.py``
import nothing of ``zeldovich_tpu`` (an AST scan of every source file).  The copies
(parameters, power spectrum, host pcg64 tables, the v1 MT19937 stream,
the ic_* writer with its native packer, the k-space checkpoint helpers)
are held against the originals on the same inputs: equal parameters,
bit-equal tables and v1 draws, identical ic_* bytes, checkpoints that
either side loads.  Exact equality throughout: the copies are the same
code.
"""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import torch

from zeldovich_tpu.ops import pcg as jpcg
from zeldovich_tpu.ops import v1 as jv1
from zeldovich_tpu.utils import checkpoint as jckpt
from zeldovich_tpu.utils import output as joutput
from zeldovich_tpu.utils import params as jparams
from zeldovich_tpu.utils import power as jpower
from zeldovich_tpu.utils.streamio import stream_xspace as jstream_xspace
from zeldovich_tpu_torch import native
from zeldovich_tpu_torch.models.pipeline import Zeldovich
from zeldovich_tpu_torch.ops import pcg, v1
from zeldovich_tpu_torch.utils import checkpoint, output, params, power
from zeldovich_tpu_torch.utils.streamio import stream_xspace

torch.set_num_threads(1)

REPO = Path(__file__).parent.parent
ASSETS = REPO / "zeldovich_tpu" / "assets"
SOURCES = (sorted((REPO / "zeldovich_tpu_torch").rglob("*.py"))
           + sorted((REPO / "scripts").glob("torch_*.py")) + [REPO / "chip_smoke.py"])


def _jax_package_imports(path: Path) -> list:
    """The imports of zeldovich_tpu (not zeldovich_tpu_torch) in a file."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [f"{path.name}:{node.lineno} {n}" for n in names
                  if n.split(".")[0] == "zeldovich_tpu"]
    return found


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_the_jax_package(path):
    assert _jax_package_imports(path) == []


def test_the_scan_sees_a_jax_package_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom zeldovich_tpu.utils import params\n"
                 "import zeldovich_tpu_torch\nfrom . import x\n")
    assert _jax_package_imports(f) == ["m.py:2 zeldovich_tpu.utils"]


def _par(tmp_path, **over):
    d = dict(
        BoxSize=100.0, NP=16**3, CPD=8, ICFormat="RVZel",
        InitialConditionsDirectory=str(tmp_path / "ic"), InitialRedshift=49.0,
        ZD_Seed=4321, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
        ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0,
        ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
    )
    d.update(over)
    path = tmp_path / "p.par"
    path.write_text("".join(f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
                            for k, v in d.items()))
    return path


VARIANTS = {
    "plain": {},
    "plt": dict(ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128")),
    "fnl": dict(ZD_f_NL=30.0, ZD_n_s=0.96, Omega_M=0.3),
    "corner": dict(ZD_CornerModes=1, ZD_k_cutoff=2.0),
    "v1": dict(ZD_Version=1),
}


def _both(par):
    return jparams.Parameters.from_file(par), params.Parameters.from_file(par)


def _fields(p) -> dict:
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)} | {
        "narray": p.narray, "output_path": p.output_path}


def test_parameters_of_example_par_match():
    j, t = _both(REPO / "example.par")
    assert _fields(j) == _fields(t)


@pytest.mark.parametrize("variant", VARIANTS)
def test_parameters_match(tmp_path, variant):
    j, t = _both(_par(tmp_path, **VARIANTS[variant]))
    assert _fields(j) == _fields(t)


@pytest.mark.parametrize("bad", [dict(ZD_Version=3), dict(NP=15**3 + 1)])
def test_parameter_errors_match(tmp_path, bad):
    par = _par(tmp_path, **bad)
    with pytest.raises(jparams.ParameterError) as je:
        jparams.Parameters.from_file(par)
    with pytest.raises(params.ParameterError) as te:
        params.Parameters.from_file(par)
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("variant", ["plain", "fnl"])
def test_power_spectrum_and_tables_bit_equal(tmp_path, variant):
    j, t = _both(_par(tmp_path, **VARIANTS[variant]))
    jpk, tpk = jpower.PowerSpectrum(j), power.PowerSpectrum(t)
    assert jpk.fixed_power == tpk.fixed_power
    k = np.geomspace(1e-3, 5.0, 257)
    np.testing.assert_array_equal(jpk.power_vec(k), tpk.power_vec(k))
    for a, b in zip(jpower.mode_amplitude_tables(jpk, j),
                    power.mode_amplitude_tables(tpk, t)):
        np.testing.assert_array_equal(a, b)


def _small_box(**over) -> dict:
    """The small-box cell's .par keys (bench_torch/configs/abacus_small_plt.json,
    512^3 in 148.1 Mpc/h, wmap1new.pow), its files in the repo's assets."""
    par = json.loads((REPO / "bench_torch/configs/abacus_small_plt.json").read_text())["par"]
    par.update(ZD_Pk_filename=str(ASSETS / "wmap1new.pow"),
               ZD_PLT_filename=str(ASSETS / "eigmodes128"))
    return par | over


#: (the .par keys, f_NL): the small box at its own 512^3, where most n2 lie
#: past the spline's kmax, an f_NL box and a CornerModes box at a small ppd
CELL_SHAPES = {
    "small_box_512": _small_box(),
    "fnl_64": dict(VARIANTS["fnl"], NP=64**3),
    "corner_64": dict(ZD_CornerModes=1, NP=64**3),
}


@pytest.mark.parametrize("case", CELL_SHAPES)
def test_pipeline_tables_bit_equal_at_the_cells_shapes(tmp_path, case):
    """The model's P(k) table (one spline pass) bit for bit the JAX
    package's ``mode_amplitude_tables`` below the k_cutoff sphere's n2
    (the JAX package's ``SynthConfig.n2_cutoff``) and exactly 0.0 from it
    on, where the zero rules zero every mode; whole under f_NL and
    CornerModes, with the M table built from it.  The model carries M only
    under f_NL."""
    from zeldovich_tpu.ops.modes import SynthConfig as JSynthConfig

    j, t = _both(_par(tmp_path, **CELL_SHAPES[case]))
    jpk = jpower.PowerSpectrum(j)
    want_pk, want_M = jpower.mode_amplitude_tables(jpk, j)
    m = Zeldovich(t, device="cpu")
    pk = m.tables.pk_n2.numpy()
    assert pk.dtype == want_pk.dtype and pk.shape == want_pk.shape
    whole = t.f_NL != 0 or t.CornerModes
    n = len(pk) if whole else JSynthConfig.from_params(j, jpk.fixed_power).n2_cutoff
    if case == "small_box_512":
        assert n == 256**2
    np.testing.assert_array_equal(pk[:n], want_pk[:n])
    assert not np.signbit(pk[n:]).any() and not pk[n:].any()
    if whole:
        np.testing.assert_array_equal(power.M_table(m.Pk, t, pk), want_M)
    if t.f_NL != 0:
        np.testing.assert_array_equal(m.tables.M_n2.numpy(), want_M)
    else:
        assert m.tables.M_n2 is None


def _tables_of(m, pk_n2):
    """``m``'s SynthTables rebuilt on the table ``pk_n2``."""
    from zeldovich_tpu_torch.ops.modes import SynthTables

    eig = m.tables.eig.numpy() if m.tables.eig is not None else None
    return SynthTables.build(m.param.seed, m.param.ppd, pk_n2, eig=eig, device="cpu")


@pytest.mark.parametrize("field", ["pk_effective", "xspace_half_pair"])
@pytest.mark.parametrize("plt", [False, True], ids=["plain", "plt"])
def test_trimmed_table_leaves_the_outputs_bit_equal(tmp_path, plt, field):
    """The small box's spacing at 64^3: the model on its own table (0 past
    the k_cutoff sphere) and on the JAX package's whole table give the
    same ``pk_effective`` and the same x-space fields, bit for bit."""
    from zeldovich_tpu_torch.ops.modes_real import pk_effective

    over = _small_box(NP=64**3, BoxSize=148.1 / 8, ZD_qPLT=int(plt))
    j, t = _both(_par(tmp_path, **over))
    want_pk = jpower.mode_amplitude_tables(jpower.PowerSpectrum(j), j)[0]
    trimmed, whole = Zeldovich(t, device="cpu"), Zeldovich(t, device="cpu")
    whole.tables = _tables_of(whole, want_pk)
    assert not np.array_equal(trimmed.tables.pk_n2.numpy(), want_pk)
    if field == "pk_effective":
        got, want = (pk_effective(m.cfg, m.tables, m.dtype) for m in (trimmed, whole))
    else:
        got, want = (m.xspace_half_pair() for m in (trimmed, whole))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("case", ["plain", "fnl", "small_box_512"])
def test_sigma_lines_equal_the_jax_text(tmp_path, capsys, case):
    """PowerSpectrum's stderr ("Input sigma", "Final sigma", the file and
    extrapolation lines) is the JAX package's to the character."""
    over = CELL_SHAPES["small_box_512"] if case == "small_box_512" else VARIANTS[case]
    j, t = _both(_par(tmp_path, **over))
    capsys.readouterr()
    jpower.PowerSpectrum(j)
    want = capsys.readouterr().err
    tpk = power.PowerSpectrum(t)
    assert capsys.readouterr().err == want
    assert "Input sigma(8.000000) = " in want and "Final sigma(8.000000) = " in want
    assert tpk.sigma_integrals == 2


@pytest.mark.parametrize("ppd", [16, 64])
def test_host_pcg_tables_equal(ppd):
    assert pcg.plane_state_table(97, ppd).tolist() == jpcg.plane_state_table(97, ppd).tolist()
    for stride in (2, 2 * pcg.MAX_PPD):
        got, want = pcg.axis_affine_tables(ppd, stride), jpcg.axis_affine_tables(ppd, stride)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tolist() == b.tolist()
        for a, b in zip(pcg.prebump_axis_tables(*got), jpcg.prebump_axis_tables(*want)):
            assert a.tolist() == b.tolist()
    assert pcg.plane_states(5, ppd // 2) == jpcg.plane_states(5, ppd // 2)


@pytest.mark.parametrize("variant", ["v1", "plt"])
def test_v1_stream_bit_equal(tmp_path, variant):
    over = dict(VARIANTS["v1"], **(VARIANTS["plt"] if variant == "plt" else {}))
    j, t = _both(_par(tmp_path, **over))
    jpk, tpk = jpower.PowerSpectrum(j), power.PowerSpectrum(t)
    want = jv1.generate_D_half(j, jpk, jpower.mode_amplitude_tables(jpk, j)[0])
    got = v1.generate_D_half(t, tpk, power.mode_amplitude_tables(tpk, t)[0])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["plain", "plt"])
def test_ic_bytes_of_both_writers_identical(tmp_path, variant):
    """One x-space pair grid through the JAX writer and the port's: the
    same ic_* bytes and the same QA report."""
    over = dict(VARIANTS[variant], NP=16**3)
    j, t = _both(_par(tmp_path, **over))
    t.output_dir = str(tmp_path / "port")
    j.output_dir = str(tmp_path / "jax")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(j.narray, 2, 16, 16, 16)).astype(np.float32)
    for p, setup in ((j, joutput.setup_output_dir), (t, output.setup_output_dir)):
        setup(p)
    jw = jstream_xspace(x, joutput.OutputWriter(j), pair=True)
    tw = stream_xspace(torch.from_numpy(x), output.OutputWriter(t))
    names = sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "port").iterdir())
    assert any(n.startswith("ic_") for n in names)
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()
    jpk, tpk = jpower.PowerSpectrum(j), power.PowerSpectrum(t)
    assert jw.report(jpk) == tw.report(tpk)


def test_native_packer_builds_into_the_port():
    """The port's packer library is its own file under its _build/."""
    from zeldovich_tpu import native as jnative

    lib = native.load()
    assert lib is not None, "g++ could not build the native packer"
    assert native._OUT.parent == REPO / "zeldovich_tpu_torch" / "_build"
    assert native._OUT.exists()
    assert native._OUT.resolve() != Path(jnative._build()).resolve()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_checkpoints_cross_load(tmp_path, dtype):
    """A checkpoint written by either package loads in the other."""
    k = np.random.default_rng(11).normal(size=(2, 2, 16, 8, 8)).astype(dtype)
    checkpoint.save_kspace(torch.from_numpy(k), tmp_path / "port", target_bytes=4096)
    jckpt.save_kspace(k, tmp_path / "jax", target_bytes=4096)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    for d in ("port", "jax"):
        for load in (jckpt.load_kspace, checkpoint.load_kspace):
            got = load(tmp_path / d)
            assert got.dtype == k.dtype
            np.testing.assert_array_equal(got, k)
    checkpoint.remove_kspace(tmp_path / "jax")
    assert not (tmp_path / "jax").exists()
