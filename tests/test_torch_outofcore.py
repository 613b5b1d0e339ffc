"""The out-of-core streamed run and its kernel B5 against the JAX package.

``zeldovich_tpu_torch`` runs the plain versions of B5 (``boxmuller``), zx
and y on CPU tensors.  References, in the same process:

* ``hermitian_source`` against the JAX function, exactly;
* B5 plain against the Pallas kernel ``boxmuller_pallas`` in interpret
  mode, fed states the JAX package forms from limbs gathered at the same
  random source indices;
* the slab synthesis ``synthesize_pair`` against JAX ``synthesize_pair``
  (the general path, never the JAX identity slab path, which is wrong
  outside the generated half: ROADMAP C1) and against the rows of the
  port's in-core ``kspace_pair``, on slabs in the generated half, holding
  ppd/2, in the mirror half and straddling ppd/2;
* ``OutOfCoreZeldovich`` end to end, over several slabs, against JAX
  in-core ``xspace_pair`` through the same writer (ZD_Version=1 against
  JAX's complex ``xspace()``), with RAM and disk stages;
* a port PART1 stage resumed by JAX ``OutOfCoreZeldovich.run``.

Tolerances: float32 1e-5 of the scale, float64 1e-12; B5 2 ulp of scale
in float32 and 1 ulp in float64 (tests/test_torch_boxmuller.py states
why), with the zero pattern exact.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.models.outofcore import OutOfCoreZeldovich as JOutOfCore
from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
from zeldovich_tpu.ops import modes as jmodes
from zeldovich_tpu.ops import modes_real as jmr
from zeldovich_tpu.ops import pcg_device as jpcg
from zeldovich_tpu.ops.pallas_synth import boxmuller_pallas
from zeldovich_tpu.utils.output import OutputWriter, read_particles
from zeldovich_tpu.utils.params import Parameters
from zeldovich_tpu.utils.streamio import stream_xspace as jstream_xspace
from zeldovich_tpu_torch.cli import main
from zeldovich_tpu_torch.models.outofcore import OutOfCoreZeldovich
from zeldovich_tpu_torch.models.pipeline import Zeldovich
from zeldovich_tpu_torch.ops.boxmuller import boxmuller
from zeldovich_tpu_torch.ops.modes import hermitian_source, tables_from_jax
from zeldovich_tpu_torch.ops.modes_real import synthesize_full_fast_pair, synthesize_pair

torch.set_num_threads(1)

ASSETS = Path(__file__).parent.parent / "zeldovich_tpu" / "assets"
BASE = dict(
    BoxSize=100.0, CPD=8, ICFormat="RVZel", InitialRedshift=49.0,
    ZD_Seed=97531, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
    ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0,
    ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
)
FNL = dict(ZD_f_NL=30.0, ZD_n_s=0.96, Omega_M=0.3)
PLT = dict(
    ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128"),
    ZD_qPLT_rescale=1, ZD_PLT_target_z=5.0,
)
TOL = {"float32": 1e-5, "float64": 1e-12}


def _param(ppd, outdir="/tmp/ic_torch_outofcore", **over):
    return Parameters.from_dict(
        dict(BASE, NP=ppd**3, InitialConditionsDirectory=str(outdir), **over)
    )


def _close(got, want, dtype):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("ppd", [16, 18])
def test_hermitian_source_matches_jax(ppd):
    g = np.meshgrid(*(np.arange(ppd),) * 3, indexing="ij")
    want = jmodes.hermitian_source(*(jnp.asarray(a) for a in g), ppd)
    got = hermitian_source(*(torch.from_numpy(a) for a in g), ppd)
    for gt, w in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w))


@pytest.mark.parametrize("fixed_power", [False, True], ids=["drawn", "fixed"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_b5_plain_matches_pallas_interpret(fixed_power, dtype):
    ppd, shape = 16, (4, 16, 16)
    j = jmodes.SynthTables.build(13579, ppd, np.zeros(3 * (ppd // 2) ** 2 + 1))
    N = lambda tup: tuple(np.asarray(a) for a in tup)
    port, _, _ = tables_from_jax(
        N(j.planes), N(j.mz), N(j.cz), N(j.mx), N(j.cx), N(j.mzx), N(j.czx),
        np.asarray(j.pk_n2), device="cpu"
    )
    rng = np.random.default_rng(5 + fixed_power)
    sy = rng.integers(0, ppd // 2, shape).astype(np.int32)
    sz, sx = (rng.integers(0, ppd, shape).astype(np.int32) for _ in range(2))
    pk = rng.uniform(0.0, 3.0, shape).astype(dtype)
    live = (rng.random(shape) > 0.2).astype(dtype)

    gather = jpcg.gather
    state = jpcg.madd128(gather(j.mzx, (sz, sx)), gather(j.planes, sy),
                         gather(j.czx, (sz, sx)))
    want = boxmuller_pallas(state, jnp.asarray(pk), jnp.asarray(live),
                            fixed_power=fixed_power, interpret=True)
    T = torch.from_numpy
    got = boxmuller(port, T(sy), T(sz), T(sx), T(pk), T(live), fixed_power)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g == 0, w == 0)
        ulps = 1 if dtype == "float64" else 2
        eps = np.finfo(dtype).eps
        np.testing.assert_allclose(g, w, rtol=0, atol=ulps * eps * np.abs(w).max())


def test_b5_has_no_plain_route_off_the_cpu():
    m = Zeldovich(_param(16), dtype=torch.float32, device="cpu")
    i = torch.zeros((4, 16, 16), dtype=torch.int32, device="meta")
    f = torch.empty((4, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        boxmuller(m.tables, i, i, i, f, f, False)


# (y0, ny): the generated half, rows 4-7, the slab holding ppd/2, the
# mirror half, and a slab straddling ppd/2
SLABS = [(0, 4), (4, 4), (8, 4), (12, 4), (6, 4)]
SYNTH = {
    "plain": ({}, {}),
    "plt": (PLT, {}),
    "fnl_gen_phi": (FNL, dict(gen_phi=True)),
    "fnl_phi_pair": (dict(FNL, **PLT), dict(phi=True)),
    "v1": (dict(ZD_Version=1), {}),
}


def _phi_blocks(phi, y0, ny, lib):
    """((same_re, same_im), (refl_re, refl_im)) of a (2, Y, Z, X) phi."""
    n = phi.shape[-1]
    ys = np.arange(y0, y0 + ny)
    r = (-np.arange(n)) % n
    refl = phi[:, (n - ys) % n][:, :, r][:, :, :, r]
    same = phi[:, y0:y0 + ny]
    return tuple((lib(a[0].copy()), lib(a[1].copy())) for a in (same, refl))


@pytest.mark.parametrize("case", list(SYNTH))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_synthesize_pair_slabs_match_jax_and_in_core(case, dtype):
    """The C1 test: every slab, mirror-half and straddling ones included."""
    over, kind = SYNTH[case]
    p = _param(16, **over)
    m = Zeldovich(p, dtype=getattr(torch, dtype), device="cpu")
    jm = JZeldovich(p, dtype=getattr(jnp, dtype))
    phi = None
    if kind.get("phi"):  # any phi(k): the input pass is linear in it
        phi = np.random.default_rng(8).normal(size=(2, 16, 16, 16)).astype(dtype)
        rows = synthesize_full_fast_pair(
            m.cfg, m.tables, m.dtype, phi_pair=torch.from_numpy(phi),
            plt_coefs=m.plt_coefs).numpy()
    elif kind.get("gen_phi"):
        rows = synthesize_full_fast_pair(
            m.cfg, m.tables, m.dtype, gen_phi=True, pk_eff=m.pk_eff).numpy()
    else:
        rows = m.kspace_pair().numpy()
    if case == "v1":  # the JAX pair path has no v1 field (C6): its complex grid
        k = np.asarray(jm.kspace())
        jrows = np.stack([k.real, k.imag], axis=1)
    for y0, ny in SLABS:
        kw = {}
        if case == "v1":
            kw["D_source"] = m._D_source
        if kind.get("gen_phi"):
            kw["gen_phi"] = True
        if phi is not None:
            kw["phi_pair"] = _phi_blocks(phi, y0, ny, torch.from_numpy)
        got = synthesize_pair(y0, ny, m.cfg, m.tables, m.dtype, **kw).numpy()
        _close(got, rows[:, :, y0:y0 + ny], dtype)
        if case == "v1":
            _close(got, jrows[:, :, y0:y0 + ny], dtype)
            continue
        y = (y0 + jnp.arange(ny))[:, None, None]
        z = jnp.arange(16)[None, :, None]
        x = jnp.arange(16)[None, None, :]
        jkw = dict(gen_phi=kind.get("gen_phi", False))
        if phi is not None:
            jkw["phi_pair"] = _phi_blocks(phi, y0, ny, jnp.asarray)
        want = np.asarray(jmr.synthesize_pair(
            y, z, x, jm.cfg, jm.tables, dtype=getattr(jnp, dtype), **jkw))
        np.testing.assert_array_equal(got == 0, want == 0)
        _close(got, want, dtype)


def _compare_outputs(got_dir, want_dir):
    """Every file of want_dir: ic_* particle by particle, the density
    file as float32; indices exact, values to 1e-5 of the scale."""
    names = sorted(f.name for f in want_dir.iterdir() if not f.name.endswith(".mm"))
    assert names and names == sorted(
        f.name for f in got_dir.iterdir() if not f.name.endswith(".mm"))
    for name in names:
        if name.startswith("ic_"):
            want = read_particles(want_dir / name, "RVZel")
            got = read_particles(got_dir / name, "RVZel")
            for f in ("i", "j", "k"):
                np.testing.assert_array_equal(got[f], want[f])
            fields = [(got[f], want[f]) for f in ("displ", "vel")]
        else:
            fields = [(np.fromfile(got_dir / name, np.float32),
                       np.fromfile(want_dir / name, np.float32))]
        for g, w in fields:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def _jax_in_core(p, v1=False):
    """JAX in-core x space (the pair path; v1 its complex path) through
    the JAX package's writer."""
    jm = JZeldovich(p, dtype=jnp.float32)
    x = jm.xspace() if v1 else jm.xspace_pair()
    p.output_path.mkdir(parents=True, exist_ok=True)
    jstream_xspace(x, OutputWriter(p), pair=not v1)


OOC = {
    "plain": {},
    "plt": PLT,
    "fnl": FNL,
    "fnl_plt": dict(FNL, **PLT),
    "corner_kcut2": dict(ZD_CornerModes=1, ZD_k_cutoff=2.0),
    "qonemode": dict(ZD_qonemode=1, ZD_one_mode=[1, 2, 3]),
    "pk_smooth": dict(ZD_Pk_smooth=2.0),
    "fixed_power": dict(ZD_qPk_fix_to_mean=1),
    "density_only": dict(ZD_qdensity=2),
    "v1": dict(ZD_Version=1),
}


@pytest.mark.parametrize("case", list(OOC))
def test_out_of_core_run_matches_jax_in_core(tmp_path, case):
    ppd = 16
    _jax_in_core(_param(ppd, tmp_path / "jax", **OOC[case]), v1=case == "v1")
    p = _param(ppd, tmp_path / "ooc", **OOC[case])
    row = ppd * ppd * p.narray * 8
    m = OutOfCoreZeldovich(p, dtype=torch.float32, slab_bytes=4 * row, device="cpu")
    assert m.slab == 4  # four y-slabs: generated half, ppd/2, mirror half
    m.run()
    _compare_outputs(tmp_path / "ooc", tmp_path / "jax")


@pytest.mark.parametrize("case", ["plain", "fnl"])
def test_out_of_core_disk_stage_is_removed(tmp_path, case):
    ppd = 16
    _jax_in_core(_param(ppd, tmp_path / "jax", **OOC[case]))
    p = _param(ppd, tmp_path / "ooc", **OOC[case])
    m = OutOfCoreZeldovich(p, dtype=torch.float32, slab_bytes=ppd * ppd * p.narray * 8 * 8,
                           backing="disk", device="cpu")
    assert m.slab == 8
    m.run()
    for name in ("zeldovich.stage.mm", "zeldovich.phi.mm"):
        assert not (tmp_path / "ooc" / name).exists()
    _compare_outputs(tmp_path / "ooc", tmp_path / "jax")


def _write_par(path, ppd, outdir, **over):
    d = dict(BASE, NP=ppd**3, InitialConditionsDirectory=str(outdir), **over)
    path.write_text("".join(
        f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
        for k, v in d.items()
    ))
    return path


def test_port_part1_stage_resumes_under_jax(tmp_path):
    """The stage layout is the JAX package's: its pass 2 (no identity
    path there) resumes the port's PART1 memmap."""
    ppd, over = 16, dict(FNL, **PLT)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    par = _write_par(tmp_path / "p.par", ppd, port_dir, **over)
    flags = ["--device", "cpu", "--out-of-core", "--slab-mb", "1", "--dtype", "float32"]
    assert main([str(par), *flags, "--part", "1"]) == 0
    stage_path = port_dir / "zeldovich.kspace.mm"
    assert stage_path.exists()

    jm = JOutOfCore(_param(ppd, jax_dir, **over), dtype=jnp.float32, pair=True)
    jm.run(stage=jm.stage_memmap(stage_path, "r"))
    assert main([str(par), *flags, "--part", "2"]) == 0
    assert not stage_path.exists()
    _compare_outputs(port_dir, jax_dir)
