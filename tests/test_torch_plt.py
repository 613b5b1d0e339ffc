"""The PLT coefficient kernel (csrc/plt.cu) on the CPU: its index map and
its wrapper's refusals.

The kernel runs only on a card (chip_smoke.py's phase 15 holds it against
the plain version there).  Here ``tests/torch_plt_model.py``, the kernel's
blocks and staging as torch ops in the kernel's order, is held bit for bit
against ``plt_coef_fields_plain`` on the shipped 128 table: the direct
gather at ppd 16 and 32, the interpolation at 24 and 48, on all planes and
on a subset, in float32 and float64.  The plain version itself is held
against the JAX package by tests/test_torch_synth.py::test_plt_coef_fields.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zeldovich_tpu_torch import kernels
from zeldovich_tpu_torch.ops import modes_real
from zeldovich_tpu_torch.ops.modes import SynthConfig
from zeldovich_tpu_torch.ops.plt import load_eigmodes
from zeldovich_tpu_torch.utils.params import Parameters
from torch_plt_model import THREADS, plt_model

torch.set_num_threads(1)

ASSETS = Path(__file__).parent.parent / "zeldovich_tpu" / "assets"


def _cfg(ppd, rescale):
    keys = dict(
        BoxSize=100.0, NP=ppd**3, CPD=100, ICFormat="RVZel",
        InitialConditionsDirectory="/tmp/ic_torch_plt", InitialRedshift=49.0,
        ZD_Seed=97531, ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0,
        ZD_Pk_sigma=0.02, ZD_Pk_smooth=0.0,
        ZD_Pk_filename=str(ASSETS / "wmap1new.pow"), ZD_Version=2,
        ZD_qPLT=1, ZD_PLT_filename=str(ASSETS / "eigmodes128"),
        ZD_qPLT_rescale=rescale, ZD_PLT_target_z=5.0,
    )
    return SynthConfig.from_params(Parameters.from_dict(keys), False)


def _table(E):
    """The shipped 128 table, or a seeded E table (eigenvalues in [0, 1)):
    a grid finer than E takes the ix wrap at the last x and, past one tile
    of x, several tiles a row."""
    if E == 128:
        return torch.from_numpy(load_eigmodes(ASSETS / "eigmodes128").copy())
    rng = np.random.default_rng(E)
    t = rng.standard_normal((E, E, E // 2 + 1, 4))
    t[..., 3] = rng.random((E, E, E // 2 + 1))
    return torch.from_numpy(t)


@pytest.mark.parametrize("rescale", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ppd,E,rows", [
    (16, 128, None), (32, 128, None),  # the direct gather
    (24, 128, None), (48, 128, None),  # the interpolation
    (16, 128, (3, 7)), (48, 128, (5, 17)),  # a subset of the planes
    (24, 16, None), (26, 16, None),  # the ix wrap; 8-byte float stores
    (528, 16, (0, 2)), (528, 16, (131, 133)),  # several x tiles a row
])
def test_model_bit_equal_plain(ppd, E, rows, dtype, rescale):
    cfg, dt = _cfg(ppd, rescale), getattr(torch, dtype)
    tables = SimpleNamespace(eig=_table(E), device=torch.device("cpu"))
    want = modes_real.plt_coef_fields_plain(cfg, tables, dt, rows)
    stats = {}
    got = plt_model(cfg, tables.eig, dt, rows, stats)
    assert got.shape == want.shape
    if rescale:
        # pow is the one library function: torch's CPU pow rounds by the
        # element's lane (its vector body and scalar tail differ by an ulp),
        # so the rescaled cx, cy, cz agree to a few ulp, f bit for bit
        np.testing.assert_allclose(got[:3].numpy(), want[:3].numpy(), atol=0,
                                   rtol=4 * torch.finfo(dt).eps)
        np.testing.assert_array_equal(got[3].numpy(), want[3].numpy())
    else:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the CPU entry point is the plain version
    np.testing.assert_array_equal(
        modes_real.plt_coef_fields(cfg, tables, dt, rows).numpy(), want.numpy())
    g = kernels.plt_geometry(ppd, E, dt)
    if not g["step"]:
        # the host's cap is the widest range a tile stages, and the stage
        # reloads only where a row's lower iz moves
        assert stats["widest"] == g["cap"]
        tiles = -(-ppd // (g["threads"] * g["vec"]))
        assert stats["stagings"] <= tiles * ppd
        if ppd > E:  # neighbouring rows share their lower iz
            assert stats["stagings"] < tiles * ppd


def test_geometry_matches_source():
    assert kernels.PLT_THREADS == THREADS
    for n in (2, 6, 16, 24, 48, 200, 512, 576, 1728, 4096):
        for dt in (torch.float32, torch.float64):
            g = kernels.plt_geometry(n, 128, dt)
            assert 32 <= g["threads"] <= THREADS and g["threads"] % 32 == 0
            assert n % g["vec"] == 0 and g["vec"] * (4 if dt == torch.float32 else 8) <= 16
            assert (g["step"] == 0) == (128 % n != 0)


def test_geometry_refuses_table_overrun():
    # ppd 78 on a 10 table in float32: fl(fl(10/78) * 39) is just above 5,
    # so kz = 39 lands at iz 6, past the table's 6 iz entries (the plain
    # lookup indexes outside the table there too)
    with pytest.raises(ValueError, match="outside the table"):
        kernels.plt_geometry(78, 10, torch.float32)
    assert kernels.plt_geometry(78, 10, torch.float64)["cap"] > 0


_E = 8


def _operands(**over):
    eig = over.pop("eig", torch.zeros((_E, _E, _E // 2 + 1, 4), dtype=torch.float64))
    out = over.pop("out", torch.empty((4, 3, 8, 8), dtype=torch.float64))
    return dict(eig=eig, out=out, y0=over.pop("y0", 0), fund=1.0, fund2=1.0,
                f_cluster=1.0, rescale_base=1.0, target_f=1.0, rescale=False)


@pytest.mark.parametrize("case,over,err,match", [
    ("dtype", dict(out=torch.empty((4, 3, 8, 8), dtype=torch.float16)), TypeError,
     "float32 and float64"),
    ("table dtype", dict(eig=torch.zeros((_E, _E, _E // 2 + 1, 4))), ValueError,
     "eigenmode table"),
    ("table shape", dict(eig=torch.zeros((_E, _E, _E, 4), dtype=torch.float64)),
     ValueError, "eigenmode table"),
    ("out shape", dict(out=torch.empty((3, 3, 8, 8), dtype=torch.float64)), ValueError,
     "want out"),
    ("out square", dict(out=torch.empty((4, 3, 8, 6), dtype=torch.float64)), ValueError,
     "want out"),
    ("planes", dict(y0=2), ValueError, "planes"),
    ("odd ppd", dict(out=torch.empty((4, 1, 7, 7), dtype=torch.float64)), ValueError,
     "even ppd"),
    ("contiguity", dict(out=torch.empty((4, 3, 8, 8), dtype=torch.float64)
                        .transpose(2, 3)), ValueError, "contiguous"),
    ("table contiguity", dict(eig=torch.zeros((_E, _E, 4, _E // 2 + 1),
                                              dtype=torch.float64).transpose(2, 3)),
     ValueError, "contiguous"),
    ("device", {}, ValueError, "CUDA device"),
])
def test_wrapper_refuses(case, over, err, match):
    before = kernels.plt_launches
    with pytest.raises(err, match=match):
        kernels.launch_plt_coefs(**_operands(**over))
    assert kernels.plt_launches == before
