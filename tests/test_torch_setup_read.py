"""The PLT eigenmode table read on a worker thread
(``ops/plt.py::TableRead``, started in ``Zeldovich.__init__``) on the CPU:
the model's table is the file's bits and its outputs those of a model
built on a table read beside it; a bad file fails ``Zeldovich(param)``
with ``load_eigmodes``'s error; the worker has ended whenever the model
is made or fails, and a model without PLT starts none."""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_profile import _write_par
from zeldovich_tpu_torch.models import pipeline
from zeldovich_tpu_torch.models.pipeline import Zeldovich
from zeldovich_tpu_torch.ops import plt as plt_ops
from zeldovich_tpu_torch.ops.modes import SynthTables
from zeldovich_tpu_torch.ops.modes_real import pk_effective
from zeldovich_tpu_torch.utils.params import Parameters

torch.set_num_threads(1)

EIG = Path(__file__).parent.parent / "zeldovich_tpu" / "assets" / "eigmodes128"


def _model(tmp_path, ppd=16, **over):
    par = _write_par(tmp_path / "a.par", tmp_path / "a", NP=ppd**3, **{"ZD_qPLT": 1, **over})
    return Zeldovich(Parameters.from_file(par), device="cpu")


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float64).view(np.int64)


def test_read_is_the_file_bytes():
    """``read_eigmodes`` and ``load_eigmodes`` give the shipped table's
    ``<f8`` payload bit for bit, in the reference's shape."""
    raw = EIG.read_bytes()
    want = np.frombuffer(raw[4:], dtype="<f8").reshape(128, 128, 65, 4)
    got = plt_ops.read_eigmodes(EIG)
    assert got.dtype == torch.float64 and got.is_contiguous()
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(plt_ops.load_eigmodes(EIG)), _bits(want))


@pytest.mark.parametrize("ppd", [16, 64])
def test_model_table_is_the_file(tmp_path, ppd):
    m = _model(tmp_path, ppd)
    want = np.frombuffer(EIG.read_bytes()[4:], dtype="<f8").reshape(128, 128, 65, 4)
    assert m.tables.eig.dtype == torch.float64
    np.testing.assert_array_equal(_bits(m.tables.eig.numpy()), _bits(want))


@pytest.mark.parametrize("field", ["pk_effective", "xspace_half_pair"])
@pytest.mark.parametrize("ppd", [16, 64])
def test_outputs_equal_a_synchronous_table(tmp_path, ppd, field):
    """The model, and the same model with its tables rebuilt on a table
    read by ``load_eigmodes`` on this thread, give the same bits."""
    threaded, plain = _model(tmp_path, ppd), _model(tmp_path, ppd)
    plain.tables = SynthTables.build(plain.param.seed, ppd, plain.tables.pk_n2.numpy(),
                                     eig=plt_ops.load_eigmodes(EIG), device="cpu")
    if field == "pk_effective":
        got, want = (pk_effective(m.cfg, m.tables, m.dtype) for m in (threaded, plain))
    else:
        got, want = (m.xspace_half_pair() for m in (threaded, plain))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


@pytest.mark.parametrize("bad", ["truncated", "missing"])
def test_bad_file_fails_the_model_with_the_read_error(tmp_path, bad):
    """A truncated table fails ``Zeldovich(param)`` with ``load_eigmodes``'s
    ValueError, to the character; a missing one with its FileNotFoundError;
    the worker has ended either way."""
    path = tmp_path / "eig"
    if bad == "truncated":
        path.write_bytes(EIG.read_bytes()[: 1 << 20])
    with pytest.raises((ValueError, FileNotFoundError)) as want:
        plt_ops.load_eigmodes(path)
    before = threading.active_count()
    with pytest.raises(want.type) as got:
        _model(tmp_path, ZD_PLT_filename=str(path))
    assert str(got.value) == str(want.value)
    if bad == "truncated":
        assert str(got.value) == (f"eigenmode file {path}: size {1 << 20} != expected "
                                  f"34078724 for ppd 128")
    assert threading.active_count() == before


def test_failure_before_the_join_still_joins_the_worker(tmp_path, monkeypatch):
    """P(k) raising while the worker still reads: ``Zeldovich(param)``
    raises P(k)'s error and returns only after the worker has ended."""
    read = plt_ops.read_eigmodes
    ended = []

    def slow_read(path, pin=False):
        time.sleep(0.3)
        table = read(path, pin)
        ended.append(True)
        return table

    def failing_power(param):
        raise RuntimeError("Romberg precision")

    monkeypatch.setattr(plt_ops, "read_eigmodes", slow_read)
    monkeypatch.setattr(pipeline, "PowerSpectrum", failing_power)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="Romberg precision"):
        _model(tmp_path)
    assert ended == [True]
    assert threading.active_count() == before


@pytest.mark.parametrize("plt", [1, 0], ids=["plt", "plain"])
def test_model_starts_a_worker_only_with_plt(tmp_path, monkeypatch, plt):
    """One thread started for a PLT model and ended when it is made; none
    for a model without PLT."""
    started = []
    start = threading.Thread.start

    def noted_start(self):
        started.append(self.name)
        start(self)

    monkeypatch.setattr(threading.Thread, "start", noted_start)
    before = threading.active_count()
    _model(tmp_path, ZD_qPLT=plt)
    assert started == (["zt-eigmodes"] if plt else [])
    assert threading.active_count() == before
