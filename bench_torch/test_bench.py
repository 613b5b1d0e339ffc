"""The check that decides ``correct`` refuses the control and the faults.

Run on the CPU at a tiny size: ``python3 -m pytest bench_torch/test_bench.py``.
Each cell's harness runs as on the card, apart from the look for a card,
the size (``rehearse.shrink``) and, in each test, one thing broken
underneath: the control (the program's float32 path, against the stated
float64), a step that returns its state unchanged, half of the output
left out, one answer altered where it is produced.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import control  # noqa: E402
import rehearse  # noqa: E402
import run  # noqa: E402

PPD = 32
CELLS = ("abacus_small_plt.realizations", "demo_ooc.jobs")


def measure(cell, resize=None, seed=2**31 + 7):
    small = rehearse.shrink(PPD)

    def both(config):
        small(config)
        if resize:
            resize(config)
    return run.measure(cell, seed, 0.3, False, "cpu", run_dir=HERE / "_run_test",
                       resize=both)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert measure(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(cell):
    res = control.control(cell, 2**31 + 7, 0.3, "cpu", resize=rehearse.shrink(PPD),
                          run_dir=HERE / "_run_test")
    assert not res["correct"], res["checks"]


def _unchanged_state(monkeypatch):
    """The last transform returns its input: B2 (c2r along y) in core, the
    y DFT of pass 2 out of core."""
    from zeldovich_tpu_torch.models import outofcore, pipeline

    def c2r_unchanged(g, n, out=None):
        return g.reshape(g.shape[0], 2, n, n, n)

    monkeypatch.setattr(pipeline, "c2r_y", c2r_unchanged)
    monkeypatch.setattr(outofcore, "dft_y", lambda z, sign, out=None: z)


def _half_left_out(monkeypatch):
    """Half of the output never produced: the writer drops every odd
    z-slab; the step's upper half of y planes is left zero."""
    from zeldovich_tpu_torch.models.pipeline import Zeldovich
    from zeldovich_tpu_torch.utils.output import OutputWriter

    write = OutputWriter.write_slab

    def half_written(self, z, slabs):
        if z % 2 == 0:
            write(self, z, slabs)

    step = Zeldovich.xspace_half_pair

    def half_step(self, spm=None):
        out = step(self, spm)
        out[:, :, out.shape[2] // 2:] = 0
        return out

    monkeypatch.setattr(OutputWriter, "write_slab", half_written)
    monkeypatch.setattr(Zeldovich, "xspace_half_pair", half_step)


def _one_altered(monkeypatch):
    """One particle's x displacement altered by a tenth of its scale where
    the output is produced: in the slab handed to the writer, and in the
    step's output."""
    from zeldovich_tpu_torch.models.pipeline import Zeldovich
    from zeldovich_tpu_torch.utils.output import OutputWriter

    write = OutputWriter.write_slab

    def altered(self, z, slabs):
        if z == 3:
            slabs = slabs.copy()
            slabs[0, 5, 7] += 0.1j * abs(slabs[0].imag).max()
        write(self, z, slabs)

    step = Zeldovich.xspace_half_pair

    def altered_step(self, spm=None):
        out = step(self, spm)
        out[0, 1, 5, 3, 7] += 0.1 * out[0, 1].abs().max()
        return out

    monkeypatch.setattr(OutputWriter, "write_slab", altered)
    monkeypatch.setattr(Zeldovich, "xspace_half_pair", altered_step)


@pytest.mark.parametrize("fault", (_unchanged_state, _half_left_out, _one_altered))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_refused(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = measure(cell)
    assert not res["correct"], res["checks"]
