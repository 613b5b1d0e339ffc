"""The benchmark harness's CPU cases, and the four-card cell at a tiny size.

``bench_torch/test_bench.py`` holds the harness's own cases (each cell
correct against the reference; the control, the faults and the lockstep
ranks' failures refused), but ``testpaths = ["tests"]`` never collects
that directory: this file imports every one of its ``test_*`` functions,
so they run here as they are.  They share their run directory
(``bench_torch/_run_test``) with each other alone; every case of this
file stays in it, so that ``--dist loadfile`` keeps them on one worker.

The cell ``abacus_base_plt4.sharded_realizations`` itself then runs as
the benchmark runs it, cut to 32^3 (``rehearse.shrink``), as 4 gloo ranks
on the CPU (rank 0 in this process, the others ``lockstep.py`` processes),
each case in a run directory of its own: the sound run correct against
``bench_torch/reference.py`` (plain float64 torch, no JAX), its float32
control and the exchange left out refused.
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent / "bench_torch"
sys.path.insert(0, str(BENCH))

import control  # noqa: E402
import rehearse  # noqa: E402
import run  # noqa: E402
import test_bench  # noqa: E402

globals().update({k: v for k, v in vars(test_bench).items() if k.startswith("test_")})

CELL = "abacus_base_plt4.sharded_realizations"
SEED = 2**31 + 2**30 + 18


def _measure(tmp_path, **given):
    return run.measure(CELL, SEED, 0.3, False, "cpu", run_dir=tmp_path / "run",
                       resize=rehearse.shrink(32), **given)


def test_four_card_cell_is_correct(tmp_path):
    res = _measure(tmp_path)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4 and res["failed"] == 0
    assert set(res["metrics"]) == {"mem_Mpart_s", "peak_dev_GiB", "setup_s"}


def test_four_card_control_is_refused(tmp_path):
    res = control.control(CELL, SEED, 0.3, "cpu", resize=rehearse.shrink(32),
                          run_dir=tmp_path / "run")
    assert not res["correct"], res["checks"]


def test_four_card_cell_refuses_the_exchange_left_out(tmp_path, monkeypatch):
    fault = test_bench._sharded_no_exchange
    fault(monkeypatch)
    res = _measure(tmp_path, launch=test_bench.with_fault(fault))
    assert not res["correct"], res["checks"]
