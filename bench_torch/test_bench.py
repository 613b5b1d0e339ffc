"""The check that decides ``correct`` refuses the control and the faults.

Run on the CPU at a tiny size: ``python3 -m pytest bench_torch/test_bench.py``.
Each cell's harness runs as on the card, apart from the look for a card,
the size (``rehearse.shrink``) and, in each test, one thing broken
underneath: the control (the program's float32 path, against the stated
float64), a step that returns its state unchanged, half of the output
left out, one answer altered where it is produced, and for the lockstep
kind the exchange between ranks left out, a rank that raises or exits,
and a rank that holds JAX.

The lockstep cases run a cell of their own (``sharded_spec``: the
realizations cell's configuration under the ``sharded_realizations``
kind) as 2 or 4 gloo ranks joined over a ``FileStore``: rank 0 in this
process, the others as ``lockstep.py`` processes; a fault reaches those
through their command (``with_fault``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import checks  # noqa: E402
import control  # noqa: E402
import lockstep  # noqa: E402
import reference  # noqa: E402
import rehearse  # noqa: E402
import run  # noqa: E402

PPD = 32
CELLS = ("abacus_small_plt.realizations", "demo_ooc.jobs")
SEED = 2**31 + 7


def measure(cell, resize=None, seed=SEED, ppd=PPD, **given):
    small = rehearse.shrink(ppd)

    def both(config):
        small(config)
        if resize:
            resize(config)
    return run.measure(cell, seed, 0.3, False, "cpu", run_dir=HERE / "_run_test",
                       resize=both, **given)


@pytest.mark.parametrize("ppd", (PPD, 24))
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, ppd):
    """The reference's fields, one at a time, hold both cells correct, at a
    power of two and at a ppd that is not one (with and without PLT)."""
    assert measure(cell, ppd=ppd)["correct"]


def fields(par, root, **kw):
    """A reference module's ``fields`` that shifts one field: the
    reference that ``test_reference_is_the_configurations`` names."""
    for name, f in reference.fields(par, root, **kw):
        yield name, f + 1e-3 * f.abs().max() if name == "disp_y" else f


@pytest.mark.parametrize("cell", CELLS)
def test_reference_is_the_configurations(cell):
    """The check takes the reference module the configuration names."""
    res = measure(cell, resize=lambda config: config.update(reference="test_bench"))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ("zeldovich_tpu_torch.ops.modes_real", "no_such_module",
                                  "../bench_torch/reference"))
def test_reference_is_a_file_of_the_benchmark(name):
    """A reference named by a dotted path, a path, or a module that is no
    file of the benchmark's directory is refused."""
    with pytest.raises(SystemExit, match="a reference is a module file"):
        measure(CELLS[0], resize=lambda config: config.update(reference=name))


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


# -- lockstep: a cell of several ranks -------------------------------------------
def sharded_spec(world: int):
    """The realizations cell's files, as a cell of ``world`` chips whose
    traffic is ``sharded_realizations`` (``run.load_cell``'s tuple)."""
    bench, cell, config, traffic, limits = run.load_cell(CELLS[0])
    name = f"abacus_small_plt.sharded{world}"
    cell = dict(cell, name=name, traffic="sharded", chips=world)
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELLS[0] in m.get("workloads", []):
            m["workloads"].append(name)
    return bench, cell, config, {"kind": "sharded_realizations", "check": 3}, limits


def with_fault(fault, ranks=None):
    """The followers' command with ``fault`` applied first (on ``ranks``,
    all where None)."""
    def launch(spec_path, rank):
        argv = lockstep.child_argv(spec_path, rank)
        if ranks is not None and rank not in ranks:
            return argv
        code = (f"import sys; sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent)!r}]; "
                f"import pytest, test_bench; test_bench.{fault.__name__}(pytest.MonkeyPatch()); "
                f"import lockstep; lockstep.main({argv[2:]!r})")
        return [sys.executable, "-c", code]
    return launch


@pytest.mark.parametrize("cell", CELLS)
def test_one_chip_cell_starts_no_process(cell, monkeypatch):
    """A cell of one chip runs in this process: no rank is started."""
    def refuse(*args, **kw):
        raise AssertionError("a one-chip cell started ranks")
    monkeypatch.setattr(lockstep, "Ranks", refuse)
    assert measure(cell)["correct"]


def test_one_rank_kind_on_several_chips_is_refused():
    bench, cell, config, traffic, limits = sharded_spec(2)
    with pytest.raises(SystemExit, match="runs on one rank"):
        measure("", spec=(bench, cell, config, {"kind": "realizations"}, limits))


@pytest.mark.parametrize("world", (2, 4))
def test_lockstep_sound_run_is_correct(world):
    res = measure("", spec=sharded_spec(world))
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == world and res["failed"] == 0
    assert set(res["metrics"]) == {"mem_Mpart_s", "peak_dev_GiB", "setup_s"}


@pytest.mark.parametrize("world", (2, 4))
def test_lockstep_control_is_refused(world):
    res = control.control("", SEED, 0.3, "cpu", resize=rehearse.shrink(PPD),
                          run_dir=HERE / "_run_test", spec=sharded_spec(world))
    assert not res["correct"], res["checks"]


def _sharded_unchanged(monkeypatch):
    """B2 returns its input on every rank."""
    from zeldovich_tpu_torch.parallel import pencil_mmfft

    monkeypatch.setattr(pencil_mmfft, "c2r_y", lambda g, n, out=None: g.flatten(1, 2))


def _sharded_half_left_out(monkeypatch):
    """The upper half of every rank's y planes is never produced."""
    from zeldovich_tpu_torch.models.pipeline import Zeldovich

    step = Zeldovich.xspace_half_pair_sharded

    def half_step(self, mesh):
        out = step(self, mesh)
        out[:, :, out.shape[2] // 2:] = 0
        return out
    monkeypatch.setattr(Zeldovich, "xspace_half_pair_sharded", half_step)


def _sharded_no_exchange(monkeypatch):
    """The exchange between ranks left out: each rank's z-slab stays zero."""
    from zeldovich_tpu_torch.parallel import pencil_mmfft

    monkeypatch.setattr(pencil_mmfft, "exchange", lambda x, out, *args: out.zero_())


def _sharded_one_altered(monkeypatch):
    """One answer of every rank's slab altered by a tenth of its scale."""
    from zeldovich_tpu_torch.models.pipeline import Zeldovich

    step = Zeldovich.xspace_half_pair_sharded

    def altered_step(self, mesh):
        out = step(self, mesh)
        out[0, 1, 5, 3, 7] += 0.1 * out[0, 1].abs().max()
        return out
    monkeypatch.setattr(Zeldovich, "xspace_half_pair_sharded", altered_step)


@pytest.mark.parametrize("fault", (_sharded_unchanged, _sharded_half_left_out,
                                   _sharded_no_exchange, _sharded_one_altered))
def test_lockstep_fault_is_refused(fault, monkeypatch):
    fault(monkeypatch)
    res = measure("", spec=sharded_spec(2), launch=with_fault(fault))
    assert not res["correct"], res["checks"]


def _raise_in_second_request(monkeypatch):
    """The step raises on its third call: the window's second request."""
    from zeldovich_tpu_torch.models.pipeline import Zeldovich

    step, calls = Zeldovich.xspace_half_pair_sharded, []

    def raising(self, mesh):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("a rank fails in a request")
        return step(self, mesh)
    monkeypatch.setattr(Zeldovich, "xspace_half_pair_sharded", raising)


def command_line(fault=None, ranks=None, seconds=0.3):
    """The command line of a 2-rank cell at 32^3 on the CPU, in a process
    of its own, with ``fault`` on the followers ``ranks``."""
    launch = (f", launch=test_bench.with_fault(test_bench.{fault.__name__}, ranks={ranks!r})"
              if fault else "")
    code = (f"import sys; sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent)!r}]; "
            "import rehearse, run, test_bench; sys.exit(run.main(['--workload', 'x', "
            f"'--seed', '{SEED}', '--seconds', '{seconds}'], device='cpu', "
            f"resize=rehearse.shrink(32), spec=test_bench.sharded_spec(2){launch}))")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)


def test_rank_that_raises_ends_the_run():
    """Rank 1 raises in the window's second request: the run ends there
    with no result, long before the group's timeout (on gloo rank 0's
    collective raises as rank 1 leaves; else the watcher ends it)."""
    t0 = time.monotonic()
    out = command_line(_raise_in_second_request, {1}, seconds=30.0)
    took = time.monotonic() - t0
    assert out.returncode == 1 and not out.stdout.strip().endswith("}"), out.stdout[-2000:]
    assert "a rank fails in a request" in out.stderr
    assert took < lockstep.GROUP_TIMEOUT.total_seconds() / 4, took


def _holds_jax(monkeypatch):
    """The rank's process holds a module named jax (an empty stand-in)."""
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))


def test_rank_that_holds_jax_ends_with_no_result():
    """A follower that holds JAX once the window has closed: the command
    line exits 1 with no result and says why."""
    out = command_line(_holds_jax, {1})
    assert out.returncode == 1 and not out.stdout.strip().endswith("}"), out.stdout[-2000:]
    assert "rank 1 holds jax" in out.stderr and "another rank holds JAX" in out.stderr


def test_one_result_line_last_on_stdout():
    """The command line of a 2-rank cell prints one result, last on stdout;
    the other rank's output goes to stderr."""
    out = command_line()
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    results = [ln for ln in lines if ln.startswith("{")]
    assert results == [lines[-1]]
    res = json.loads(lines[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert res["correct"] and res["device"]["count"] == 2
    assert "on rank 1" in out.stderr and "on rank 1" not in out.stdout


def _exit_in_set_up(monkeypatch):
    """The rank's process ends before it joins the group."""
    os._exit(3)


def test_rank_that_exits_in_set_up_ends_the_run():
    """A rank gone before the group forms: the command line ends with no
    result, long before the group's timeout."""
    t0 = time.monotonic()
    out = command_line(_exit_in_set_up, {1})
    assert out.returncode == 1 and not out.stdout.strip().endswith("}"), out.stdout[-2000:]
    assert "rank 1 exited with code 3" in out.stderr
    assert time.monotonic() - t0 < lockstep.GROUP_TIMEOUT.total_seconds() / 2


def _tally_rank(rank, world, store, grid, out):
    """One rank's Tally of its z-slab of ``grid``, reduced over the ranks."""
    import torch.distributed as dist

    from zeldovich_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=lockstep.GROUP_TIMEOUT)
    try:
        mesh = make_mesh("cpu", group=dist.group.WORLD)
        zl = grid.shape[2] // world
        tally = checks.Tally()
        for f, (got, ref) in zip(checks.PAIR_SLOTS, grid):
            tally.add(f, got[:, rank * zl:(rank + 1) * zl], ref[:, rank * zl:(rank + 1) * zl])
        flag = tally.reduce(mesh, flag=rank)
        Path(out, f"r{rank}.json").write_text(json.dumps([tally.v, flag]))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", (2, 4))
def test_tally_reduction_is_one_tally(world, tmp_path):
    """The ranks' reduced Tally of their slabs is one Tally of the whole
    grid (integer values, so every sum is exact), on every rank."""
    g = torch.Generator().manual_seed(world)
    grid = torch.randint(-2**20, 2**20, (7, 2, 8, 8, 8), generator=g).to(torch.float64)
    whole = checks.Tally()
    for f, (got, ref) in zip(checks.PAIR_SLOTS, grid):
        whole.add(f, got, ref)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_tally_rank, args=(r, world, str(tmp_path / "store"), grid,
                                                   str(tmp_path))) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert [p.exitcode for p in procs] == [0] * world
    for r in range(world):
        v, flag = json.loads((tmp_path / f"r{r}.json").read_text())
        assert v == {k: list(t) for k, t in whole.v.items()} and flag == world - 1
