"""The benchmark of the PyTorch + CUDA port, one cell once.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in BENCHMARK.json) names a
configuration, ``bench_torch/configs/<config>.json`` (the .par keys, CLI
flags, dtype and, under ``"reference"``, the module of this directory
whose ``fields`` the check holds the run against: ``reference`` where it
names none), and a traffic mix, ``bench_torch/traffic/<mix>.json`` (the
kind of request and its parameters, read by ``mixes.py``, which drives
the kind's module ``bench_torch/kinds/<kind>.py``); its limits are
``bench_torch/limits/<cell>.json`` and each per-layer metric is read by
``bench_torch/metrics/<metric>.py``, or where there is none by the reader
of its base name (the part before the first '.'), which serves a
quantity split by cells.  Set-up (process start, CUDA, the program's
kernels and packer, one forward step) comes first; then the window; then,
with the window closed and the program's state freed, the check.

A cell of one chip runs in this process.  A cell of N > 1 chips runs as N
ranks in lockstep (``lockstep.py``), this process rank 0 on ``cuda:0``;
its traffic's kind must be collective.  Rank 0's clock gives ``setup_s``
and the window, ``peak_dev_GiB`` is the largest over the ranks, the
launch counters and the trace are rank 0's, and each rank checks the part
of the output it holds.  Earlier lines of the output say where the run
wrote and how much; the last line is the result, rank 0's:

    {"correct", "attempted", "failed", "metrics", "device", ["breakdown"], "checks"}

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones from one torch.profiler trace around the window.  Without
the cards the cell asks for the run exits 2 and prints no result; where
JAX or the JAX package is loaded once the window has closed, in this
process or in another rank's, it exits 1 and prints none, and so does a
lockstep run one of whose ranks raises or exits.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GIB = float(1 << 30)


def process_start() -> float:
    """This process's start on the perf_counter clock (Linux /proc)."""
    ticks = os.sysconf("SC_CLK_TCK")
    started = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return time.perf_counter() - (uptime - started)


T_PROC = process_start()


def load_cell(name: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return bench, cell, config, traffic, limits


def cell_metrics(entries, cell_name: str, reported=None):
    """The metric entries that apply to the cell: those listing it, or
    without a list those moving a metric the cell reports."""
    out = []
    for m in entries:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def fs_report(path: Path) -> str:
    """The file system that holds ``path``: its type, free space, and the
    host's RAM."""
    best, fstype = "", "?"
    for line in Path("/proc/mounts").read_text().splitlines():
        parts = line.split()
        if len(parts) > 2 and str(path).startswith(parts[1]) and len(parts[1]) > len(best):
            best, fstype = parts[1], parts[2]
    st = os.statvfs(path)
    mem = Path("/proc/meminfo").read_text().split("\n")[0].split()[1]
    return (f"output directory {path}: {fstype} at {best}, "
            f"{st.f_bavail * st.f_frsize / 1e9:.1f} GB free; host RAM {int(mem) / 1e6:.1f} GB")


def bytes_in(path: Path) -> int:
    """Bytes of the files under ``path``: the ic_* files the window's jobs wrote."""
    return sum(p.stat().st_size for p in path.glob("job*/*") if p.is_file())


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def load_file(path: Path, name: str):
    """The module of the file ``path``, as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return load_file(path, f"metric_{name}").read


def end_to_end(mix, window_s: float, peak_bytes: int, setup_s: float) -> dict:
    """Every end-to-end quantity the harness takes by its own clock; the
    cell reports those BENCHMARK.json gives it."""
    return {"setup_s": setup_s, "peak_dev_GiB": peak_bytes / GIB,
            **mix.kind.end_to_end(mix, window_s)}


def worst(numbers: dict, new: dict):
    for k, v in new.items():
        numbers[k] = max(numbers.get(k, v), v)


def load_reference(name: str):
    """The reference module ``name``: a file ``<name>.py`` of this
    directory, by its bare name, and nothing on the import path."""
    path = HERE / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise SystemExit(f"the configuration names the reference {name!r}; a reference "
                         f"is a module file of {HERE.name}/, named without its .py")
    return load_file(path, f"reference_{name}")


def check(mix, root, device, seed) -> dict:
    """The numbers of the sampled requests (the last and ``check`` - 1
    others drawn from the seed) against the float64 fields of the
    reference module the configuration names, taken one at a time, each
    number the worst over the sample (computed after the window, the
    program's state freed; in lockstep on every rank, each checking its
    part)."""
    import resource

    import torch

    reference = load_reference(mix.config.get("reference", "reference"))
    ok = [r for r in mix.requests if r["ok"]]
    if not ok:
        return {}
    t_c = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if device == "cuda" else 0
    g = torch.Generator().manual_seed(seed)
    want = int(mix.traffic.get("check", 2))
    others = ok[:-1]
    pick = [others[i] for i in torch.randperm(len(others), generator=g)[:want - 1].tolist()]
    numbers: dict = {}
    for r in [ok[-1], *pick]:
        keys = dict(mix.config["par"], ZD_Seed=r["seed"])
        fields = reference.fields(keys, root, dtype=torch.float64, device=device)
        worst(numbers, mix.kind.check(mix, r, fields))
        del fields
        if device == "cuda":
            torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024  # Linux: KiB
    rank = f" on rank {mix.mesh.rank}" if mix.mesh is not None else ""
    sys.stderr.write(f"check took {time.perf_counter() - t_c:.1f} s{rank}, device peak "
                     f"{peak / GIB:.2f} GiB ({held / GIB:.2f} of it held before the "
                     f"check), host peak RSS {rss / GIB:.2f} GiB\n")
    sys.stderr.flush()
    return numbers


def device_info(cell, device: str, peak: int) -> dict:
    import torch

    return {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak),
        "power_limit": power_limit() if device == "cuda" else None,
    }


def measure(cell_name: str, seed: int, seconds: float, trace: bool, device: str,
            root: Path = ROOT, run_dir: Path | None = None, t_proc: float = T_PROC,
            resize=None, spec=None, launch=None) -> dict | None:
    """One run of the cell; returns the result object (rank 0's), or None
    where another rank holds JAX or the JAX package.

    ``resize(config)`` changes the configuration first: the CPU
    rehearsal's tiny sizes, or the control's lower precision (the check
    stays in float64).  ``spec``, the tuple ``load_cell`` gives, stands
    for the cell's files (a test's own cell).  In lockstep
    ``launch(spec_path, rank)`` gives a follower's command
    (``lockstep.child_argv``).  Rank 0 takes its part of every
    collective (the peaks, the check, the look for JAX) before the work
    that only it does: writing and reading the trace, the result."""
    import torch

    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root))
    from mixes import Mix
    from tracing import Run, kernel_names, profiled, warm_profiler

    import checks
    import kernelwork
    import lockstep

    bench, cell, config, traffic, limits = spec or load_cell(cell_name)
    if resize is not None:
        resize(config)
    chips = int(cell["chips"])
    run_dir = run_dir or HERE / "_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    ranks = None
    try:
        print(fs_report(run_dir), flush=True)
        mix = Mix(root, run_dir, config, traffic, seed, device)
        if getattr(mix.kind, "COLLECTIVE", False):
            ranks = lockstep.Ranks(
                {"cell": cell, "config": config, "traffic": traffic, "seed": seed,
                 "seconds": seconds, "device": device, "root": str(root),
                 "run_dir": str(run_dir), "world": chips, "store": str(run_dir / "store")},
                run_dir, launch)
            mix.mesh = ranks.mesh
        elif chips > 1:
            raise SystemExit(f"{cell['name']} asks for {chips} chips, but the kind of its "
                             f"traffic, {traffic['kind']!r}, runs on one rank (it sets no "
                             "COLLECTIVE = True)")
        mix.warm_up()
        if ranks is not None:
            ranks.mesh.barrier()
        if trace:
            warm_profiler(device)
        from zeldovich_tpu_torch import kernels

        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_proc
        prof = None
        if trace:
            with profiled(device) as prof:
                window_s = mix.run_window(seconds)
        else:
            window_s = mix.run_window(seconds)
        launches = dict(kernels.launches, plt_coefs=kernels.plt_launches)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        if ranks is not None:
            peak = lockstep.max_over(ranks.mesh, peak)
        written = bytes_in(run_dir)
        failed = sum(not r["ok"] for r in mix.requests)
        print(f"window {window_s:.3f} s, {len(mix.requests)} requests "
              f"({failed} failed), {written / 1e9:.3f} GB in files of the run directory", flush=True)
        mix.release()
        if device == "cuda":
            torch.cuda.empty_cache()
        numbers = check(mix, root, device, seed)
        if ranks is not None:
            if lockstep.max_over(ranks.mesh, 0):
                print("another rank holds JAX or the JAX package once the window has "
                      "closed; the benchmark imports no JAX", file=sys.stderr)
                return None
            ranks.close()
        good, shown = checks.verdict(numbers, limits)

        result = {"correct": bool(good and failed == 0), "attempted": len(mix.requests),
                  "failed": failed}
        if trace:
            trace_path = run_dir / "trace.json"
            prof.export_chrome_trace(str(trace_path))
            run = Run(cell, config, traffic, mix.requests, launches,
                      kernelwork.model_for(config, root, chips), trace_path,
                      kernel_names(root / "zeldovich_tpu_torch"))
            entries, read = bench["per_layer"], lambda m: load_reader(m["name"])(run)
        else:
            vals = end_to_end(mix, window_s, peak, setup_s)
            entries, read = bench["end_to_end"], lambda m: vals.get(m["name"])
        result["metrics"] = {}
        for m in cell_metrics(entries, cell["name"]):
            v = read(m)
            if v is not None:  # a reader that finds nothing leaves its metric out
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"] = device_info(cell, device, peak)
        if trace:
            result["device"]["busy_s"] = run.busy_s()
            result["device"]["window_s"] = run.window[1]
            result["breakdown"] = run.breakdown()
        counts = [r for r in mix.requests if r["ok"]]
        print(f"{len(counts)} requests completed; request seconds median "
              f"{statistics.median([r['t1'] - r['t0'] for r in counts]) if counts else 0:.4f}",
              flush=True)
        result["checks"] = shown
        for name, v in shown.items():
            print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
        return result
    finally:
        if ranks is not None:
            ranks.close(wait=False)
        shutil.rmtree(run_dir, ignore_errors=True)


def main(argv=None, device: str = "cuda", **given) -> int:
    """The command line.  ``device`` and ``given`` (``resize``, ``spec``,
    ``launch``, as ``measure`` takes them) let the tests drive it on the
    CPU, past the look for the cards."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's caches stay inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(HERE / "_cache" / sub))
    import torch

    from lockstep import jax_held

    cell = (given.get("spec") or load_cell(args.workload))[1]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device == "cuda" and found < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace), device,
                     **given)
    held = jax_held()
    if held:
        print(f"the run's process holds {', '.join(held)} once the window has closed; "
              "the benchmark imports no JAX", file=sys.stderr)
    if result is None or held:
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
