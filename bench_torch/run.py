"""The benchmark of the PyTorch + CUDA port, one cell once.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in BENCHMARK.json) names a
configuration, ``bench_torch/configs/<config>.json`` (the .par keys, CLI
flags and dtype), and a traffic mix, ``bench_torch/traffic/<mix>.json``
(the kind of request and its parameters, read by ``mixes.py``, which
drives the kind's module ``bench_torch/kinds/<kind>.py``); its limits are
``bench_torch/limits/<cell>.json`` and each per-layer metric is read by
``bench_torch/metrics/<metric>.py``, or where there is none by the reader
of its base name (the part before the first '.'), which serves a
quantity split by cells.  Set-up (process start,
CUDA, the program's kernels and packer, one forward step) comes first;
then the window; then, with the window closed and the program's state
freed, the check against ``reference.py``.  Earlier lines of the output
say where the run wrote and how much; the last line is the result:

    {"correct", "attempted", "failed", "metrics", "device", ["breakdown"], "checks"}

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones from one torch.profiler trace around the window.  Without
a card the run exits 2 and prints no result.
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


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(mix, window_s: float, peak_bytes: int, setup_s: float) -> dict:
    """Every end-to-end quantity the harness takes by its own clock; the
    cell reports those BENCHMARK.json gives it."""
    return {"setup_s": setup_s, "peak_dev_GiB": peak_bytes / GIB,
            **mix.kind.end_to_end(mix, window_s)}


def worst(numbers: dict, new: dict):
    for k, v in new.items():
        numbers[k] = max(numbers.get(k, v), v)


def check(mix, root, device, seed) -> dict:
    """The numbers of the sampled requests (the last and ``check`` - 1
    others drawn from the seed) against the float64 reference, each the
    worst over the sample (computed after the window, the program's state
    freed)."""
    import torch

    import reference

    ok = [r for r in mix.requests if r["ok"]]
    if not ok:
        return {}
    g = torch.Generator().manual_seed(seed)
    want = int(mix.traffic.get("check", 2))
    others = ok[:-1]
    pick = [others[i] for i in torch.randperm(len(others), generator=g)[:want - 1].tolist()]
    numbers: dict = {}
    for r in [ok[-1], *pick]:
        keys = dict(mix.config["par"], ZD_Seed=r["seed"])
        ref = reference.fields(keys, root, dtype=torch.float64, device=device)
        worst(numbers, mix.kind.check(mix, r, ref))
        del ref
        if device == "cuda":
            torch.cuda.empty_cache()
    return numbers


def measure(cell_name: str, seed: int, seconds: float, trace: bool, device: str,
            root: Path = ROOT, run_dir: Path | None = None, t_proc: float = T_PROC,
            resize=None) -> dict:
    """One run of the cell; returns the result object.  ``resize(config)``
    changes the configuration first: the CPU rehearsal's tiny sizes, or
    the control's lower precision (the check stays in float64)."""
    import torch

    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root))
    from mixes import Mix
    from tracing import Run, kernel_names, profiled, warm_profiler

    import checks
    import kernelwork

    bench, cell, config, traffic, limits = load_cell(cell_name)
    if resize is not None:
        resize(config)
    run_dir = run_dir or HERE / "_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    try:
        print(fs_report(run_dir), flush=True)
        mix = Mix(root, run_dir, config, traffic, seed, device)
        mix.warm_up()
        if trace:
            warm_profiler(device)
        from zeldovich_tpu_torch import kernels

        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_proc
        trace_path = run_dir / "trace.json" if trace else None
        if trace:
            with profiled(device, trace_path):
                window_s = mix.run_window(seconds)
        else:
            window_s = mix.run_window(seconds)
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        written = bytes_in(run_dir)
        failed = sum(not r["ok"] for r in mix.requests)
        print(f"window {window_s:.3f} s, {len(mix.requests)} requests "
              f"({failed} failed), {written / 1e9:.3f} GB in files of the run directory", flush=True)
        mix.release()
        if device == "cuda":
            torch.cuda.empty_cache()

        result = {"correct": False, "attempted": len(mix.requests), "failed": failed}
        if trace:
            run = Run(cell, config, traffic, mix.requests, launches,
                      kernelwork.model_for(config), trace_path,
                      kernel_names(root / "zeldovich_tpu_torch"))
            entries, read = bench["per_layer"], lambda m: load_reader(m["name"])(run)
        else:
            vals = end_to_end(mix, window_s, peak, setup_s)
            entries, read = bench["end_to_end"], lambda m: vals.get(m["name"])
        result["metrics"] = {}
        for m in cell_metrics(entries, cell_name):
            v = read(m)
            if v is not None:  # a reader that finds nothing leaves its metric out
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"] = {
            "platform": "gpu" if device == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
            "power_limit": power_limit() if device == "cuda" else None,
        }
        if trace:
            result["device"]["busy_s"] = run.busy_s()
            result["device"]["window_s"] = run.window[1]
            result["breakdown"] = run.breakdown()
        counts = [r for r in mix.requests if r["ok"]]
        print(f"{len(counts)} requests completed; request seconds median "
              f"{statistics.median([r['t1'] - r['t0'] for r in counts]) if counts else 0:.4f}",
              flush=True)
        t_c = time.perf_counter()
        numbers = check(mix, root, device, seed)
        good, shown = checks.verdict(numbers, limits)
        print(f"check took {time.perf_counter() - t_c:.1f} s", flush=True)
        result["correct"] = bool(good and failed == 0)
        result["checks"] = shown
        for name, v in shown.items():
            print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
        return result
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def main(argv=None) -> int:
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

    bench, cell, *_ = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
