"""What the port's spans (utils/timers.py::span) cost, two ways, and
whether ``--profile`` sees the writer thread's.

    python3 scripts/torch_span_variants.py --span-cost [--n 200000]

times, on this host's CPU with no profiler running, one span with and
without a ``timer``, the check it makes (torch's global
``_is_profiler_enabled``) and a bare ``record_function``, in ns each.

    python3 scripts/torch_span_variants.py --workload <cell> --trace 1 \\
        --turns _checkout/parent:all .:all .:phase .:nosync .:nosync .:phase .:all \\
        _checkout/parent:all --seed0 3000000017 --out variants.json

runs the benchmark's cell (bench_torch/run.py's ``measure``, on the card)
once a turn, each in a fresh process and with a seed of its own, from the
tree a turn names and with its variant of the spans:

* ``all``: the tree as it is;
* ``phase``: the spans of ``PhaseTimers`` alone; every other span of the
  port only feeds its ``timer``, as with no profiler running (no range,
  no record);
* ``nosync``: all spans, but ``static.plt_coefs`` does not synchronize
  the card at its close.

A tree without spans (one older than them) takes ``all`` alone.  The
turns' results go to ``--out``, and one line a turn to stdout.
``--rehearse PPD`` runs each turn on the CPU at that size instead, as
bench_torch/rehearse.py does (a check of this script, no measurement).

    python3 scripts/torch_span_variants.py --profile-job DIR [--config demo_ooc]

runs one job of the configuration (bench_torch/configs/<config>.json)
through the CLI with ``--profile DIR`` on the card and counts the trace's
``output.pack`` and ``output.write`` ranges on the phase's thread and on
others (``--device cpu --rehearse 16``: a check of this mode on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

SPAN_MODULES = ("models.pipeline", "models.outofcore", "utils.streamio", "utils.output")


def span_cost(n: int) -> dict:
    """ns a span with no profiler running, and its parts."""
    from torch.autograd import profiler

    from zeldovich_tpu_torch.utils.timers import STimer, span, tracing

    assert not tracing()
    timer = STimer()

    def each(body) -> float:
        t0 = time.perf_counter()
        body()
        return 1e9 * (time.perf_counter() - t0) / n

    def bare():
        for _ in range(n):
            with span("cost"):
                pass

    def timed():
        for _ in range(n):
            with span("cost", timer):
                pass

    def check():
        for _ in range(n):
            profiler._is_profiler_enabled  # noqa: B018 (the read is the cost)

    def loop():
        for _ in range(n):
            pass

    def rf():
        for _ in range(n // 10):
            with profiler.record_function("cost"):
                pass

    empty = each(loop)
    return {"span_ns": each(bare) - empty, "span_with_timer_ns": each(timed) - empty,
            "check_ns": each(check) - empty, "record_function_ns": 10 * each(rf)}


def profile_job(out: Path, config_name: str, device: str, ppd: int) -> dict:
    """One CLI job with --profile: its writer ranges by thread (``ppd``:
    the rehearsal's size, where not 0)."""
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root / "bench_torch")]
    from mixes import par_keys
    from rehearse import shrink

    config = json.loads((root / "bench_torch" / "configs" / f"{config_name}.json").read_text())
    if ppd:
        shrink(ppd)(config)
    out.mkdir(parents=True, exist_ok=True)
    keys = par_keys(root, config, 3_000_000_019, out / "ic")
    par = out / "job.par"
    par.write_text("".join(f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
                           for k, v in keys.items()))
    cmd = [sys.executable, "-m", "zeldovich_tpu_torch", str(par), *config.get("flags", []),
           "--dtype", config["dtype"], "--device", device, "--profile", str(out / "trace")]
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=root).returncode
    wall = time.perf_counter() - t0
    shutil.rmtree(out / "ic", ignore_errors=True)
    (trace,) = (out / "trace").glob("rank0.*.pt.trace.json")
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    main_tids = {e["tid"] for e in events if e["name"] == "Out-of-core streamed run"}
    counts: dict = {}
    for e in events:
        if e["name"] in ("output.pack", "output.write"):
            where = "main" if e["tid"] in main_tids else "other"
            counts[f"{e['name']}.{where}"] = counts.get(f"{e['name']}.{where}", 0) + 1
    return {"rc": rc, "wall_s": wall, "trace_MB": trace.stat().st_size / 1e6, **counts}


def quiet_spans(variant: str):
    """Apply ``variant`` to the imported port."""
    import importlib

    from zeldovich_tpu_torch.utils import timers

    if variant == "all":
        return
    if not hasattr(timers, "span"):
        raise SystemExit(f"variant {variant!r} needs a tree with spans")
    if variant == "phase":
        class quiet(timers.span):
            def __enter__(self):
                self._rec = None
                if self.timer is not None:
                    self._t0 = time.perf_counter()
                return self.counts

        for name in SPAN_MODULES:
            mod = importlib.import_module(f"zeldovich_tpu_torch.{name}")
            mod.span = quiet
    elif variant == "nosync":
        from zeldovich_tpu_torch.models import pipeline

        pipeline.tracing = lambda: False
    else:
        raise SystemExit(f"unknown variant {variant!r}")


def one(tree: Path, variant: str, args) -> dict:
    """One turn in this process: the cell once from ``tree``."""
    sys.path[:0] = [str(tree), str(tree / "bench_torch")]
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(tree / "bench_torch" / "_cache" / sub))
    import rehearse
    import run

    quiet_spans(variant)
    if args.rehearse:
        return run.measure(args.workload, args.seed, args.seconds, bool(args.trace), "cpu",
                           root=tree, resize=rehearse.shrink(args.rehearse))
    return run.measure(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                       root=tree)


def turns(args) -> list[dict]:
    out = []
    for i, turn in enumerate(args.turns):
        tree, variant = turn.rsplit(":", 1)
        seed = args.seed0 + i
        cmd = [sys.executable, __file__, "--one", tree, variant, "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--rehearse", str(args.rehearse)]
        p = subprocess.run(cmd, capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = {"error": p.returncode, "stderr": p.stderr[-2000:]}
        res.update(turn=turn, seed=seed)
        out.append(res)
        shown = {k: round(v["value"], 3) for k, v in res.get("metrics", {}).items()}
        rate = (res["attempted"] / res["device"]["window_s"]
                if res.get("device", {}).get("window_s") else None)
        print(json.dumps({"turn": turn, "correct": res.get("correct"),
                          "requests_per_s": rate, **shown}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--span-cost", action="store_true")
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--one", nargs=2, metavar=("TREE", "VARIANT"))
    ap.add_argument("--turns", nargs="+", metavar="TREE:VARIANT")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seed0", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--rehearse", type=int, default=0, metavar="PPD")
    ap.add_argument("--profile-job", type=Path, metavar="DIR")
    ap.add_argument("--config", default="demo_ooc")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.profile_job:
        print(json.dumps(profile_job(args.profile_job, args.config, args.device, args.rehearse)))
        return 0
    if args.span_cost:
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        print(json.dumps(span_cost(args.n)))
        return 0
    if args.one:
        print(json.dumps(one(Path(args.one[0]).resolve(), args.one[1], args)), flush=True)
        return 0
    results = turns(args)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0 if all(r.get("correct") for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
