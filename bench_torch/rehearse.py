"""Rehearse every cell on the CPU at a tiny size, before chip time.

    python3 bench_torch/rehearse.py [--ppd 16] [--seconds 1]

Each cell of BENCHMARK.json runs through ``run.measure`` on the program's
plain CPU route (``--device cpu``), with and without a trace, at ``ppd``
instead of its own size: the paths, arguments, the check against the
reference and the shape of the result line.  It prints the line's keys
and metric names, never their values: a CPU run measures no device.
Then the kernel-work arithmetic of each cell's real shapes is computed
twice and must repeat exactly.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import kernelwork  # noqa: E402
import run  # noqa: E402

KEYS = ("correct", "attempted", "failed", "metrics", "device", "checks")


def shrink(ppd: int):
    def resize(config):
        par = config["par"]
        n = round(int(par["NP"]) ** (1 / 3))
        par["NP"] = ppd ** 3
        par["BoxSize"] = float(par["BoxSize"]) * ppd / n
        par["CPD"] = max(1, int(par["CPD"]) * ppd // n)
        flags = config.get("flags", [])
        if "--slab-mb" in flags:  # keep a few slabs a pass
            flags[flags.index("--slab-mb") + 1] = "1"
    return resize


def work_counts(bench) -> list:
    """(cell, counter, seconds at the bound a launch) of every cell's real
    shapes."""
    out = []
    for cell in bench["workloads"]:
        cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
        out += [(cell["name"], k, v) for k, v in sorted(kernelwork.model_for(cfg).items())]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ppd", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=2**31 + 12345)
    args = ap.parse_args(argv)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bad = 0
    for cell in bench["workloads"]:
        for trace in (False, True):
            res = run.measure(cell["name"], args.seed, args.seconds, trace, "cpu",
                              resize=shrink(args.ppd))
            entries = bench["per_layer"] if trace else bench["end_to_end"]
            want = {m["name"] for m in run.cell_metrics(entries, cell["name"])}
            got = set(res["metrics"])
            # on the CPU the trace's readers find no device to read
            missing = set() if trace else want - got
            ok = (list(res)[:5] == list(KEYS[:5]) and list(res)[-1] == "checks"
                  and res["correct"] and not missing and got <= want)
            bad += not ok
            print(f"{cell['name']} trace={int(trace)}: {'ok' if ok else 'WRONG'}; keys "
                  f"{list(res)}; metrics {sorted(got)}; correct {res['correct']}; "
                  f"attempted {res['attempted']} failed {res['failed']}; checks "
                  f"{sorted(res['checks'])}", flush=True)
    first, second = work_counts(bench), work_counts(bench)
    bad += first != second
    for cell, name, secs in first:
        print(f"work {cell} {name}: {secs:.6e} s at the bound a launch")
    print("rehearsal", "passed" if not bad else f"found {bad} problem(s)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
