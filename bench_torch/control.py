"""The control of ``correct``, which every cell's check has to refuse, and
the sound readings its limits are set from.

    python3 bench_torch/control.py --workload <cell> --seeds S1 S2 S3
        [--sound-seeds S4 ...] [--seconds 3]

The control is the nearest precision below the configuration's stated
float64, for which the port has a path of its own, ``--dtype float32``
(the CLI's) and ``Zeldovich(dtype=torch.float32)`` (the model API's):
each seed runs the cell with its dtype set to float32, checked against
the float64 reference.  Each seed prints the numbers compared and whether
it came out correct (it must not).  ``--sound-seeds`` first runs the cell
as it stands on those seeds in the same process, for the sound readings.
Runs on the card at the cell's own size; ``test_bench.py`` runs the same
at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402


def lower(config):
    config["dtype"] = "float32"


def control(cell_name: str, seed: int, seconds: float, device: str, root=run.ROOT,
            resize=None, run_dir=None, spec=None) -> dict:
    """The control's result for one seed (``spec``: as ``run.measure``)."""
    def both(config):
        if resize is not None:
            resize(config)
        lower(config)
    return run.measure(cell_name, seed, seconds, False, device, root, run_dir, resize=both,
                       spec=spec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sound-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.sound_seeds:
        res = run.measure(args.workload, seed, args.seconds, False, args.device)
        nums = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"sound": args.workload, "seed": seed, "correct": res["correct"],
                          "numbers": nums}), flush=True)
    refused = 0
    for seed in args.seeds:
        res = control(args.workload, seed, args.seconds, args.device)
        nums = {k: v["value"] for k, v in res["checks"].items()}
        refused += not res["correct"]
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": res["correct"], "numbers": nums}), flush=True)
    print(f"control refused in {refused} of {len(args.seeds)} seeds")
    return 0 if refused == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
