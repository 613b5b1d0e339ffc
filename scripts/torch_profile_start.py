#!/usr/bin/env python3
"""Whether a card trace started just before its first kernel loses the
card's activity: the evidence for the CLI's ``CUPTI_SETTLE_S``.

    python3 scripts/torch_profile_start.py [--sessions N]

Runs N short torch.profiler traces of the host and the card in this
process, each around one small kernel: half with the kernel right after
the profiler's start, half after the ``CUPTI_SETTLE_S`` wait that
``--profile`` makes on the card.  Counts the traces of each half that hold
no activity of the card, and times the first start (the profiler's first
start in a process, which ``--profile`` pays once a run).  Needs one card;
prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from zeldovich_tpu_torch.cli import CUPTI_SETTLE_S  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=2000,
                    help="short traces, half of them waiting")
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the profiler on the card",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    x = torch.ones(1 << 20, device="cuda")
    (x * 2).sum().item()
    lost, first_start = {"no_wait": 0, "wait": 0}, None
    for i in range(args.sessions):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        t0 = time.perf_counter()
        prof.start()
        if first_start is None:
            first_start = time.perf_counter() - t0
        if i % 2:
            time.sleep(CUPTI_SETTLE_S)
        (x * 2).sum().item()
        prof.stop()
        if not any(e.device_type() == DeviceType.CUDA
                   for e in prof.profiler.kineto_results.events()):
            lost["wait" if i % 2 else "no_wait"] += 1
    print(f"first start {first_start:.3f} s; {args.sessions} short traces without card "
          f"activity: {lost} (no wait / {CUPTI_SETTLE_S} s wait)", flush=True)
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "first_start_s": first_start, "traces_each": args.sessions // 2,
                      "wait_s": CUPTI_SETTLE_S, "without_card_activity": lost}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
