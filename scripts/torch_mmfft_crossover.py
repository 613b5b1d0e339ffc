#!/usr/bin/env python3
"""Dense against four-step: the matrix-product DFTs of
``zeldovich_tpu_torch/ops/mmfft.py`` timed on one GPU.

    python3 scripts/torch_mmfft_crossover.py [--out FILE] [--n 576 1152 ...]

For each length n and element type (float32, float64) it times, on the
operands the route builds (Z = X = n, one chunk of about mmfft._CHUNK
elements each), the dense product (``mmfft._dense``) and the four-step
split (``mmfft._four_step``) of the three axis passes,

* z: zx_mm's z pass, (kc, n, n) with the DFT along the middle axis,
* x: zx_mm's x pass, (kc n, n, 1),
* y: y_mm's pass, (1, n, kc n),

and the c2r along y (``mmfft.c2r_y_pair`` on a (1, 2, 2, n/2 + 1, kc, n)
spectrum, dense and assembled), beside torch.fft on the same complex
shape (the library call); the dense form's rate counts 6 n operations a
complex element (three real products) and 2 (n + 2) a c2r output.  CUDA
events around 3 calls after a warm-up, the median of 3 rounds.  Prints one
line a case, then each type's and length's sums over the passes of a half
step (z, x, c2r) and of a full-grid step (y, z, x) in both forms: what
mmfft.DENSE_MAX is chosen from.  The JSON carries every time, the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N_DEFAULT = (96, 192, 384, 576, 768, 960, 1152, 1536, 1728, 2304)


def _ms(fn, reps=3, rounds=3):
    import torch

    fn()
    out = []
    for _ in range(rounds):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def _case(n: int, dtype, what: str) -> dict:
    import torch

    from zeldovich_tpu_torch.ops import mmfft

    kc = max(1, mmfft._CHUNK // (n * n))
    gen = torch.Generator(device="cuda").manual_seed(n)
    shape = {"z": (kc, n, n), "x": (kc * n, n, 1), "y": (1, n, kc * n)}
    if what == "c2r":
        spm = torch.randn((1, 2, 2, n // 2 + 1, kc, n), device="cuda", dtype=dtype,
                          generator=gen)
        out = torch.empty((1, 2, n, kc, n), device="cuda", dtype=dtype)
        keep = mmfft.DENSE_MAX[dtype]
        try:
            mmfft.DENSE_MAX[dtype] = n
            dense = _ms(lambda: mmfft.c2r_y_pair(spm, out))
            mmfft.DENSE_MAX[dtype] = n - 1
            four = _ms(lambda: mmfft.c2r_y_pair(spm, out))
        finally:
            mmfft.DENSE_MAX[dtype] = keep
        c = torch.complex(spm[0, 0, 0], spm[0, 0, 1])
        lib = 2 * _ms(lambda: torch.fft.irfft(c, n=n, dim=0))  # two fields
        elems = out.numel() // 2  # complex outputs: D + iF
        flops = 2.0 * (n + 2) * out.numel()  # dense: a dot of n + 2 an output
    else:
        re, im = (torch.randn(shape[what], device="cuda", dtype=dtype, generator=gen)
                  for _ in range(2))
        dense = _ms(lambda: mmfft._dense(re, im, +1))
        four = _ms(lambda: mmfft._four_step(re, im, +1))
        c = torch.complex(re, im)
        lib = _ms(lambda: torch.fft.ifft(c, dim=1))
        elems = re.numel()
        flops = 6.0 * n * elems  # dense: three real products of 2 n an output
    return {"n": n, "dtype": str(dtype).removeprefix("torch."), "pass": what,
            "factor": mmfft._factor(n), "elems": elems, "dense_ms": dense,
            "four_step_ms": four, "torch_fft_ms": lib,
            "dense_tflops": flops / dense / 1e9}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for every time")
    ap.add_argument("--n", type=int, nargs="+", default=list(N_DEFAULT))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    for dtype in (torch.float32, torch.float64):
        for n in args.n:
            for what in ("z", "x", "y", "c2r"):
                r = _case(n, dtype, what)
                rows.append(r)
                print(f"{r['dtype']} n={n} {r['factor']} {what:3s} {r['elems']} elems: "
                      f"dense {r['dense_ms']:.3f} ms ({r['dense_tflops']:.1f} TFLOP/s), "
                      f"four-step {r['four_step_ms']:.3f} ms, torch.fft "
                      f"{r['torch_fft_ms']:.3f} ms", flush=True)
                torch.cuda.empty_cache()
    # the passes of a half step (z, x, c2r) and of a full-grid step (y, z, x)
    for r in rows:
        if r["pass"] != "z":
            continue
        same = {q["pass"]: q for q in rows if q["n"] == r["n"] and q["dtype"] == r["dtype"]}
        for step, passes in (("half step", "z x c2r"), ("full grid", "y z x")):
            d, f = (sum(same[p][k] for p in passes.split())
                    for k in ("dense_ms", "four_step_ms"))
            print(f"{r['dtype']} n={r['n']} {step} ({passes}): dense {d:.3f} ms, "
                  f"four-step {f:.3f} ms")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
