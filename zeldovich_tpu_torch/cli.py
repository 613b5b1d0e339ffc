"""Command-line entry point: ``python -m zeldovich_tpu_torch <param_file>``.

The in-core path of ``zeldovich_tpu/cli.py`` on one CUDA device: reads
the parameter file, reports the memory plan, runs mode synthesis and the
inverse transforms through the hand-written kernels (the half-spectrum
step, or the full-grid step for f_NL, ZD_Version=1 and CornerModes with
k_cutoff != 1), streams the particle output, then prints the physics QA
statistics and throughput, with the same phases, timers, messages and
exit codes.

  --device cuda (default) runs on the card and exits 1 when there is none;
  --device cpu runs the plain tensor-op versions (for tests and checks).
  --dtype float32 (default; the kernels' type) or float64 (--device cpu).

Flags of the JAX CLI that are not ported yet exit 1 naming the ROADMAP
item that will bring them.
"""

from __future__ import annotations

import argparse
import sys
import time

#: unported flag -> (how it shows in args, ROADMAP item)
_NOT_PORTED = {
    "--part": ("part", "A8 (PART1/PART2 checkpoints)"),
    "--sharded": ("sharded", "A10 (several devices)"),
    "--out-of-core": ("out_of_core", "A9 (out-of-core staging)"),
    "--distributed": ("distributed", "A10 (several hosts)"),
    "--profile": ("profile", "A11 (device traces)"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="zeldovich-torch",
        description="Zel'dovich/PLT IC generator (PyTorch + CUDA port)",
    )
    ap.add_argument("param_file", help="ParseHeader-style parameter file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dtype", choices=("float64", "float32", "df64"),
                    default="float32")
    ap.add_argument("--part", type=int, choices=(1, 2), default=None)
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument("--out-of-core", action="store_true")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--distributed", action="store_true")
    args = ap.parse_args(argv)

    for flag, (attr, item) in _NOT_PORTED.items():
        if getattr(args, attr):
            print(f"{flag} is not ported to the torch package yet: ROADMAP "
                  f"{item}; use python -m zeldovich_tpu", file=sys.stderr)
            return 1
    if args.dtype == "df64":
        print("--dtype df64 is not ported yet: ROADMAP A6 (native float64)",
              file=sys.stderr)
        return 1

    t_total = time.perf_counter()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (use --device cpu "
              "for the plain tensor-op route)", file=sys.stderr)
        return 1
    if args.device == "cuda" and args.dtype == "float64":
        print("--dtype float64 on the card is ROADMAP A6; the kernels are "
              "float32", file=sys.stderr)
        return 1

    from zeldovich_tpu.utils.output import OutputWriter, setup_output_dir
    from zeldovich_tpu.utils.params import Parameters, ParameterError
    from zeldovich_tpu.utils.parseheader import ParseError
    from zeldovich_tpu.utils.timers import PhaseTimers

    from .models.pipeline import Zeldovich
    from .utils.streamio import stream_xspace

    try:
        param = Parameters.from_file(args.param_file)
    except FileNotFoundError as e:
        print(f"Parameter file not found: {e.filename}", file=sys.stderr)
        return 1
    except (ParameterError, ParseError) as e:
        print(f"Invalid parameters: {e}", file=sys.stderr)
        return 1
    print(f"Generating ICs for ppd = {param.ppd}", file=sys.stderr)

    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    itemsize = 16 if args.dtype == "float64" else 8
    # f_NL holds the phi grid beside the k-space arrays
    mem_narray = param.narray + (1 if param.f_NL != 0 else 0)
    gib = (param.ppd / 1024.0) ** 3 * mem_narray * itemsize
    print(
        f"Device-resident k-space state: {gib:5.3f} GiB "
        f"({mem_narray} complex arrays, {args.dtype})",
        file=sys.stderr,
    )
    if param.k_cutoff != 1:
        print(
            f"Using k_cutoff = {param.k_cutoff:f} (effective ppd = "
            f"{int(param.ppd / param.k_cutoff + 0.5)})",
            file=sys.stderr,
        )

    timers = PhaseTimers()
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    with timers.phase("Model setup (P(k), RNG tables, eigenmodes)"):
        model = Zeldovich(param, dtype=dtype, device=args.device)
        sync()
    setup_output_dir(param)

    with timers.phase("Mode synthesis (+ f_NL phi pass)"):
        # the static synthesis inputs; the draws themselves run fused
        # into the forward step below
        _ = (model.pk_eff, model.plt_coefs)
        sync()

    with timers.phase("Inverse FFT"):
        # the half-spectrum step, or (f_NL, ZD_Version=1, CornerModes with
        # k_cutoff != 1) the full-grid step with its phi pass
        x = model.xspace_half_pair()
        sync()

    with timers.phase("Output"):
        writer = OutputWriter(param)
        stream_xspace(x, writer)
    del x

    writer.report(model.Pk)
    timers.report(file=sys.stderr)  # the current stderr, not import-time's

    elapsed = time.perf_counter() - t_total
    print(
        f"zeldovich took {elapsed:.4g} sec for ppd {param.ppd} ==> "
        f"{param.np / 1e6 / elapsed:.3g} Mpart/sec",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
