"""Command-line entry point: ``python -m zeldovich_tpu_torch <param_file>``.

The single-device paths of ``zeldovich_tpu/cli.py`` on one CUDA device:
reads the parameter file, reports the memory plan, runs mode synthesis and
the inverse transforms through the hand-written kernels (the half-spectrum
step, or the full-grid step for f_NL, ZD_Version=1 and CornerModes with
k_cutoff != 1), streams the particle output, then prints the physics QA
statistics and throughput, with the same phases, timers, messages,
checkpoint paths and exit codes.

  Every even ppd from 2 to 53508 runs: a power of two in [16, 2048]
  through the FFT kernels, any other through B3, B4, B5 and the
  matrix-product DFTs
  (ops/mmfft.py), as the JAX package routes by size.
  --device cuda (default) runs on the card and exits 1 when there is none;
  --device cpu runs the plain tensor-op versions (for tests and checks).
  --dtype float64 (the default, as the JAX CLI's: full parity), float32
      (half the memory and about half the time; the ic_* doubles of
      RVdoubleZel and Zeldovich then carry float32 rounding, and one
      stderr line says so) or df64.  Both types run through the
      hand-written kernels on the card.  df64, in the JAX package float32
      draws with emulated float64-grade transforms for a chip without
      native doubles, is native float64 here; one stderr line says so.
  --out-of-core [--backing ram|disk] [--slab-mb N] streams y- and z-slabs
      of N MB through a host staging buffer (grids larger than the card).
  --part 1 writes the k-space checkpoint and stops: in-core the full grid
      as a chunk directory zeldovich.kspace.ckpt, out-of-core the pass-1
      stage as the memmap zeldovich.kspace.mm, both in the output
      directory; --part 2 resumes from it, writes the particles and
      removes it.  In core, --part 2 also takes the JAX CLI's complex
      (narray, Y, Z, X) checkpoint of the run's precision (complex128 by
      default).
  --pair is accepted and changes nothing: the port is always the
      complex-free pair route.
  --sharded runs the step over a mesh of ranks (parallel/): every rank of
      a torchrun launch (``python -m torch.distributed.run
      --nproc-per-node N -m zeldovich_tpu_torch --sharded ...``: NCCL, a
      card a rank; gloo with --device cpu), or one rank without torchrun.
      Rank 0 writes every rank's z-slab, the report and the timers; the
      ic_* files are those of a one-rank run.  With --part 1 rank 0
      gathers the k-space grid into the one-device chunk directory, and
      --part 2 reads each rank's rows of it: one-device and --sharded
      checkpoints resume each other.
  --distributed (implies --sharded) runs the ranks as processes on one
      host or several, the JAX CLI's multi-host run: with --coordinator
      HOST:PORT --num-processes N --process-id i (the three go together;
      --coordinator implies --distributed) over tcp://HOST:PORT, or under
      torchrun with none of them.  Each rank pwrites its own z planes into
      the shared ic_* files and the QA statistics are reduced over the
      ranks; rank 0 reports.  --part 1 saves each rank's y-slab of k space
      (shard_r{rank}.npy and meta.json in zeldovich.kspace.ckpt), --part 2
      resumes only with the same number of processes.
  --sharded/--distributed --out-of-core stages 1/W of the grid on each
      rank (models/outofcore.py::DistributedOutOfCore; --part 1 writes
      zeldovich.kspace.mm.p{rank}); each rank writes its own planes.
      ZD_Version=1 exits 1 under --sharded and --distributed.

--profile DIR traces the run with torch.profiler, as the JAX CLI traces it
with jax.profiler: from just after the memory plan to the end of the run
(also a run that fails), the host's torch ops and, with --device cuda, the card's
kernels, copies and NCCL collectives, under ranges named as the timer
report's phases.  Each rank writes one file a run,
DIR/rank{R}.<ns>.pt.trace.json (Perfetto, chrome://tracing, TensorBoard);
with --device cuda a profiler that cannot trace the card fails the run, as
does a trace of a finished run that holds no activity of the card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="zeldovich-torch",
        description="Zel'dovich/PLT IC generator (PyTorch + CUDA port)",
    )
    ap.add_argument("param_file", help="ParseHeader-style parameter file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument(
        "--dtype", choices=("float64", "float32", "df64"), default="float64",
        help="float64 (default: full parity), float32 (half the memory, "
        "about half the time) or df64 (native float64 in this package)",
    )
    ap.add_argument("--part", type=int, choices=(1, 2), default=None)
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument("--out-of-core", action="store_true")
    ap.add_argument("--backing", choices=("ram", "disk"), default="ram")
    ap.add_argument("--slab-mb", type=int, default=2048)
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--pair", action="store_true",
                    help="accepted for the JAX CLI's command lines; the port "
                    "is always the complex-free pair route")
    args = ap.parse_args(argv)

    if args.coordinator is not None:
        args.distributed = True
    if args.distributed:
        args.sharded = True
    if args.dtype == "df64":
        print("--dtype df64 runs as native float64 in the torch package (the "
              "double-float emulation is for chips without float64)",
              file=sys.stderr)
        args.dtype = "float64"

    t_total = time.perf_counter()

    import torch

    from .parallel.mesh import check_triple

    try:
        check_triple(args.coordinator, args.num_processes, args.process_id)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (use --device cpu "
              "for the plain tensor-op route)", file=sys.stderr)
        return 1
    if not args.sharded:
        return _run(args, None, t_total)

    from .parallel.mesh import make_mesh

    mesh = make_mesh(args.device, coordinator=args.coordinator,
                     num_processes=args.num_processes, process_id=args.process_id)
    try:
        # rank 0 speaks for the run; a failing rank's traceback still shows
        quiet = (contextlib.redirect_stderr(io.StringIO()) if mesh.rank
                 else contextlib.nullcontext())
        with quiet:
            print(f"{'Distributed' if args.distributed else 'Sharded'} run over mesh "
                  f"{{'rank': {mesh.world}}} ({mesh.backend}, {mesh.device})",
                  file=sys.stderr)
            return _run(args, mesh, t_total)
    finally:
        mesh.close()


def _run(args, mesh, t_total):
    """The run of main(); ``mesh`` for --sharded, else None: the parameters
    and the memory plan, then the run's steps (``_steps``), traced with
    --profile."""
    import torch

    from .utils.output import OUTPUT_DTYPES
    from .utils.params import ParameterError, Parameters
    from .utils.parseheader import ParseError
    from .utils.timers import PhaseTimers

    if args.part:
        print(f"This is zeldovich part {args.part}", file=sys.stderr)

    try:
        param = Parameters.from_file(args.param_file)
    except FileNotFoundError as e:
        print(f"Parameter file not found: {e.filename}", file=sys.stderr)
        return 1
    except (ParameterError, ParseError) as e:
        print(f"Invalid parameters: {e}", file=sys.stderr)
        return 1
    print(f"Generating ICs for ppd = {param.ppd}", file=sys.stderr)
    fmt = OUTPUT_DTYPES.get(param.ICFormat)  # an unknown format fails at the writer
    if (args.dtype == "float32" and fmt is not None
            and fmt["displ"].base.itemsize == 8):
        print(f"ICFormat {param.ICFormat} stores doubles, but --dtype float32 "
              "computes in float32: the doubles carry float32 rounding (the "
              "default, --dtype float64, gives full parity)", file=sys.stderr)

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
    try:
        with _traced(args.profile, args.device,
                     0 if mesh is None else mesh.rank) as saw_the_card:
            rc = _steps(args, mesh, param, dtype, gib, timers, t_total)
    except TraceError as e:
        print(e, file=sys.stderr)
        return 1
    if rc == 0 and not saw_the_card():
        print(f"--profile: the trace in {args.profile} holds no activity of the "
              "card (CUPTI traced nothing)", file=sys.stderr)
        return 1
    return rc


class TraceError(RuntimeError):
    """--profile cannot trace the card."""


#: seconds --profile waits between starting the profiler on the card and
#: the run's first launch: a trace whose first kernel followed the start
#: within milliseconds lost all of its device activity in 13 starts of
#: 1000, none of 1000 with 0.1 s between (torch 2.11, CUDA 12.8, H100;
#: scripts/torch_profile_start.py --sessions 2000)
CUPTI_SETTLE_S = 0.1


@contextlib.contextmanager
def _traced(out_dir, device, rank):
    """--profile: the body inside one torch.profiler trace of this rank,
    written on the way out (also when the body raises) as
    ``out_dir/rank{rank}.<ns>.pt.trace.json``; the host's torch ops and
    the port's spans on every thread (``profile_all_threads``: the
    writer thread's too) and, on the card, its kernels, copies and
    collectives.  On the card a
    profiler that cannot trace it raises TraceError before the body.
    Yields a function that says, once the trace is written, whether it
    holds the card's activity where it was asked to (always true without
    ``out_dir``, which traces nothing)."""
    if out_dir is None:
        yield lambda: True
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import (
        ProfilerActivity, profile, supported_activities, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise TraceError("--profile: this torch's profiler cannot trace the card "
                             "(no CUPTI)")
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(
        out_dir, worker_name=f"rank{rank}"),
        experimental_config=_ExperimentalConfig(profile_all_threads=True))

    def saw_the_card():
        return device != "cuda" or any(e.device_type() == DeviceType.CUDA
                                       for e in prof.profiler.kineto_results.events())

    prof.start()
    if device == "cuda":
        time.sleep(CUPTI_SETTLE_S)
    try:
        yield saw_the_card
    finally:
        prof.stop()


def _steps(args, mesh, param, dtype, gib, timers, t_total):
    """The steps of _run after its memory plan, timed in ``timers``: model
    setup, then the in-core, out-of-core or sharded run."""
    import torch

    from .models.pipeline import Zeldovich
    from .ops.synth import fft_kernels_take
    from .utils.output import OutputWriter, setup_output_dir
    from .utils.streamio import stream_xspace

    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    # PART1/PART2 boundary state: a chunked y-slab directory (in-core) or
    # the staged grid as a disk memmap (out-of-core)
    ckpt = param.output_path / "zeldovich.kspace.ckpt"
    ckpt_mm = param.output_path / "zeldovich.kspace.mm"
    with timers.phase("Model setup (P(k), RNG tables, eigenmodes)"):
        try:
            if args.out_of_core:
                from .models.outofcore import (
                    DistributedOutOfCore, OutOfCoreZeldovich, StageMismatch,
                )

                ooc = dict(dtype=dtype, slab_bytes=args.slab_mb << 20,
                           backing=args.backing)
                model = (OutOfCoreZeldovich(param, device=args.device, **ooc)
                         if mesh is None else DistributedOutOfCore(param, mesh, **ooc))
            else:
                model = Zeldovich(param, dtype=dtype,
                                  device=args.device if mesh is None else mesh.device)
                if mesh is not None:
                    model.check_sharded(mesh)
        except (NotImplementedError, ValueError) as e:
            if mesh is None:
                raise
            # ZD_Version=1, or ranks that do not divide ppd
            print(e, file=sys.stderr)
            return 1
        sync()
    if not (args.out_of_core or args.part or mesh or fft_kernels_take(param.ppd)) \
            and model.half_exact:
        # the separate half route holds its packed spectrum beside the
        # output, where B1 and B2 share one grid
        print(f"ppd {param.ppd} takes the matrix-product DFTs (the FFT kernels take "
              f"powers of two in [16, 2048]): the half-spectrum step holds "
              f"{2 * gib:5.3f} GiB (packed spectrum and output)", file=sys.stderr)
    if args.part != 2 and (mesh is None or mesh.rank == 0):
        setup_output_dir(param)
    if mesh is not None:
        mesh.barrier()  # no rank writes before rank 0 has set up the directory
        if not args.out_of_core:
            return _sharded_run(args, model, param, mesh, timers, sync, t_total, ckpt)

    if args.out_of_core:
        # streamed run (the PART boundary is the staged host buffer)
        with timers.phase("Out-of-core streamed run"):
            if args.part == 1:
                stage = model.stage_pass1(stage=model.stage_memmap(ckpt_mm, "w+"))
                stage.flush()
                if mesh is not None:
                    mesh.barrier()  # every rank's stage is written
                print(f"Checkpoint written to {ckpt_mm}", file=sys.stderr)
            elif args.part == 2:
                try:
                    stage = model.stage_memmap(ckpt_mm, "r")
                except StageMismatch as e:
                    same = ".par and --dtype" if mesh is None else \
                        ".par, --dtype and number of processes"
                    print(f"{e} (part 1/2 must use the same {same})", file=sys.stderr)
                    return 1
                model.run(setup_dir=False, stage=stage)
                del stage
                model.cleanup_stage_memmap(ckpt_mm)
            else:
                model.run(setup_dir=False)
        if mesh is None or mesh.rank == 0:
            timers.report(file=sys.stderr)
            _report_rate(param, t_total, mesh if args.distributed else None)
        return 0

    from .utils.checkpoint import (
        kspace_layout, load_kspace_pair, remove_kspace, save_kspace,
    )

    if args.part == 2:
        with timers.phase("Loading k-space checkpoint"):
            # the port's pair layout, or the JAX CLI's complex grid of the
            # same precision (split into the pair layout while it loads)
            grid = (param.ppd,) * 3
            takes = {(param.narray, 2, *grid): args.dtype,
                     (param.narray, *grid): f"complex{16 * dtype.itemsize}"}
            shape, held, _ = kspace_layout(ckpt)
            if takes.get(shape) != held.name:
                print(f"checkpoint holds {held.name} {shape} but this run expects "
                      + " or ".join(f"{d} {s}" for s, d in takes.items())
                      + " (part 1/2 must use the same .par and --dtype)",
                      file=sys.stderr)
                return 1
            kgrid = torch.from_numpy(load_kspace_pair(ckpt)).to(args.device)
            sync()
    else:
        with timers.phase("Mode synthesis (+ f_NL phi pass)"):
            # the full-grid k-space only when checkpointing; otherwise the
            # static synthesis inputs, the draws running fused into the
            # forward step below
            kgrid = model.kspace_pair() if args.part == 1 else None
            _ = (model.pk_eff, model.plt_coefs)
            sync()

    if args.part == 1:
        with timers.phase("Writing k-space checkpoint"):
            save_kspace(kgrid, ckpt)
        timers.report(file=sys.stderr)
        print(f"Checkpoint written to {ckpt}", file=sys.stderr)
        return 0

    with timers.phase("Inverse FFT"):
        # a loaded grid, the half-spectrum step, or (f_NL, ZD_Version=1,
        # CornerModes with k_cutoff != 1) the full-grid step with its phi
        # pass
        x = model.xspace_half_pair() if kgrid is None else model.xspace_pair(kgrid)
        sync()
    del kgrid

    with timers.phase("Output"):
        writer = OutputWriter(param)
        stream_xspace(x, writer)
    del x

    if args.part == 2 and ckpt.exists():
        remove_kspace(ckpt)

    writer.report(model.Pk)
    timers.report(file=sys.stderr)  # the current stderr, not import-time's
    _report_rate(param, t_total)
    return 0


def _sharded_run(args, model, param, mesh, timers, sync, t_total, ckpt):
    """--sharded/--distributed in core, after the model's setup: this
    rank's slab of the step (of a loaded checkpoint with --part 2), and its
    output: its own planes with --distributed, else through rank 0's
    writer; or with --part 1 the k-space checkpoint."""
    from .parallel.multihost import run_multihost, sharded_step
    from .utils import checkpoint
    from .utils.output import OutputWriter
    from .utils.streamio import stream_xspace_sharded

    if args.part == 1:
        with timers.phase("Mode synthesis (+ f_NL phi pass)"):
            kgrid = model.kspace_pair_sharded(mesh)  # this rank's y-slab
            sync()
        with timers.phase("Writing k-space checkpoint"):
            save = (checkpoint.save_sharded if args.distributed
                    else checkpoint.save_kspace_gathered)
            save(kgrid, ckpt, mesh)
        if mesh.rank == 0:
            timers.report(file=sys.stderr)
            print(f"Checkpoint written to {ckpt}", file=sys.stderr)
        return 0

    kgrid = None
    if args.part == 2:
        with timers.phase("Loading k-space checkpoint"):
            try:
                kgrid = _load_rank_rows(args, model, mesh, ckpt)
            except checkpoint.CheckpointMismatch as e:
                print(e, file=sys.stderr)
                return 1
            sync()
    if args.distributed:
        writer = run_multihost(model, mesh, timers, kgrid)
    else:
        x = sharded_step(model, mesh, timers, kgrid)
        with timers.phase("Output"):
            writer = OutputWriter(param) if mesh.rank == 0 else None
            stream_xspace_sharded(x, writer, mesh)
        del x
    del kgrid
    if args.part == 2:
        mesh.barrier()  # every rank has read its rows
        if mesh.rank == 0:
            checkpoint.remove_kspace(ckpt)
    if mesh.rank == 0:
        writer.report(model.Pk)
        timers.report(file=sys.stderr)
        _report_rate(param, t_total, mesh if args.distributed else None)
    return 0


def _load_rank_rows(args, model, mesh, ckpt):
    """This rank's y-slab of the --part 1 checkpoint on its device: its
    shard (--distributed), else its rows of the one-device chunk directory
    (the port's pair layout or the JAX CLI's complex grid of the run's
    precision).  CheckpointMismatch on every rank where any rank cannot
    take it."""
    from .parallel.pencil_mmfft import slab
    from .utils import checkpoint

    import torch

    p = model.param
    grid = (p.narray, 2, p.ppd, p.ppd, p.ppd)
    held = "float64" if model.dtype == torch.float64 else "float32"
    if args.distributed:
        return checkpoint.load_sharded(ckpt, mesh, grid, held, mesh.device)
    takes = {grid: held, (p.narray, *grid[2:]): f"complex{2 * int(held[5:])}"}
    err = rows = None
    try:
        shape, dtype, _ = checkpoint.kspace_layout(ckpt)
        if takes.get(shape) != dtype.name:
            raise checkpoint.CheckpointMismatch(
                f"checkpoint holds {dtype.name} {shape} but this run expects "
                + " or ".join(f"{d} {s}" for s, d in takes.items())
                + " (part 1/2 must use the same .par and --dtype)")
        rows = checkpoint.load_kspace_pair(ckpt, rows=slab(p.ppd, mesh))
    except (OSError, ValueError) as e:
        err = e if isinstance(e, checkpoint.CheckpointMismatch) else \
            checkpoint.CheckpointMismatch(f"no k-space checkpoint at {ckpt}: {e}")
    if not mesh.agree(err is None):
        raise err or checkpoint.CheckpointMismatch(
            f"checkpoint {ckpt}: another rank cannot read its rows")
    return torch.from_numpy(rows).to(mesh.device)


def _report_rate(param, t_total, mesh=None):
    """The throughput line; with the mesh of a --distributed run, its
    processes and devices (a card a rank) as the JAX CLI prints them."""
    elapsed = time.perf_counter() - t_total
    over = "" if mesh is None else f" ({mesh.world} processes, {mesh.world} devices)"
    print(
        f"zeldovich took {elapsed:.4g} sec for ppd {param.ppd}{over} ==> "
        f"{param.np / 1e6 / elapsed:.3g} Mpart/sec",
        file=sys.stderr,
    )


if __name__ == "__main__":
    sys.exit(main())
