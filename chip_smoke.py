#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (zeldovich_tpu_torch) on one GPU.

    python3 chip_smoke.py [--only sharded]

Run from a checkout, with no install step; it needs one CUDA card and
nvcc.  Phases, each printed on its own lines; any failure raises and the
script exits non-zero without printing a result:

1. card: nvidia-smi name and power limit, torch and CUDA versions; build
   the kernels from csrc/ (one nvcc per source, in parallel) and print
   ptxas registers, shared memory, spills; fail on any stack frame or
   spill in the register-resident FFT kernels: the 16 axis DFT kernels
   (zx, y), B1's 8 pack_rows_kernel and B2's 8 column kernels, and in
   B4's 4 boxmuller_kernel instances, float32 and float64 alike (a
   float64 draw kernel may show the 40-byte buffer of the library
   sincos's large-argument path, which ptxas lists beside it); count the
   float64 operations a mode of the float64 draw chain from B5's SASS;
1b. PLT eigenmode tables generated on the card (ops/lattice.py, torch ops
   in float64): N = 128, 256 and 512 timed with CUDA events, the Ewald
   sums and the eigensolve apart, each beside its float64 bound (exp, cos
   and the division counted from SASS), with the peak device memory; the
   128 table held to zeldovich_tpu/assets/eigmodes128 under
   lattice.check_table's rules and made twice for the same bytes; the 512
   table written by scripts/torch_generate_eigmodes.py (the same bytes as
   in this process) and run: the 512^3 PLT half step in float32 and
   float64 on it (the lookup's direct gather), kernels against the plain
   route, timed beside the step on the shipped 128 table; and the 128^3
   PLT CLI in float64 on the card's 128 table, particle by particle within
   1e-10 of the run on the shipped table;
2. kernel B1 (halfspace_pack_zx) against its plain version on the card, at
   128^3 with example.par's PLT configuration and at 512^3 plain float32;
   and small cases at every n in [16, 2048] (SMALL_N): plain, PLT, fixed
   power and density only, on the generated planes [0, r) (the ky = 0
   fixup) and [n/2 - r, n/2);
3. kernel B2 (c2r_y) against its plain version on phase 2's outputs, out
   of place and in place (out=g, the main path's call); and small cases
   at every n in [16, 2048] with and without the Nyquist row, in place
   and out of place, on (2, 2, 2, ky, 3, 20) (a ragged last tile);
4. kernel B4 (halfspace_boxmuller) against its plain version at 512^3,
   with and without a live mask, fixed power both ways, timed beside its
   bound; at 1024^3 timed, its first and last 4 planes against the plain
   version; small cases at every n in [16, 2048] on 1 and 35 planes (a
   full y tile and a ragged end) at both ends of the half space;
   zx_dft (B6/B7) and y_dft (B8) against their plain versions (torch.fft)
   at the shapes the paths launch: zx on the 512^3 full grid and the
   1024^3 and 2048^3 pass-1 y-slabs, y on the 512^3 full grid, the 1024^3
   and 2048^3 pass-2 z-slabs and a thin (2, 2, 512, 8, 512) z-slab, and
   small cases (SMALL) for every n in [16, 2048], ragged last tiles and
   data off a 16-byte boundary; both signs, in place and out of place;
   each path shape timed in turns plain, kernel, kernel, plain beside the
   single library call (torch.fft.ifftn / ifft on a complex64 tensor
   formed once, which the port never calls);
5. B1, B2 and the half-spectrum forward step (B1, then B2 in place:
   ``Zeldovich.xspace_half_pair``) timed against the plain route (torch
   ops + torch.fft) with CUDA events, in turns plain, kernel, kernel,
   plain: 512^3 plain and 512^3 PLT; 1024^3 plain (kernel route alone:
   B1, B2, the step and its peak memory);
6. the full-grid forward step (B4, zx, y) timed the same way: 512^3 f_NL,
   512^3 f_NL + PLT, 512^3 CornerModes with k_cutoff = 2, a device
   profile of one 512^3 f_NL step, and 1024^3 f_NL (kernel route, peak
   memory);
7. kernel B5 (boxmuller) against its plain version on 512^3 y-slabs of 64
   rows (the slab synthesis' chunk) in the generated half, across ppd/2
   and in the mirror half, and the f_NL gen_phi slab synthesis through it
   against the plain route;
8. kernel B3 (halfspace_pack) against its plain version at 512^3 plain and
   128^3 PLT, and the separate-kernel half route (B3, zx, B2) against the
   fused route (B1, B2) at 512^3;
9. out of core at size: stage_pass1 at 1024^3 plain (8 slabs of 128
   rows, a 17.2 GB host stage, in RAM or on disk as `free` and `df` allow)
   with its device-time share and peak device memory (at 2048^3 too where
   the host holds its 137 GB stage); pass 2 over that stage in parts
   (the loop without the writer, one z-slab's gather, H2D, y_dft, D2H
   and the writer on it); and the device work of one 2048^3
   pass-1 y-slab and one pass-2 z-slab against the plain route;
10. end to end through zeldovich_tpu_torch.cli.main, the launch counters
   reset just before each run and read just after: example.par (128^3
   PLT, RVZel) and example.par's keys with f_NL = 30 (both held particle
   by particle against the same run through the plain route), 256^3
   plain and PLT, 512^3 f_NL, 256^3 CornerModes with k_cutoff = 2,
   128^3 ZD_Version=1; --out-of-core at 256^3 plain (RAM stage) and
   128^3 f_NL + PLT (disk stage), each held particle by particle against
   its in-core run, and 256^3 f_NL; the separate-kernel half route
   through the model API (kspace_half_pair -> xspace_half_pair) at 256^3
   against the fused run; --part 1 then --part 2 at 128^3, in core and
   out of core, against the one-shot run.  Each run must launch the
   kernels of its path and no other.  Those runs pass --dtype float32.
   Then float64, with no --dtype (the CLI's default): example.par as it
   stands, then RVdoubleZel doubles held to 1e-12: 128^3 PLT and 128^3 f_NL + PLT against the
   plain route, --dtype df64 against the first, 128^3 ZD_Version=1,
   256^3 plain in core, by
   the separate-kernel route and --out-of-core, --part 1 then --part 2 at
   128^3, and --part 2 alone on a complex128 (narray, Y, Z, X) checkpoint;
11. ppd that no FFT kernel takes (phase_sizes): B3, B4 and B5 with the
   matrix-product DFTs of ops/mmfft.py.  A 576 PLT table made on the card;
   at 576^3 in float64 and float32: B3 (plain and PLT), B4 and B5 (three
   slabs) against their plain versions with times and bounds, the separate
   half step plain and PLT against the plain route with its launches (B3
   alone), its time and peak, zx_mm and c2r_y_pair against complex128
   torch.fft with their times beside torch.fft's and their operation
   bounds, the float32 step against the float64 one; the 576^3 f_NL
   float64 full step against the plain route; the 1152^3 float32 half step
   in core (launches, finite, time, peak); at 1728^3 and 4096^3 one
   out-of-core slab of each pass against the plain route; the CLI at 576^3
   in float64 with no --dtype, plain and PLT on the card's 576 table (PLT
   held particle by particle against the plain route's output the float64
   half step kept), then --out-of-core against the in-core run.  At
   ppd 2, 8 and 12 (SIZES_SMALL) in both types: B3, B4 and B5 against
   their plain versions and the separate half step, plain and PLT, against
   the plain route with its launches.

12. the sharded step (``--sharded``, zeldovich_tpu_torch/parallel), in
   float64: (a) the CLI with --sharded over every card (NCCL; one card:
   one rank in this process, its launch counters reset just before each
   run and read just after) against a one-rank CLI run of the same
   arithmetic, every output byte: 512^3 plain and 128^3 PLT against the
   in-core run (the half route: B1 and B2), 256^3 f_NL (RVdoubleZel) and
   576^3 density only against --out-of-core (the full grid: B5, zx, y or the
   matrix products, z/x before y); (b) two ranks sharing card 0 over a
   gloo group (started with the spawn method), through the model API at
   256^3 plain (half route) and f_NL and at 192^3 (full grid on the
   products): every rank must launch its route's kernels, and the slabs
   put together equal the one-device step bit for bit on the half route,
   within 1e-12 of the largest value on the full grid (which transforms
   z/x before y); (c) timing over every card (NCCL; one card: one rank in
   this process, at 512^3; more: a rank a card, at 512^3 and 1024^3), in
   float32 and float64 plain (the half route) and float64 f_NL (the full
   grid): the sharded step, its exchange alone with its bytes bound, the
   one-device step, their peak memory.  With more than one card (a) and
   (c) start a process a card (the spawn method, the environment torchrun
   gives its ranks) and every rank's launch counters are read and checked.
   ``python3 chip_smoke.py --only sharded`` runs phases 1, 12, 13 and 14
   alone.
13. several processes and sharded out of core (``--distributed``,
   zeldovich_tpu_torch/parallel/multihost.py and outofcore.py,
   ``DistributedOutOfCore``), in float64: (a) the CLI with --distributed
   over every card (NCCL; one card: one process joined over the loopback
   triple --coordinator 127.0.0.1:P --num-processes 1 --process-id 0; more:
   a process a card, each with its triple), every output byte against the
   one-device run of the same arithmetic (shared with phase 12a): 512^3
   plain in core against the in-core run; 256^3 f_NL (RVdoubleZel) in core,
   --part 1 then --part 2 at 256^3, --out-of-core at 256^3 plain and f_NL,
   576^3 (density only, the products) and --out-of-core --part 1/2 at
   256^3, against --out-of-core; every rank's launch counters reset just
   before each run, read just after and checked; (b) two ranks sharing
   card 0 over gloo (spawned), through the model API:
   DistributedOutOfCore at 256^3 plain and f_NL (each rank launches B5, zx
   and y and stages half the grid; their z-slabs bit for bit the one-device
   out-of-core step's), and save_sharded -> load_sharded of the 192^3
   k-space y-slabs (the one-device synthesis bit for bit); (c) 1024^3
   float32 DistributedOutOfCore over every card (one card: one rank over
   NCCL): pass 1, pass 2 without the writer, the exchange's share of pass
   2, the stage a rank, the peak device memory; with more than one card
   the Output phase of --distributed against --sharded's rank-0 writer at
   512^3 (RVZel) and 1024^3 (ZelSimple), in core; (d) on one card, two
   --distributed processes joined over the triple share card 0: NCCL must
   refuse them (both exit non-zero naming the duplicate GPU), no gloo.
14. --profile DIR (torch.profiler, one trace a rank and run), float64, the
   launch counters reset just before each CLI run and read just after:
   (a) after one empty trace (the profiler's first start in a process,
   which scripts/torch_profile_start.py times in a fresh process), the
   512^3 plain CLI without and with --profile: the same launches and every
   output byte the same; the wall, the "Inverse FFT" and "Output" phases
   of both, the trace's MB and event count, and inside its "Output" range
   the card's busy share, its longest idle gap, the copies and the main
   thread's time in torch ops; (b) the 256^3 f_NL --out-of-core run (64 MB
   slabs) with --profile; (c) at 128^3 f_NL in core (the full grid), --part 1 then
   --part 2 into one DIR (two traces) and --sharded (one rank); (d)
   --distributed --profile at 256^3 plain over every card (one card: one
   process joined over the loopback triple; more: a process a card), a
   trace a rank, each with NCCL kernel events on more than one card.  In
   every trace each port kernel (TRACE_KERNELS: pack_rows_kernel,
   axis_cols_kernel, axis_rows_kernel, boxmuller_kernel,
   boxmuller_at_kernel, pack_kernel) has as many events as its wrappers'
   launch counters give, and every one of their launches (the CUDA runtime
   call the trace correlates with the kernel) lies inside the run's
   "Inverse FFT" range (in core; --part 1: "Mode synthesis") or
   "Out-of-core streamed run" range.  Prints a {"profile": ...} JSON line.
15. the PLT coefficient kernel (csrc/plt.cu, ``plt_coef_fields`` on the
   card) against its plain version (``plt_coef_fields_plain``, torch ops
   on the card), each plane to PLT_TOL of its largest value, in float32
   and float64, on the shipped 128 table: 16^3 (the direct gather), 24^3
   (the interpolation, with and without rescaling), 512^3 (the cell's
   lookup) and its planes [100, 137) (also equal to the same planes of the
   whole); one launch a call; at 512^3 timed in turns plain, kernel,
   kernel, plain beside its bound (the four planes written and the table
   read once at 3.35 TB/s); and a whole 512^3 PLT realization
   (``Zeldovich.xspace_half_pair``: one PLT launch, B1, B2) against the
   same realization on the plain version's planes.  Prints a {"plt": ...}
   JSON line.  Alone: ``python3 -c "import chip_smoke as c;
   c.phase_card(); c.phase_plt('float64'); c.phase_plt('float32')"``.

Phases 2 to 8 run twice, in float32 and in float64 (the double instances
of every kernel: against the plain versions to 1e-12 of the largest value
at every n in [16, 2048] and at the path shapes, the 512^3 PLT half step,
the 512^3 f_NL step, the 1024^3 steps with their peaks, torch.fft on
complex128 as the library call); phase 9 is float32.

Kernel times are CUDA events around several launches, per launch.  The
last two lines are the kernel JSON summary (every kernel once per element
type with its dtype: its launches on that type's end-to-end runs, error,
times, the bound: the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s (float32) or 33.5 TFLOP/s (float64, the
card's vector rate), and the library call's time where one exists) and
the result line
{"ok": true, "device": {...}}.  Nothing of JAX or of the JAX package is
imported: the port has its own copies of the host modules (parameters,
power spectrum, host pcg64, the v1 MT19937 stream, the ic_* writer); only
the data files under zeldovich_tpu/assets are read.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EXAMPLE = ROOT / "example.par"
ASSETS = ROOT / "zeldovich_tpu" / "assets"

B1_TOL, B2_TOL, ZERO_TOL, PARTICLE_TOL = 1e-5, 2e-6, 1e-6, 1e-5
B4_TOL, DFT_TOL = 1e-5, 1e-5
B5_TOL, B3_TOL, ROUTE_TOL = 1e-5, 1e-5, 1e-5
#: the 576^3 float32 half step against the float64 one: their draws differ
#: (float32 uniforms carry 32 bits), so this is no kernel's error; it read
#: 8.125e-6 of the largest value on every run that got there, and the
#: limit leaves room above that for another draw or cuBLAS algorithm
F32_VS_F64_TOL = 3e-5
#: float64: every kernel and route against its plain version, the zeros
#: and the particles, all relative to the largest value
F64_TOL = 1e-12

#: NVIDIA H100 SXM data sheet: device memory rate, float32 and float64
#: vector peaks (no tensor cores); a kernel's bound is the larger of its
#: bytes and its operations over these
HBM_BPS, F32_OPS, F64_OPS = 3.35e12, 67e12, 33.5e12
#: the FP64 tensor-core peak of the same data sheet: the bound of the
#: float64 matrix products (cuBLAS runs DGEMM on the tensor cores)
F64_TC_OPS = 67e12
#: 32-bit operations a mode of the draw kernels (B1, B3-B5): the pcg64
#: jump (one 128-bit multiply-add), two XSL-RR draws and Box-Muller
DRAW_OPS = 100
#: float64 operations a mode of the float64 draw kernels on top of the
#: integer chain (the library's log, sqrt and sincos): counted from B5's
#: SASS in phase 1 (_f64_draw_ops), a multiply-add as two
DRAW_F64_OPS = None
TAG = {"float32": "f32", "float64": "f64"}

#: zx (B6/B7) and y (B8) at the shapes the paths launch: the 512^3 full
#: grid, the 1024^3 and 2048^3 out-of-core slabs (2.15 GB each) and a thin
#: z-slab
ZX_SHAPES = ((2, 2, 512, 512, 512), (2, 2, 128, 1024, 1024),
             (2, 2, 32, 2048, 2048))
Y_SHAPES = ((2, 2, 512, 512, 512), (2, 2, 1024, 128, 1024),
            (2, 2, 2048, 32, 2048), (2, 2, 512, 8, 512))
#: correctness only, (kernel, shape, offset in floats of the data from a
#: 16-byte boundary): every n of the column kernel, the ragged last tile
#: (Bz * X, or n for zx's z pass, not a multiple of the tile's 32, 16 or 8
#: columns; n = 16 a tile wider than the plane), Bz * X not a multiple of
#: 4 and data on an 8-byte but not a 16-byte boundary
SMALL = (("zx", (1, 2, 3, 16, 16), 0), ("zx", (1, 2, 3, 32, 32), 0),
         ("zx", (1, 2, 3, 64, 64), 0), ("zx", (1, 2, 3, 128, 128), 0),
         ("zx", (1, 2, 3, 256, 256), 0), ("zx", (1, 2, 4, 1024, 1024), 0),
         ("zx", (1, 2, 2, 2048, 2048), 0),
         ("y", (1, 2, 16, 3, 16), 0), ("y", (1, 2, 16, 3, 16), 2),
         ("y", (1, 2, 32, 3, 10), 0), ("y", (2, 2, 64, 5, 12), 0),
         ("y", (1, 2, 256, 3, 20), 0), ("y", (1, 2, 512, 3, 20), 0),
         ("y", (1, 2, 1024, 1, 36), 0), ("y", (1, 2, 2048, 1, 20), 0),
         ("y", (1, 2, 2048, 3, 2), 0), ("zx", (1, 2, 3, 512, 512), 2))
#: float64 alone (a float64 thread moves one column): an odd Bz * X
SMALL_F64 = (("y", (1, 2, 64, 3, 7), 0), ("y", (1, 2, 512, 1, 21), 0),
             ("y", (1, 2, 2048, 1, 5), 1))

#: B1, B2 and B4 correctness cases: every n of the kernels
SMALL_N = (16, 32, 64, 128, 256, 512, 1024, 2048)
#: B1's configurations: name, PLT, extra .par keys
B1_CONFIGS = (("plain", False, {}), ("PLT", True, {}),
              ("fixed power", False, {"ZD_qPk_fix_to_mean": "1"}),
              ("density only", False, {"ZD_qdensity": "2"}))

#: the f_NL configuration: local non-Gaussianity of a Planck-like cosmology
FNL = dict(ZD_f_NL="30.0", ZD_n_s="0.96", Omega_M="0.3")
CORNER = dict(ZD_CornerModes="1", ZD_k_cutoff="2.0")
V1 = dict(ZD_Version="1")


def say(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cpd_for(ppd: int) -> int:
    return ppd * 375 // 128  # example.par's CPD : ppd ratio


def par_text(ppd: int, outdir, plt: bool, seed: int = 12346, **extra) -> str:
    """example.par's keys at another size, with absolute paths."""
    keys = {}
    for line in EXAMPLE.read_text().splitlines():
        m = re.match(r"\s*(\w+)\s*=\s*(.+?)\s*$", line)
        if m:
            keys[m.group(1)] = m.group(2)
    keys.update(
        NP=str(ppd**3), CPD=str(cpd_for(ppd)), ZD_Seed=str(seed),
        InitialConditionsDirectory=f'"{outdir}"',
        ZD_Pk_filename=f'"{ASSETS / "wmap1new.pow"}"',
        ZD_PLT_filename=f'"{ASSETS / "eigmodes128"}"',
        ZD_qPLT=str(int(plt)),
    )
    keys.update(extra)
    return "".join(f"{k} = {v}\n" for k, v in keys.items())


def tol_for(dt: str, f32_tol: float) -> float:
    return f32_tol if dt == "float32" else F64_TOL


def _param_for(ppd, plt=False, **extra):
    """The Parameters of par_text(ppd, ..., plt, **extra)."""
    from zeldovich_tpu_torch.utils.params import Parameters

    tmp = Path(tempfile.mkdtemp(prefix="zt_param_"))
    try:
        (tmp / "m.par").write_text(par_text(ppd, tmp / "ic", plt, **extra))
        return Parameters.from_file(tmp / "m.par")
    finally:
        shutil.rmtree(tmp)


def model_for(ppd, plt, device="cuda", dt="float32", **extra):
    import torch

    from zeldovich_tpu_torch.models.pipeline import Zeldovich

    param = _param_for(ppd, plt, **extra)
    with contextlib.redirect_stderr(io.StringIO()):
        return Zeldovich(param, dtype=getattr(torch, dt), device=device)


def compare(k, p, tol, what):
    """max|k - p| <= tol * max|p|, and matching zeros (to ZERO_TOL;
    float64 to F64_TOL)."""
    import torch

    check(k.dtype == p.dtype, f"{what}: kernel gave {k.dtype}, plain {p.dtype}")
    ztol = ZERO_TOL if k.dtype == torch.float32 else F64_TOL
    scale = p.abs().max().item()
    err = (k - p).abs().max().item()
    zk = (k[p == 0].abs().max().item() if (p == 0).any() else 0.0)
    zp = (p[k == 0].abs().max().item() if (k == 0).any() else 0.0)
    finite = bool(torch.isfinite(k).all())
    rel = err / scale if scale else (math.inf if err else 0.0)  # ppd 2: all zero
    say(f"  {what}: max|k-p| = {err:.3e} = {rel:.3e} * max|p| "
        f"(tol {tol:g}); zeros {zk:.1e}/{zp:.1e} of {scale:.3e}")
    check(finite, f"{what}: non-finite kernel output")
    check(err <= tol * scale, f"{what}: kernel disagrees with plain")
    check(zk <= ztol * scale and zp <= ztol * scale,
          f"{what}: zero pattern differs")
    return err


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(moved: int, ops: float, dt: str = "float32", draws: int = 0) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the memory rate, or operations
    over the peak, whichever is larger.  `ops` are operations of the
    element type (float32 or float64 peak); `draws` modes of the draw
    kernels add DRAW_OPS 32-bit operations each and, in float64,
    DRAW_F64_OPS float64 ones."""
    tb = 1e3 * moved / HBM_BPS
    to = 1e3 * (ops / (F32_OPS if dt == "float32" else F64_OPS)
                + draws * DRAW_OPS / F32_OPS
                + (draws * DRAW_F64_OPS / F64_OPS if dt == "float64" else 0.0))
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}


def fft_ops(elems: int, n: int) -> float:
    """5 N log2 N operations a complex DFT of length n, for `elems`
    complex elements transformed along that axis."""
    return 5.0 * elems * math.log2(n)


def counted(name, fn):
    """fn() with a check that it launched kernel `name` exactly once."""
    import torch

    from zeldovich_tpu_torch import kernels

    before = kernels.launches[name]
    out = fn()
    torch.cuda.synchronize()
    check(kernels.launches[name] == before + 1, f"{name} launch counter did not move")
    return out


def phase_card():
    import torch

    from zeldovich_tpu_torch import kernels

    say("== phase 1: card")
    say(smi())
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    nvcc_s = kernels.build(force=True)
    kernels.library()
    say(f"built {kernels.LIB.name} from {len(kernels._sources())} sources: "
        f"nvcc {nvcc_s:.1f} s, build+load {time.perf_counter() - t0:.1f} s")
    report = kernels.ptxas_report()
    for line in report:
        say("  ptxas " + line)
    # the FFT kernels keep their elements in registers: no stack frame (a
    # register array indexed at run time lands there), no spills
    # float32 and float64 instances alike (the entries of X.cu and X_f64.cu)
    for what, has, want in (
            ("axis DFT (zx, y)", lambda k: "axis_" in k and "C2rLoad" not in k, 16),
            ("B1 pack_rows_kernel", lambda k: "pack_rows_kernel" in k, 8),
            ("B2 axis_cols_kernel<C2rLoad>", lambda k: "C2rLoad" in k, 8),
            ("B4 boxmuller_kernel", lambda k: "boxmuller_kernel" in k, 4)):
        for f64 in (False, True):
            found = [ln for ln in report if "spill" in ln and " in " not in ln.split(":")[0]
                     and has(ln.split(":")[0]) and ("_f64]" in ln.split(":")[0]) == f64]
            tag = f"{what} {'float64' if f64 else 'float32'}"
            check(len(found) == want,
                  f"ptxas reported {len(found)} {tag} kernels, want {want}")
            # a float64 draw kernel (B1, B4) calls the library's sincos, whose
            # large-argument path (never taken: the angle is at most 2 pi)
            # ptxas reports as a function of its own, its 40-byte result
            # buffer as the kernel's stack frame: that frame alone passes
            slow = {ln.split(" in ", 1)[1].split(":")[0] for ln in report
                    if ln.startswith("__internal_trig_reduction_slowpathd in ")}
            for ln in found:
                clean = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
                ok = [clean] + ([clean.replace("0 bytes stack", "40 bytes stack", 1)]
                                if f64 and ln.split(":")[0] in slow else [])
                check(ln.split(": ", 1)[1].startswith(tuple(ok)),
                      f"local memory in a {tag} kernel: {ln}")
    # the PLT coefficient kernel (float <2>, <4>, double <2>): no spills (the
    # library's double pow, a function of its own in the report, may spill)
    plt = [ln for ln in report if "spill" in ln and " in " not in ln.split(":")[0]
           and "plt_coefs_kernel" in ln.split(":")[0]]
    check(len(plt) == 3, f"ptxas reported {len(plt)} PLT coefficient kernels, want 3")
    for ln in plt:
        check("0 bytes spill stores" in ln, f"spills in a PLT coefficient kernel: {ln}")
    global DRAW_F64_OPS
    DRAW_F64_OPS = _f64_draw_ops()


def _sass(binary) -> str:
    from zeldovich_tpu_torch import kernels

    cuobjdump = Path(kernels.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(binary)],
                          capture_output=True, text=True, check=True).stdout


def _sass_f64_ops(sass: str, function: str) -> int:
    """float64 operations in the SASS of the function whose name contains
    `function` (its code as listed, slow paths that are functions of their
    own left out): every instruction of the float64 pipe (DADD, DMUL,
    DSETP, DMNMX, the conversions and the MUFU seeds of divisions and
    roots) counts one, a multiply-add (DFMA) two."""
    ops, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
        m = re.search(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", line)
        if inside and m:
            op = m.group(1)
            if op.startswith("DFMA"):
                ops += 2
            elif (op.startswith(("DADD", "DMUL", "DSETP", "DMNMX"))
                  or (op.startswith(("MUFU", "I2F", "F2F")) and "64" in op)):
                ops += 1
    check(ops > 0, f"no float64 instruction found in {function}'s SASS")
    return ops


def _f64_draw_ops() -> int:
    """float64 operations a mode of the float64 draw chain, from the SASS
    of B5's float64 kernel (one mode a thread, no loop)."""
    from zeldovich_tpu_torch import kernels

    ops = _sass_f64_ops(_sass(kernels.LIB), "boxmuller_at_kernelId")
    say(f"  float64 draw chain: {ops} float64 operations a mode (B5's SASS)")
    return ops


#: the PLT generator's table sizes timed on the card (phase 1b): 128 the
#: shipped table's, 512 a PLT user's run size (its direct-gather lookup)
EIG_N = (128, 256, 512)
#: float64 operations of a k-point's Ewald sums beside the library
#: functions (exp, cos, division; counted from SASS), a multiply-add as two
#: and the symmetric tensors' 6 entries: per lattice vector R, k.R (5),
#: cos - 1 (1) and the 6 products into s(R) (12); per reciprocal vector K,
#: q = k + K (3), |q|^2 (5), the exponent's and the result's scalings (2),
#: q_a w (3) and the 6 products q_a w q_b (12); per k-point, the two parts,
#: the background and 1/(4 pi) (18)
EWALD_R_OPS, EWALD_K_OPS, EWALD_OPS = 18, 25, 18
#: bytes a k-point of the eigensolve moves: eps (9 doubles) and k_hat (3)
#: read, the vector and its eigenvalue (4) written; a closed-form 3x3
#: eigensolve with the vector choice is ~350 float64 operations, under the
#: 1280 whose time at F64_OPS would outlast these bytes' at HBM_BPS
EIG_BYTES = 8 * (9 + 3 + 4)
#: three library functions in double, one a kernel, for their SASS
LIBM_PROBE = r"""
extern "C" __global__ void probe_exp(double* x) { x[threadIdx.x] = exp(x[threadIdx.x]); }
extern "C" __global__ void probe_cos(double* x) { x[threadIdx.x] = cos(x[threadIdx.x]); }
extern "C" __global__ void probe_div(double* x, const double* y) {
  x[threadIdx.x] = x[threadIdx.x] / y[threadIdx.x];
}
"""


def _libm_f64_ops() -> dict:
    """float64 operations of exp, cos and a division in double, from the
    SASS of one probe kernel each (nvcc for sm_90a, as the port's kernels)."""
    from zeldovich_tpu_torch import kernels

    with tempfile.TemporaryDirectory() as d:
        cu, cubin = Path(d) / "probe.cu", Path(d) / "probe.cubin"
        cu.write_text(LIBM_PROBE)
        subprocess.run([kernels.nvcc_path(), *kernels.ARCH, "-O3", "-cubin",
                        "-o", str(cubin), str(cu)], check=True, capture_output=True)
        sass = _sass(cubin)
    ops = {f: _sass_f64_ops(sass, f"probe_{f}") for f in ("exp", "cos", "div")}
    say(f"  float64 operations (SASS): exp {ops['exp']}, cos {ops['cos']}, "
        f"division {ops['div']}")
    return ops


def _time_generator(N: int, ewald_ops: int):
    """generate_eigmodes_table(N) on the card, timed with CUDA events with
    its peak device memory; then its plane groups again with the Ewald sums
    and the eigensolve timed apart, each beside its float64 bound."""
    import torch

    from zeldovich_tpu_torch.ops import lattice

    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    a, b = ev(), ev()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a.record()
    table = lattice.generate_eigmodes_table(N)
    b.record()
    torch.cuda.synchronize()
    total, peak = a.elapsed_time(b), torch.cuda.max_memory_allocated()
    ewald = eig = 0.0
    for _, k, khat in lattice.plane_groups(N):
        e0, e1, e2 = ev(), ev(), ev()
        e0.record()
        eps = lattice.dynamical_matrix(k)
        e1.record()
        lattice.growing_mode(eps, khat)
        e2.record()
        torch.cuda.synchronize()
        ewald += e0.elapsed_time(e1)
        eig += e1.elapsed_time(e2)
    kpts = N * N * (N // 2 + 1)
    b_ewald = bound(kpts * 8 * (3 + 9), kpts * ewald_ops, "float64")
    b_eig = bound(kpts * EIG_BYTES, 0, "float64")
    b_all = bound(kpts * 8 * 4, kpts * ewald_ops, "float64")
    say(f"  N = {N} ({kpts} k-points): generator {total:.3f} ms (bound "
        f"{b_all['bound_ms']:.3f} ms, {b_all['bound_by']}; "
        f"{100 * b_all['bound_ms'] / total:.2f}%), peak {peak / 2**30:.3f} GiB; "
        f"Ewald sums {ewald:.3f} ms (bound {b_ewald['bound_ms']:.3f} ms, "
        f"{b_ewald['bound_by']}; {100 * b_ewald['bound_ms'] / ewald:.2f}%), "
        f"eigensolve {eig:.3f} ms (bound {b_eig['bound_ms']:.3f} ms, "
        f"{b_eig['bound_by']}; {100 * b_eig['bound_ms'] / eig:.2f}%), the rest "
        f"(k vectors, copies to the host) {total - ewald - eig:.3f} ms")
    return table


def _same_bytes(a, b) -> bool:
    import numpy as np

    return a.shape == b.shape and np.array_equal(a.view(np.uint64), b.view(np.uint64))


def phase_eigmodes():
    """Phase 1b: PLT eigenmode tables generated on the card, held to the
    shipped eigmodes128, timed at 128, 256 and 512, written at 512 by the
    script and run: the 512^3 PLT half step on the 512 table (kernels
    against the plain route, beside the 128-table step) and the 128^3 PLT
    CLI on the card's 128 table against the shipped one."""
    import numpy as np

    from zeldovich_tpu_torch.ops import lattice
    from zeldovich_tpu_torch.ops.plt import load_eigmodes, save_eigmodes

    say(f"== phase 1b: PLT eigenmode tables on the card, on {smi()}")
    libm = _libm_f64_ops()
    nR = len(lattice._real_space_tensor(2.0, 3.6, "cpu")[0])
    nK = len(lattice._recip_space_tensor(2.0, 4, "cpu"))
    ewald_ops = (nR * (EWALD_R_OPS + libm["cos"])
                 + nK * (EWALD_K_OPS + libm["exp"] + libm["div"]) + EWALD_OPS)
    say(f"  Ewald sums: {nR} lattice and {nK} reciprocal vectors, {ewald_ops} "
        "float64 operations a k-point")
    lattice.generate_eigmodes_table(16)  # warm-up: the libraries' handles
    tables = {N: _time_generator(N, ewald_ops) for N in EIG_N}

    shipped = load_eigmodes(ASSETS / "eigmodes128")
    eps = np.concatenate([lattice.dynamical_matrix(k).cpu().numpy()
                          for _, k, _ in lattice.plane_groups(128)])
    counts = lattice.check_table(tables[128], shipped, eps)
    say(f"  N = 128 against zeldovich_tpu/assets/eigmodes128: {counts}")
    check(_same_bytes(lattice.generate_eigmodes_table(128), tables[128]),
          "a second N = 128 table differs")
    say("  a second N = 128 table: the same bytes")

    tmp = Path(tempfile.mkdtemp(prefix="zt_eig_"))
    try:
        t512, t128 = tmp / "eigmodes512", tmp / "eigmodes128"
        run = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "torch_generate_eigmodes.py"),
             "512", str(t512)], capture_output=True, text=True, check=True)
        say("  " + run.stdout.strip().splitlines()[-1])
        check(_same_bytes(load_eigmodes(t512), tables.pop(512)),
              "the script's 512 table differs from this process's")
        say("  the script's 512 table: the same bytes as this process's")
        save_eigmodes(t128, tables.pop(128))
        _plt512_on_table(t512)
        _plt_cli_on_table(tmp, t128)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _plt512_on_table(table: Path):
    """The 512^3 PLT half step on a 512 table (the lookup's direct gather),
    kernels (B1, B2) against the plain route in float32 and float64, timed
    in turns beside the same step on the shipped 128 table."""
    import torch

    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.ops.c2r import c2r_y_plain
    from zeldovich_tpu_torch.ops.synth import halfspace_pack_zx_plain

    for dt in (F32, F64):
        m = model_for(512, True, dt=dt, ZD_PLT_filename=f'"{table}"')
        check(m.tables.eig.shape[0] == 512, "the model did not load the 512 table")
        kernels.reset_launches()
        x = m.xspace_half_pair()
        torch.cuda.synchronize()
        _check_launches("512^3 PLT on the 512 table", dict(kernels.launches), HALF)
        xp = c2r_y_plain(halfspace_pack_zx_plain(m.cfg, m.tables, m.pk_eff, m.plt_coefs),
                         512)
        compare(x, xp, tol_for(dt, ROUTE_TOL), f"512^3 PLT {TAG[dt]} step, 512 table")
        del xp
        m128 = model_for(512, True, dt=dt)
        x128 = m128.xspace_half_pair()
        say(f"  the 128 table's step differs by "
            f"{((x - x128).abs().max() / x128.abs().max()).item():.3e} * max")
        del x, x128
        t512, t128 = _turns(lambda: m.xspace_half_pair(), lambda: m128.xspace_half_pair())
        say(f"  512^3 PLT {TAG[dt]} step: {t512:.3f} ms on the 512 table, "
            f"{t128:.3f} ms on the shipped 128 table")
        del m, m128
        torch.cuda.empty_cache()


def _plt_cli_on_table(tmp: Path, table: Path):
    """The 128^3 PLT CLI in float64 (doubles out) on the card's 128 table,
    particle by particle against the run on the shipped table to 1e-10."""
    from zeldovich_tpu_torch import kernels

    runs = (("eig_shipped", {}), ("eig_card", dict(ZD_PLT_filename=f'"{table}"')))
    for name, extra in runs:
        par = _write_par(tmp, name, 128, True, dict(DOUBLES, **extra))
        say(f"-- {name}: 128^3 PLT f64 on the {'card' if extra else 'shipped'} table")
        kernels.reset_launches()
        _run_cli(par)
        _check_launches(name, dict(kernels.launches), HALF)
    _same_particles(tmp / "eig_card", tmp / "eig_shipped", 128, "the shipped table's run",
                    "RVdoubleZel", 1e-10)


def phase_kernels(dt="float32"):
    """Phases 2 and 3: B1 and B2 against their plain versions, in dt."""
    import torch

    from zeldovich_tpu_torch.ops.c2r import c2r_y, c2r_y_plain
    from zeldovich_tpu_torch.ops.synth import (
        halfspace_pack_zx, halfspace_pack_zx_plain,
    )

    errs = {}
    for ppd, plt in ((128, True), (512, False)):
        m = model_for(ppd, plt, dt=dt)
        cfg, tables, pk, coefs = m.cfg, m.tables, m.pk_eff, m.plt_coefs
        tag = f"{ppd}^3 {'PLT' if plt else 'plain'} {TAG[dt]}"
        b1_tol, b2_tol = tol_for(dt, B1_TOL), tol_for(dt, B2_TOL)
        say(f"== phase 2: B1 vs plain, {tag}")
        k = counted("halfspace_pack_zx",
                    lambda: halfspace_pack_zx(cfg, tables, pk, coefs))
        p = halfspace_pack_zx_plain(cfg, tables, pk, coefs)
        check(k.shape == p.shape, f"B1 shape {k.shape} != {p.shape}")
        errs[("b1", ppd)] = compare(k, p, b1_tol, f"B1 {tag} {tuple(k.shape)}")
        del p
        say(f"== phase 3: B2 vs plain, {tag}")
        xp = c2r_y_plain(k, ppd)
        xk = counted("c2r_y", lambda: c2r_y(k, ppd))
        errs[("b2", ppd)] = compare(xk, xp, b2_tol, f"B2 {tag} {tuple(xk.shape)}")
        del xk
        xk = counted("c2r_y", lambda: c2r_y(k, ppd, out=k))
        check(xk.data_ptr() == k.data_ptr(), "B2 in place returned another buffer")
        compare(xk, xp, b2_tol, f"B2 {tag} in place")
        del k, xk, xp, m
        torch.cuda.empty_cache()
    small_b1(dt)
    small_b2(dt)
    return errs


def small_b1(dt="float32"):
    """Phase 2's small cases: B1 on a few generated planes at every n."""
    import torch

    from zeldovich_tpu_torch.ops.modes_real import pk_effective, plt_coef_fields
    from zeldovich_tpu_torch.ops.synth import (
        halfspace_pack_zx, halfspace_pack_zx_plain,
    )

    for n in SMALL_N:
        half = n // 2
        r = min(half, 8, max(2, (1 << 24) // (n * n)))
        spans = [(0, r)] + ([(half - r, half)] if r < half else [])
        for name, plt, extra in B1_CONFIGS:
            m = model_for(n, plt, dt=dt, **extra)
            for y0, y1 in spans:
                pk = pk_effective(m.cfg, m.tables, m.dtype, (y0, y1))
                coefs = (plt_coef_fields(m.cfg, m.tables, m.dtype, (y0, y1))
                         if plt else None)
                a = (m.cfg, m.tables, pk, coefs, y0)
                k = counted("halfspace_pack_zx", lambda: halfspace_pack_zx(*a))
                p = halfspace_pack_zx_plain(*a)
                check(k.shape == p.shape, f"B1 shape {k.shape} != {p.shape}")
                compare(k, p, tol_for(dt, B1_TOL),
                        f"B1 {TAG[dt]} n={n} {name} planes [{y0}, {y1})")
                del k, p, pk, coefs, a
            del m
            torch.cuda.empty_cache()


def small_b2(dt="float32"):
    """Phase 3's small cases: B2 on (2, 2, 2, ky, 3, 20) at every n, with
    and without the Nyquist row, out of place, into a given buffer and
    in place; float64 also on (2, 2, 2, ky, 3, 7), an odd Bz * X."""
    import torch

    from zeldovich_tpu_torch.ops.c2r import c2r_y, c2r_y_plain

    gen = torch.Generator(device="cuda").manual_seed(5)
    dtype, tol = getattr(torch, dt), tol_for(dt, B2_TOL)
    for n in SMALL_N:
        if dt == "float64":
            spm = torch.randn((2, 2, 2, n // 2, 3, 7), device="cuda", generator=gen,
                              dtype=dtype)
            compare(counted("c2r_y", lambda: c2r_y(spm, n)), c2r_y_plain(spm, n), tol,
                    f"B2 f64 n={n} on an odd Bz * X")
        for nyq in (True, False):
            spm = torch.randn((2, 2, 2, n // 2 + nyq, 3, 20), device="cuda", generator=gen,
                              dtype=dtype)
            p = c2r_y_plain(spm, n)
            tag = f"B2 {TAG[dt]} n={n} {'with' if nyq else 'without'} the Nyquist row"
            compare(counted("c2r_y", lambda: c2r_y(spm, n)), p, tol, tag)
            if nyq:
                out = torch.empty(p.shape, device="cuda", dtype=dtype)
                check(counted("c2r_y", lambda: c2r_y(spm, n, out=out)) is out,
                      "B2 into out returned another tensor")
                compare(out, p, tol, f"{tag} into out")
            else:
                g = spm.clone()
                x = counted("c2r_y", lambda: c2r_y(g, n, out=g))
                check(x.data_ptr() == g.data_ptr(), "B2 in place returned another buffer")
                compare(x, p, tol, f"{tag} in place")
            del spm, p


def _b4_bound(tables, pk, live=None):
    return bound(3 * nbytes(pk) + nbytes(live, tables.planes64, tables.mzx64,
                                         tables.czx64), 0, _dt_of(pk), draws=pk.numel())


def _dt_of(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _b4_compare(k, p, what):
    err, tol = 0.0, tol_for(_dt_of(p[0]), B4_TOL)
    for j, part in enumerate(("re", "im")):
        _same_zeros(k[j], p[j], f"{what} D_{part}")
        err = max(err, compare(k[j], p[j], tol, f"{what} D_{part} {tuple(k[j].shape)}"))
    return err


def small_b4(dt="float32"):
    """B4 on a few generated planes at every n: one plane, a full y tile
    plus a ragged end (or all but one plane where the half space is no
    deeper than a tile), at both ends of the half space, with and without
    a live mask, fixed power both ways."""
    import torch

    from zeldovich_tpu_torch.ops.boxmuller import (
        halfspace_boxmuller, halfspace_boxmuller_plain,
    )
    from zeldovich_tpu_torch.ops.modes_real import pk_effective

    from zeldovich_tpu_torch import kernels

    # the y planes a block of B4 walks, from the kernel's source
    tile = int(re.search(r"constexpr int B4_TY = (\d+);",
                         (kernels.CSRC / "boxmuller.cu").read_text()).group(1))
    gen = torch.Generator(device="cuda").manual_seed(44)
    for n in SMALL_N:
        half = n // 2
        r = min(tile + 3, half - 1)
        m = model_for(n, False, dt=dt)
        for rows, ky0, with_live in ((1, 0, False), (r, 0, True), (r, half - r, False)):
            pk = pk_effective(m.cfg, m.tables, m.dtype, (ky0, ky0 + rows))
            live = ((torch.rand(pk.shape, device="cuda", generator=gen) > 0.2).to(m.dtype)
                    if with_live else None)
            for fixed in (False, True):
                a = (m.tables, pk, fixed, live, ky0)
                k = counted("halfspace_boxmuller", lambda: halfspace_boxmuller(*a))
                _b4_compare(k, halfspace_boxmuller_plain(*a),
                            f"B4 {TAG[dt]} n={n} planes [{ky0}, {ky0 + rows}) fixed_power={fixed}"
                            + (" live" if with_live else ""))
                del k, a
            del pk, live
        del m
        torch.cuda.empty_cache()


def phase_b4(dt="float32"):
    """Phase 4's B4 part in dt; returns its error and times at 512^3 and
    the 1024^3 readings."""
    import torch

    from zeldovich_tpu_torch.ops.boxmuller import (
        halfspace_boxmuller, halfspace_boxmuller_plain,
    )

    f = TAG[dt]
    say(f"== phase 4: B4 vs plain, 512^3 {f}")
    m = model_for(512, False, dt=dt)
    gen = torch.Generator(device="cuda").manual_seed(4)
    live = (torch.rand(m.pk_eff.shape, device="cuda", generator=gen) > 0.2).to(m.dtype)
    err = 0.0
    for fixed in (False, True):
        for mask in (None, live):
            a = (m.tables, m.pk_eff, fixed, mask)
            k = counted("halfspace_boxmuller", lambda: halfspace_boxmuller(*a))
            e = _b4_compare(k, halfspace_boxmuller_plain(*a),
                            f"B4 {f} fixed_power={fixed}" + ("" if mask is None else " live"))
            if not fixed and mask is None:
                err = e
            del k
    del live
    a = (m.tables, m.pk_eff, False)
    t = _turns(lambda: halfspace_boxmuller(*a), lambda: halfspace_boxmuller_plain(*a))
    b = _b4_bound(m.tables, m.pk_eff)
    fixed_ms = _time(lambda: halfspace_boxmuller(m.tables, m.pk_eff, True))
    say(f"  B4 512^3 {f}: kernel {t[0]:.3f} ms (fixed power {fixed_ms:.3f} ms), plain "
        f"{t[1]:.3f} ms; bound {b['bound_ms']:.3f} ms ({b['bound_by']}), "
        f"{100 * b['bound_ms'] / t[0]:.1f}% of it")
    del m, a
    torch.cuda.empty_cache()

    say(f"== phase 4: B4 at 1024^3 {f}, the first and last 4 planes vs plain")
    m = model_for(1024, False, dt=dt)
    more = {}
    for fixed in (False, True):
        k = counted("halfspace_boxmuller",
                    lambda: halfspace_boxmuller(m.tables, m.pk_eff, fixed))
        for ky0 in (0, 508):
            span = slice(ky0, ky0 + 4)
            p = halfspace_boxmuller_plain(m.tables, m.pk_eff[span], fixed, None, ky0)
            _b4_compare(tuple(d[span] for d in k), p,
                        f"B4 {f} 1024^3 planes [{ky0}, {ky0 + 4}) fixed_power={fixed}")
        check(all(bool(torch.isfinite(d).all()) for d in k), "B4 1024^3: non-finite D")
        del k, p
        ms = sorted(_time(lambda: halfspace_boxmuller(m.tables, m.pk_eff, fixed))
                    for _ in range(3))[1]
        more["ms_1024_fixed" if fixed else "ms_1024"] = ms
    b1024 = _b4_bound(m.tables, m.pk_eff)
    more["bound_ms_1024"] = b1024["bound_ms"]
    say(f"  B4 1024^3 {f}: kernel {more['ms_1024']:.3f} ms (fixed power "
        f"{more['ms_1024_fixed']:.3f} ms); bound {b1024['bound_ms']:.3f} ms "
        f"({b1024['bound_by']}), {100 * b1024['bound_ms'] / more['ms_1024']:.1f}% of it")
    del m
    torch.cuda.empty_cache()
    say(f"== phase 4: B4 {f} small cases at every n")
    small_b4(dt)
    return err, (*t, None, b), {"ms_fixed": fixed_ms, **more}


def phase_fullgrid_kernels(dt="float32"):
    """Phase 4: B4, zx and y against their plain versions, in dt; returns
    the errors, the kernel/plain ms at 512^3 and B4's other readings."""
    import torch

    from zeldovich_tpu_torch.ops.fft import y_dft, y_dft_plain, zx_dft, zx_dft_plain

    errs, times = {}, {}
    errs["b4"], times["b4"], b4_more = phase_b4(dt)
    f, dtype, tol = TAG[dt], getattr(torch, dt), tol_for(dt, DFT_TOL)

    from zeldovich_tpu_torch.ops.synth import twiddles

    gen = torch.Generator(device="cuda").manual_seed(2024)

    def placed(shape, off):
        """Random data of `shape`, starting `off` elements into a buffer."""
        buf = torch.randn(math.prod(shape) + off, device="cuda", generator=gen,
                          dtype=dtype)
        return buf[off:].view(shape)

    # float64: one element off a 16-byte boundary, and odd Bz * X
    small = list(SMALL) if dt == "float32" else (
        [(k, s, min(off, 1)) for k, s, off in SMALL] + list(SMALL_F64))
    cases = ([("zx", s, 0) for s in ZX_SHAPES] + [("y", s, 0) for s in Y_SHAPES]
             + small)
    fns = {"zx": (zx_dft, zx_dft_plain, (-2, -1)), "y": (y_dft, y_dft_plain, (-3,))}
    for name, shape, off in cases:
        fn, plain, dims = fns[name]
        say(f"== phase 4: {name}_dft {f} vs plain, {shape}"
            + (f", {off} elements off" if off else ""))
        x = placed(shape, off)
        out = torch.empty_like(x)
        for sign in (+1, -1):
            p = plain(x, sign)
            k = counted(f"{name}_dft", lambda: fn(x, sign, out=out))
            err = compare(k, p, tol, f"{name}_dft sign {sign:+d}")
            inplace = placed(shape, off)
            inplace.copy_(x)
            check(counted(f"{name}_dft", lambda: fn(inplace, sign, inplace)) is inplace,
                  "in-place call returned another tensor")
            err = max(err, compare(inplace, p, tol, f"{name}_dft sign {sign:+d} in place"))
            if shape == (2, 2, 512, 512, 512):
                errs[name] = max(errs.get(name, 0.0), err)
            del k, p, inplace
        if (name, shape, off) in small:
            continue
        c = torch.complex(x[:, 0], x[:, 1])  # the library call's operand, once
        n = shape[-1] if name == "zx" else shape[2]
        t = _turns(lambda: fn(x, +1, out=out), lambda: plain(x, +1, out=out),
                   library=lambda: torch.fft.ifftn(c, dim=dims, norm="forward"))
        b = bound(2 * nbytes(x) + nbytes(twiddles(n, x.device, +1, dtype)),
                  fft_ops(x.numel() // 2, n) * len(dims), dt)
        say(f"  {name}_dft {shape} {f}: kernel {t[0]:.3f} ms, plain {t[1]:.3f} ms, "
            f"library {t[2]:.3f} ms; bound {b['bound_ms']:.3f} ms ({b['bound_by']}), "
            f"{100 * b['bound_ms'] / t[0]:.1f}% of it")
        if shape == (2, 2, 512, 512, 512):
            times[name] = (*t, b)
        del x, out, c
        torch.cuda.empty_cache()
    return errs, times, b4_more


def _time(fn, reps=5):
    """ms a call of fn: `reps` calls between two CUDA events."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
        del out
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _turns(kernel_fn, plain_fn, rounds=2, library=None, reps=5):
    """Medians over rounds of plain, kernel, kernel, plain (after warm-up),
    and of the library call's where one is given (then a third entry)."""
    import statistics

    kernel_fn(), plain_fn()
    ks, ps, ls = [], [], []
    for _ in range(rounds):
        ps.append(_time(plain_fn, reps))
        ks.append(_time(kernel_fn, reps))
        ks.append(_time(kernel_fn, reps))
        ps.append(_time(plain_fn, reps))
        if library is not None:
            ls.append(_time(library, reps))
    out = statistics.median(ks), statistics.median(ps)
    return out if library is None else (*out, statistics.median(ls))


def _peak(step, ppd, what, reps=5):
    """Median ms of 3 kernel-route steps and the peak device memory."""
    import torch

    _time(step, reps)  # warm-up
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = sorted(_time(step, reps) for _ in range(3))[1]
    peak = torch.cuda.max_memory_allocated()
    say(f"  {what}: kernel {ms:.3f} ms ({ppd**3 / ms / 1e3:.1f} Mpart/s), peak "
        f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB of setup fields)")
    return ms, peak


def phase_timing(dt="float32"):
    import torch

    from zeldovich_tpu_torch.ops.c2r import c2r_y, c2r_y_plain
    from zeldovich_tpu_torch.ops.synth import (
        halfspace_pack_zx, halfspace_pack_zx_plain,
    )

    f, dtype = TAG[dt], getattr(torch, dt)
    say(f"== phase 5: half-spectrum forward step timing, {f}, on {smi()}")
    per_kernel = {}
    for ppd, plt in ((512, False), (512, True)):
        m = model_for(ppd, plt, dt=dt)
        a = (m.cfg, m.tables, m.pk_eff, m.plt_coefs)
        g = halfspace_pack_zx(*a)
        buf = torch.empty((g.shape[0], 2, ppd, ppd, ppd), device="cuda", dtype=dtype)
        b1 = _turns(lambda: halfspace_pack_zx(*a), lambda: halfspace_pack_zx_plain(*a))
        b2 = _turns(lambda: c2r_y(g, ppd, out=buf), lambda: c2r_y_plain(g, ppd))
        del buf
        step = _turns(lambda: m.xspace_half_pair(),
                      lambda: c2r_y_plain(halfspace_pack_zx_plain(*a), ppd))
        tag = f"{ppd}^3 {'PLT' if plt else 'plain'} {f}"
        for name, (k, p) in (("B1", b1), ("B2", b2), ("step", step)):
            say(f"  {tag} {name}: kernel {k:.3f} ms, plain {p:.3f} ms"
                + (f"; {ppd**3 / k / 1e3:.1f} vs {ppd**3 / p / 1e3:.1f} Mpart/s"
                   if name == "step" else ""))
        if not plt:
            tb, half = m.tables, ppd // 2
            b1b = bound(nbytes(m.pk_eff, tb.planes64, tb.mzx64, tb.czx64, g),
                        2 * fft_ops(g.numel() // 2, ppd), dt, draws=half * ppd * ppd)
            b2b = bound(2 * nbytes(g), fft_ops(g.numel() // 2, ppd), dt)
            say(f"  {tag} B1 bound {b1b['bound_ms']:.3f} ms ({b1b['bound_by']}), "
                f"{100 * b1b['bound_ms'] / b1[0]:.1f}% of it; three-pass design floor "
                f"{1e3 * 3 * nbytes(g) / HBM_BPS:.3f} ms")
            say(f"  {tag} B2 bound {b2b['bound_ms']:.3f} ms ({b2b['bound_by']}), "
                f"{100 * b2b['bound_ms'] / b2[0]:.1f}% of it")
            # the library call: one irfft of the two packed fields along y
            c = torch.complex(g[:, :, 0], g[:, :, 1])
            lib = _time(lambda: torch.fft.irfft(c, n=ppd, dim=-3, norm="forward"))
            say(f"  {tag} B2 library call (torch.fft.irfft): {lib:.3f} ms")
            per_kernel = {"b1": (*b1, None, b1b), "b2": (*b2, lib, b2b)}
            del c
        del g, m, a
        torch.cuda.empty_cache()

    m = model_for(1024, False, dt=dt)
    a = (m.cfg, m.tables, m.pk_eff, m.plt_coefs)
    b1 = sorted(_time(lambda: halfspace_pack_zx(*a), reps=2) for _ in range(3))[1]
    g = halfspace_pack_zx(*a)
    buf = torch.empty((g.shape[0], 2, 1024, 1024, 1024), device="cuda", dtype=dtype)
    b2 = sorted(_time(lambda: c2r_y(g, 1024, out=buf), reps=2) for _ in range(3))[1]
    say(f"  1024^3 plain {f}: B1 {b1:.3f} ms, B2 {b2:.3f} ms (kernel route)")
    del g, buf
    torch.cuda.empty_cache()
    _peak(lambda: m.xspace_half_pair(), 1024, f"1024^3 plain {f} step, B2 in place")
    del m, a
    torch.cuda.empty_cache()
    return per_kernel


def _profile(step, what):
    """Device time by kernel over one step (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = []  # the device's own entries (kernels, copies), not the ops
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    say(f"  {what} profile: {total:.3f} ms of device time in {len(rows)} kernels")
    for ms, count, key in rows[:12]:
        say(f"    {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  x{count:<5d} {key[:90]}")


def phase_fullgrid_timing(dt="float32"):
    """Phase 6 in dt; float64 times the f_NL configuration alone."""
    import torch

    f = TAG[dt]
    say(f"== phase 6: full-grid forward step timing, {f}, on {smi()}")
    configs = (("f_NL", False, FNL), ("f_NL PLT", True, FNL),
               ("CornerModes k_cutoff=2", False, CORNER))
    for tag, plt, extra in configs[:1 if dt == "float64" else None]:
        m = model_for(512, plt, dt=dt, **extra)
        _ = (m.pk_eff, m.plt_coefs)
        k, p = _turns(lambda: m.xspace_pair(), lambda: m.xspace_pair(plain=True))
        say(f"  512^3 {tag} {f} step: kernel {k:.3f} ms, plain {p:.3f} ms; "
            f"{512**3 / k / 1e3:.1f} vs {512**3 / p / 1e3:.1f} Mpart/s")
        if tag == "f_NL":
            _profile(lambda: m.xspace_pair(), f"512^3 f_NL {f} kernel route")
            _peak(lambda: m.xspace_pair(), 512, f"512^3 f_NL {f} step")
        del m
        torch.cuda.empty_cache()

    m = model_for(1024, False, dt=dt, **FNL)
    _ = m.pk_eff
    _peak(lambda: m.xspace_pair(), 1024, f"1024^3 f_NL {f} step")
    del m
    torch.cuda.empty_cache()


def _same_zeros(k, p, what):
    """Exactly the same zero entries (the zero rules, the hard zeros)."""
    import torch

    check(torch.equal(k == 0, p == 0), f"{what}: zero pattern differs")


def phase_b5(dt="float32"):
    """Phase 7: B5 against its plain version on the slab synthesis' chunks."""
    import torch

    from zeldovich_tpu_torch.ops.boxmuller import boxmuller, boxmuller_plain
    from zeldovich_tpu_torch.ops.modes_real import (
        draw_operands, slab_chunk, slab_modes, synthesize_pair,
    )

    f, dtype, tol = TAG[dt], getattr(torch, dt), tol_for(dt, B5_TOL)
    say(f"== phase 7: B5 vs plain, 512^3 y-slabs of 64 rows, {f}")
    m = model_for(512, False, dt=dt)
    check(slab_chunk(128, 512) == 64, "the slab chunk is not 64 rows at 512^3")
    err, times = 0.0, {}
    for y0, where in ((0, "generated half"), (224, "across ppd/2"),
                      (448, "mirror half")):
        ops = draw_operands(slab_modes(y0, y0 + 64, 512, "cuda"), m.cfg,
                            m.tables, dtype)
        for fixed in (False, True):
            k = counted("boxmuller", lambda: boxmuller(m.tables, *ops, fixed))
            p = boxmuller_plain(m.tables, *ops, fixed)
            for j, part in enumerate(("re", "im")):
                what = f"B5 {f} y0={y0} ({where}) fixed_power={fixed} D_{part}"
                _same_zeros(k[j], p[j], what)
                e = compare(k[j], p[j], tol, f"{what} {tuple(k[j].shape)}")
                err = max(err, e)
            del k, p
        times[y0] = _turns(lambda: boxmuller(m.tables, *ops, False),
                           lambda: boxmuller_plain(m.tables, *ops, False))
        tb = m.tables
        times[y0] = (*times[y0], None, bound(
            nbytes(*ops, tb.planes64, tb.mzx64, tb.czx64) + 2 * nbytes(ops[3]),
            0, dt, draws=ops[0].numel()))
        say(f"  B5 y0={y0} ({where}) 16.8M modes {f}: kernel "
            f"{times[y0][0]:.3f} ms, plain {times[y0][1]:.3f} ms")
        del ops
    del m
    torch.cuda.empty_cache()
    mf = model_for(512, False, dt=dt, **FNL)
    for y0 in (224, 448):
        a = (y0, 64, mf.cfg, mf.tables, dtype)
        k = counted("boxmuller", lambda: synthesize_pair(*a, gen_phi=True))
        p = synthesize_pair(*a, gen_phi=True, plain=True)
        _same_zeros(k, p, f"gen_phi slab y0={y0}")
        compare(k, p, tol, f"f_NL gen_phi slab {f} y0={y0} {tuple(k.shape)}")
        del k, p
    del mf
    torch.cuda.empty_cache()
    return err, times[0]


def phase_b3(dt="float32"):
    """Phase 8: B3 against its plain version; the separate-kernel half
    route against the fused one."""
    import torch

    from zeldovich_tpu_torch.ops.modes_real import pack_half_raw
    from zeldovich_tpu_torch.ops.synth import halfspace_pack

    err, ms, dtype = 0.0, None, getattr(torch, dt)
    for ppd, plt in ((512, False), (128, True)):
        tag = f"{ppd}^3 {'PLT' if plt else 'plain'} {TAG[dt]}"
        say(f"== phase 8: B3 vs plain, {tag}")
        m = model_for(ppd, plt, dt=dt)
        a = (m.cfg, m.tables, m.pk_eff, m.plt_coefs)
        k = counted("halfspace_pack", lambda: halfspace_pack(*a))
        p = pack_half_raw(m.cfg, m.tables, dtype, m.pk_eff, m.plt_coefs)
        check(k.shape == p.shape, f"B3 shape {k.shape} != {p.shape}")
        _same_zeros(k, p, f"B3 {tag}")
        e = compare(k, p, tol_for(dt, B3_TOL), f"B3 {tag} {tuple(k.shape)}")
        del k, p
        if ppd != 512:
            continue
        err = e
        ms = _turns(lambda: halfspace_pack(*a),
                    lambda: pack_half_raw(m.cfg, m.tables, dtype,
                                          m.pk_eff, m.plt_coefs))
        tb, half = m.tables, ppd // 2
        ms = (*ms, None, bound(
            nbytes(m.pk_eff, tb.planes64, tb.mzx64, tb.czx64)
            + m.cfg.narray * 4 * (half + 1) * ppd * ppd * m.pk_eff.element_size(),
            0, dt, draws=half * ppd * ppd))
        say(f"  B3 {tag}: kernel {ms[0]:.3f} ms, plain {ms[1]:.3f} ms")
        sep = m.xspace_half_pair(m.kspace_half_pair())
        fused = m.xspace_half_pair()
        compare(sep, fused, tol_for(dt, ROUTE_TOL),
                f"separate (B3, zx, B2) vs fused (B1, B2) {tag}")
        del sep, fused
        t = _turns(lambda: m.xspace_half_pair(m.kspace_half_pair()),
                   lambda: m.xspace_half_pair())
        say(f"  {tag} half step: separate route {t[0]:.3f} ms, fused route "
            f"{t[1]:.3f} ms")
        del m, a
        torch.cuda.empty_cache()
    return err, ms


def _host_space(path) -> tuple[int, int]:
    """(available host RAM, free bytes of path's file system)."""
    import os

    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
    return ram, shutil.disk_usage(path).free


def _pass1_at(ppd: int, tmp: Path, backing: str):
    """stage_pass1 of ppd^3 plain f32 with 2048 MB slabs: prints the wall,
    the device work of a slab, its share and the peak device memory;
    returns (model, stage)."""
    import statistics

    import torch

    from zeldovich_tpu_torch.models.outofcore import OutOfCoreZeldovich
    from zeldovich_tpu_torch.models.pipeline import Parameters

    (tmp / "m.par").write_text(par_text(ppd, tmp / "ic", False))
    with contextlib.redirect_stderr(io.StringIO()):
        m = OutOfCoreZeldovich(Parameters.from_file(tmp / "m.par"),
                               dtype=torch.float32, slab_bytes=2048 << 20,
                               backing=backing, device="cuda")
    nslab = ppd // m.slab
    _time(lambda: m._pass1_slab(0))  # warm-up
    slab_ms = statistics.median(_time(lambda: m._pass1_slab(y0))
                                for y0 in (0, nslab // 2 * m.slab, ppd - m.slab))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stage = m.stage_pass1()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    say(f"  {ppd}^3 plain f32 stage_pass1 ({backing} stage): {wall:.3f} s for "
        f"{nslab} slabs of {m.slab} rows; device work {slab_ms:.3f} ms a slab "
        f"(CUDA events, median of 3), {100 * nslab * slab_ms / 1e3 / wall:.1f}% "
        f"of the wall; peak device memory {peak / 2**30:.2f} GiB "
        f"({base / 2**30:.2f} GiB of setup tables)")
    # again into the same stage, its pages now mapped: the difference is
    # the first touch of a fresh stage
    t0 = time.perf_counter()
    m.stage_pass1(stage=stage)
    say(f"  {ppd}^3 stage_pass1 again into the same stage: "
        f"{time.perf_counter() - t0:.3f} s")
    return m, stage


def _pass2_at(m, stage):
    """Pass 2 of a staged plain grid, timed in parts: run()'s loop without
    the writer (strided host gather into pinned memory, H2D, y_dft, D2H,
    one slab ahead), one z-slab's parts apart, and the writer on that
    z-slab."""
    import numpy as np
    import torch

    from zeldovich_tpu_torch.models.outofcore import (
        AsyncSlabWriter, _flush_chunk, _zsel,
    )
    from zeldovich_tpu_torch.models.pipeline import OutputWriter, setup_output_dir
    from zeldovich_tpu_torch.ops.fft import y_dft
    from zeldovich_tpu_torch.utils.streamio import slabs_to_device, stream_to_host

    ppd, nz = m.param.ppd, m.slab
    keys = [_zsel(z0, nz) for z0 in range(0, ppd, nz)]
    finite = []
    t0 = time.perf_counter()
    stream_to_host(((sel, y_dft(z, +1, out=z)) for sel, z in slabs_to_device(
        keys, stage.__getitem__, "cuda")),
        lambda sel, h: finite.append(bool(np.isfinite(h[:, :, ::97, :, ::97]).all())))
    wall = time.perf_counter() - t0
    check(len(finite) == len(keys) and all(finite), "pass 2: non-finite z-slab")

    src = stage[keys[0]]
    pinned = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
    t0 = time.perf_counter()
    np.copyto(pinned.numpy(), src)
    gather = 1e3 * (time.perf_counter() - t0)
    dev = torch.empty(src.shape, dtype=torch.float32, device="cuda")
    h2d = _time(lambda: dev.copy_(pinned, non_blocking=True))
    y = _time(lambda: y_dft(dev, +1, out=dev), reps=1)
    d2h = _time(lambda: pinned.copy_(dev, non_blocking=True))
    setup_output_dir(m.param)
    aw = AsyncSlabWriter(OutputWriter(m.param))
    t0 = time.perf_counter()
    try:
        _flush_chunk(aw, 0, pinned.numpy(), pair=True)
    finally:
        aw.close()
    write = time.perf_counter() - t0
    gb, ic_gb = pinned.nbytes / 1e9, nz * ppd * ppd * 32 / 1e9
    say(f"  {ppd}^3 pass 2 without the writer: {wall:.3f} s for {len(keys)} "
        f"z-slabs of {nz} planes ({len(keys) * gb / wall:.1f} GB/s of stage)")
    say(f"  one {gb:.2f} GB z-slab: strided host gather {gather:.3f} ms "
        f"({gb / gather * 1e3:.1f} GB/s), H2D {h2d:.3f} ms ({gb / h2d * 1e3:.1f} "
        f"GB/s), y_dft {y:.3f} ms, D2H {d2h:.3f} ms ({gb / d2h * 1e3:.1f} GB/s); "
        f"the writer on it {write:.3f} s ({ic_gb:.2f} GB of ic_*, "
        f"{ic_gb / write:.2f} GB/s)")
    del pinned, dev


def phase_outofcore():
    """Phase 9: out of core at 1024^3 and 2048^3."""
    import numpy as np
    import torch

    from zeldovich_tpu_torch.ops.fft import y_dft, y_dft_plain, zx_dft, zx_dft_plain
    from zeldovich_tpu_torch.ops.modes_real import synthesize_pair

    say(f"== phase 9: out of core at size on {smi()}")
    for cmd in (["free", "-g"], ["df", "-BG", tempfile.gettempdir()]):
        out = subprocess.run(cmd, capture_output=True, text=True)
        for line in out.stdout.splitlines():
            say(f"  {cmd[0]}: {line}")
    tmp = Path(tempfile.mkdtemp(prefix="zt_ooc_"))
    try:
        for ppd in (1024, 2048):
            need = 2 * 2 * ppd**3 * 4
            ram, disk = _host_space(tmp)
            # RAM when it holds the stage beside the pinned buffers
            backing = ("ram" if ram > need + (16 << 30) else
                       "disk" if disk > need + (8 << 30) else None)
            say(f"  {ppd}^3: stage {need / 1e9:.1f} GB; host RAM available "
                f"{ram / 1e9:.1f} GB, {tmp} free {disk / 1e9:.1f} GB: "
                + (f"{backing} stage" if backing else "not run, neither holds it"))
            if backing is None:
                continue
            m, stage = _pass1_at(ppd, tmp, backing)
            check(bool(np.isfinite(stage[:, :, ::m.slab - 1]).all()),
                  f"{ppd}^3: non-finite stage")
            if ppd == 1024:
                # one slab's host side: D2H into pinned memory, then the
                # copy into the stage; and the stage holds the device's slab
                y0 = ppd // m.slab // 2 * m.slab  # the slab holding ppd/2
                k = m._pass1_slab(y0)
                pinned = torch.empty(k.shape, dtype=k.dtype, pin_memory=True)
                d2h = _time(lambda: pinned.copy_(k, non_blocking=True))
                t0 = time.perf_counter()
                stage[:, :, y0:y0 + m.slab] = pinned.numpy()
                host_ms = 1e3 * (time.perf_counter() - t0)
                say(f"  one {k.nbytes / 1e9:.2f} GB slab: D2H {d2h:.3f} ms "
                    f"({k.nbytes / d2h / 1e6:.1f} GB/s), host copy into the "
                    f"stage {host_ms:.3f} ms ({k.nbytes / host_ms / 1e6:.1f} GB/s)")
                check(torch.equal(torch.from_numpy(np.asarray(
                    stage[:, :, y0:y0 + m.slab])), k.cpu()),
                    "the staged slab differs from the device's")
                del k, pinned
                _pass2_at(m, stage)
            del m, stage
            shutil.rmtree(tmp / "ic", ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    m2 = model_for(2048, False)
    cfg, tables = m2.cfg, m2.tables
    kernel = lambda: zx_dft(synthesize_pair(0, 32, cfg, tables, torch.float32), +1)
    plain = lambda: zx_dft_plain(
        synthesize_pair(0, 32, cfg, tables, torch.float32, plain=True), +1)
    compare(kernel(), plain(), ROUTE_TOL, "2048^3 pass-1 y-slab (2, 2, 32, 2048, 2048)")
    t = _turns(kernel, plain, rounds=1)
    say(f"  2048^3 pass-1 y-slab, B5 + fields + zx: kernel route {t[0]:.3f} ms, "
        f"plain route {t[1]:.3f} ms")
    del m2, cfg, tables
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(2048)
    z = torch.randn((2, 2, 2048, 32, 2048), device="cuda", generator=gen)
    compare(counted("y_dft", lambda: y_dft(z, +1)), y_dft_plain(z, +1), DFT_TOL,
            "2048^3 pass-2 z-slab y_dft (2, 2, 2048, 32, 2048)")
    t = _turns(lambda: y_dft(z, +1), lambda: y_dft_plain(z, +1), rounds=1)
    say(f"  2048^3 pass-2 z-slab y_dft: kernel {t[0]:.3f} ms, plain {t[1]:.3f} ms")
    del z
    torch.cuda.empty_cache()


def _run_cli(par: Path, *flags) -> dict | None:
    """cli.main on a .par; returns the parsed QA statistics (None for a
    --part 1 run, which writes no particles)."""
    from zeldovich_tpu_torch import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main([str(par), *flags])
    text = err.getvalue()
    for line in text.splitlines():
        if any(w in line for w in ("took", "rms", "displacements", "resident",
                                   "Checkpoint")) \
                or re.match(r"\s*(Model|Mode|Inverse|Output|Out-of-core|Writing|Loading)",
                            line):
            say("  " + line.strip())
    check(rc == 0, f"cli exited {rc}:\n{text}")
    if "--part" in flags and flags[flags.index("--part") + 1] == "1":
        return None
    rms = float(re.search(r"pixels is (\S+)", text).group(1))
    disp = re.search(r"displacements are \((\S+), (\S+), (\S+)\)", text)
    # a density-only run (ZD_qdensity = 2) reports no displacement
    qa = {"rms": rms, "max_disp": [float(v) for v in disp.groups()] if disp else []}
    check(all(math.isfinite(v) for v in [rms, *qa["max_disp"]]), f"QA {qa}")
    return qa


def _ic_files(d: Path, ppd: int, cpd: int, fmt="RVZel"):
    """The ic_* files: one per slab file index z*cpd//ppd, a particle the
    bytes of its format (RVZel floats, RVdoubleZel doubles)."""
    from zeldovich_tpu_torch.models.pipeline import output_dtype

    files = sorted(d.glob("ic_*"))
    total = sum(f.stat().st_size for f in files)
    nfiles = len({z * cpd // ppd for z in range(ppd)})
    want = ppd**3 * output_dtype(fmt).itemsize
    say(f"  {len(files)} ic_* files, {total} bytes")
    check(len(files) == nfiles, f"wrote {len(files)} files, want {nfiles}")
    check(total == want, f"wrote {total} bytes, want {want}")
    return files


def _against_plain(tmp: Path, name: str, par: Path, x_plain, fmt="RVZel",
                   tol=PARTICLE_TOL, ppd=128):
    """Every particle of run `name` against x_plain through the same writer."""
    from zeldovich_tpu_torch.models.pipeline import OutputWriter, Parameters
    from zeldovich_tpu_torch.utils.streamio import stream_xspace

    say(f"-- {name} through the plain route, particle by particle")
    param = Parameters.from_file(par)
    param.output_dir = str(tmp / f"{name}_plain")
    (tmp / f"{name}_plain").mkdir()
    writer = OutputWriter(param)
    with contextlib.redirect_stderr(io.StringIO()):
        stream_xspace(x_plain, writer)
    _same_particles(tmp / name, tmp / f"{name}_plain", ppd, "plain", fmt, tol)


def _same_particles(got_dir: Path, want_dir: Path, ppd: int, what: str, fmt="RVZel",
                    tol=PARTICLE_TOL):
    """Every ic_* particle of got_dir against want_dir's: indices exact,
    displacements and velocities to tol of the scale (PARTICLE_TOL;
    float64 runs, their doubles to F64_TOL)."""
    import numpy as np

    from zeldovich_tpu_torch.models.pipeline import output_dtype

    dtype = output_dtype(fmt)
    files = _ic_files(got_dir, ppd, cpd_for(ppd), fmt)
    worst = {"displ": 0.0, "vel": 0.0}
    for f in files:
        # the writer's RVZel record layout, as read_particles reads it
        got = np.fromfile(f, dtype=dtype)
        want = np.fromfile(want_dir / f.name, dtype=dtype)
        for c in ("i", "j", "k"):
            check(np.array_equal(got[c], want[c]), f"{f.name} {c} differs")
        for c in ("displ", "vel"):
            scale = float(np.abs(want[c]).max())
            err = float(np.abs(got[c] - want[c]).max())
            worst[c] = max(worst[c], err / scale)
    say(f"  worst |run - {what}| / max: displ {worst['displ']:.3e}, "
        f"vel {worst['vel']:.3e} (tol {tol:g})")
    check(max(worst.values()) <= tol, f"{got_dir.name}: particles differ")


HALF = ("halfspace_pack_zx", "c2r_y")
TRANSFORMS = ("zx_dft", "y_dft")
FULL = ("halfspace_boxmuller", *TRANSFORMS)
OOC = ("boxmuller", *TRANSFORMS)
SEPARATE = ("halfspace_pack", "zx_dft", "c2r_y")
OOC_FLAGS = ["--out-of-core"]
PART = [["--part", "1"], ["--part", "2"]]

DOUBLES = dict(ICFormat='"RVdoubleZel"')
F32, F64 = "float32", "float64"

#: name, ppd, PLT, extra keys, CLI flags of each invocation, the kernels the
#: run must launch (and no other), the run its particles are held against,
#: the element type.  A float32 run passes --dtype float32; a float64 run
#: passes no --dtype (the CLI's default) and writes doubles.
RUNS = (
    ("example", 128, True, {}, [[]], HALF, "plain", F32),
    ("fnl_plt128", 128, True, FNL, [[]], FULL, "plain", F32),
    ("plt128", 128, True, {}, [[]], HALF, None, F32),
    ("plain256", 256, False, {}, [[]], HALF, None, F32),
    ("plt256", 256, True, {}, [[]], HALF, None, F32),
    ("fnl512", 512, False, FNL, [[]], FULL, None, F32),
    ("corner256", 256, False, CORNER, [[]], FULL, None, F32),
    ("v1_128", 128, False, V1, [[]], TRANSFORMS, None, F32),  # v1 draws on the host
    ("ooc_plain256", 256, False, {}, [OOC_FLAGS], OOC, "plain256", F32),
    ("ooc_fnl_plt128", 128, True, FNL, [OOC_FLAGS + ["--backing", "disk"]], OOC,
     "fnl_plt128", F32),
    ("ooc_fnl256", 256, False, FNL, [OOC_FLAGS], OOC, None, F32),
    ("part_plt128", 128, True, {}, PART, FULL, "plt128", F32),
    ("part_ooc_plt128", 128, True, {}, [OOC_FLAGS + f for f in PART], OOC, "plt128", F32),
    ("f64_example", 128, True, {}, [[]], HALF, None, F64),  # example.par as it stands
    ("f64_plt128", 128, True, DOUBLES, [[]], HALF, "plain", F64),
    ("f64_fnl_plt128", 128, True, dict(FNL, **DOUBLES), [[]], FULL, "plain", F64),
    ("f64_df64_plt128", 128, True, DOUBLES, [["--dtype", "df64"]], HALF, "f64_plt128", F64),
    ("f64_plain256", 256, False, DOUBLES, [[]], HALF, None, F64),
    ("f64_v1_128", 128, False, dict(V1, **DOUBLES), [[]], TRANSFORMS, None, F64),
    ("f64_ooc_plain256", 256, False, DOUBLES, [OOC_FLAGS], OOC, "f64_plain256", F64),
    ("f64_part_plt128", 128, True, DOUBLES, PART, FULL, "f64_plt128", F64),
    # part 2 alone, on a complex128 (narray, Y, Z, X) checkpoint as the JAX
    # CLI writes by default (made here from the model's k-space grid)
    ("f64_part2_complex128", 128, True, DOUBLES, [["--part", "2"]], TRANSFORMS,
     "f64_plt128", F64),
)
KEEP = {"fnl_plt128", "plt128", "plain256", "f64_plt128", "f64_plain256"}  # held against later


def _check_launches(name, launches, want):
    say(f"  launches: {launches}")
    for k in want:
        check(launches[k] >= 1, f"{name}: kernel {k} never launched")
    for k in set(launches) - set(want):
        check(launches[k] == 0, f"{name}: kernel {k} launched off its path")


def _write_par(tmp: Path, name: str, ppd: int, plt: bool, extra) -> Path:
    par = tmp / f"{name}.par"
    if name in ("example", "f64_example"):
        text = EXAMPLE.read_text()
        text = re.sub(r"InitialConditionsDirectory.*",
                      f'InitialConditionsDirectory = "{tmp / name}"', text)
        text = re.sub(r'(ZD_\w+_filename\s*=\s*)"zeldovich_tpu/',
                      rf'\1"{ROOT}/zeldovich_tpu/', text)
        par.write_text(text)
    else:
        par.write_text(par_text(ppd, tmp / name, plt, **extra))
    return par


def _half_route_api(tmp: Path, total: dict, dt="float32"):
    """The separate-kernel half route through the model API at 256^3 in
    dt, written through the writer; particles against the CLI's plain256
    (float64: f64_plain256)."""
    import torch

    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.models.pipeline import OutputWriter, Parameters, Zeldovich
    from zeldovich_tpu_torch.utils.streamio import stream_xspace

    name, fused = (("half_api256", "plain256") if dt == F32
                   else ("f64_half_api256", "f64_plain256"))
    say(f"-- {name}: 256^3 plain {TAG[dt]}, kspace_half_pair -> xspace_half_pair(spm)")
    param = Parameters.from_file(_write_par(tmp, name, 256, False,
                                            {} if dt == F32 else DOUBLES))
    (tmp / name).mkdir()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        kernels.reset_launches()
        m = Zeldovich(param, dtype=getattr(torch, dt), device="cuda")
        x = m.xspace_half_pair(m.kspace_half_pair())
        writer = OutputWriter(param)
        stream_xspace(x, writer)
        writer.report(m.Pk)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
    say("  " + next(ln for ln in err.getvalue().splitlines() if "pixels is" in ln))
    _check_launches(name, launches, SEPARATE)
    for k, v in launches.items():
        total[k] += v
    _same_particles(tmp / name, tmp / fused, 256, f"{fused} (fused route)",
                    "RVZel" if dt == F32 else "RVdoubleZel", tol_for(dt, PARTICLE_TOL))
    del x, m
    shutil.rmtree(tmp / name)


def _complex_checkpoint(outdir: Path, ppd: int, plt: bool, extra):
    """The k-space grid of a float64 run as the complex128
    (narray, Y, Z, X) checkpoint of the JAX CLI's default, in outdir."""
    import torch

    from zeldovich_tpu_torch.utils.checkpoint import save_kspace

    k = model_for(ppd, plt, dt=F64, **extra).kspace_pair()
    outdir.mkdir()
    save_kspace(torch.complex(k[:, 0], k[:, 1]), outdir / "zeldovich.kspace.ckpt")
    say(f"  wrote a complex128 {tuple(k[:, 0].shape)} checkpoint")


def phase_end_to_end():
    import torch

    from zeldovich_tpu_torch import kernels

    say("== phase 10: end to end through zeldovich_tpu_torch.cli.main")
    tmp = Path(tempfile.mkdtemp(prefix="zt_smoke_"))
    try:
        total = {dt: {k: 0 for k in kernels.launches} for dt in (F32, F64)}
        for name, ppd, plt, extra, calls, want, against, dt in RUNS:
            par = _write_par(tmp, name, ppd, plt, extra)
            say(f"-- {name}: {ppd}^3 {'PLT' if plt else 'plain'} {TAG[dt]} {extra or ''} "
                f"{' then '.join(' '.join(c) for c in calls if c)}")
            if name == "f64_part2_complex128":
                _complex_checkpoint(tmp / name, ppd, plt, extra)
            kernels.reset_launches()
            for flags in calls:
                _run_cli(par, *flags, *(["--dtype", F32] if dt == F32 else []))
            launches = dict(kernels.launches)
            _check_launches(name, launches, want)
            for k, v in launches.items():
                total[dt][k] += v
            fmt = extra.get("ICFormat", "RVZel").strip('"')
            tol = tol_for(dt, PARTICLE_TOL)
            _ic_files(tmp / name, ppd, cpd_for(ppd), fmt)
            left = [f.name for f in (tmp / name).iterdir()
                    if f.name.startswith("zeldovich.")]
            check(not left, f"{name} left {left} behind")
            if against == "plain":
                from zeldovich_tpu_torch.ops.c2r import c2r_y_plain
                from zeldovich_tpu_torch.ops.synth import halfspace_pack_zx_plain

                m = model_for(ppd, plt, dt=dt, **extra)
                x = (c2r_y_plain(halfspace_pack_zx_plain(
                    m.cfg, m.tables, m.pk_eff, m.plt_coefs), ppd)
                    if m.half_exact else m.xspace_pair(plain=True))
                _against_plain(tmp, name, par, x, fmt, tol)
                del x, m
            elif against is not None:
                _same_particles(tmp / name, tmp / against, ppd, against, fmt, tol)
            if name in ("plain256", "f64_plain256"):
                _half_route_api(tmp, total[dt], dt)
            if name not in KEEP:
                shutil.rmtree(tmp / name)
            torch.cuda.empty_cache()
        say(f"  launches over the runs: {total}")
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: the ppd of phase 11: not powers of two, so no FFT kernel takes them
#: (ROADMAP A12): B3, B4 and B5 with the matrix-product DFTs of
#: ops/mmfft.py.  576 = 2^6 3^2, 1152 = 2^7 3^2 (the half step in core in
#: float32), 1728 = 2^6 3^3 (AbacusSummit's small boxes) and 4096 (above
#: the kernels' 2048) out of core, a slab of each pass
SIZES_N = 576
SIZES_OOC = (1728, 4096)
#: ppd below the FFT kernels' 16 that the JAX package's tests run (8, 12)
#: and the least even one: B3, B4, B5 and the half step there
SIZES_SMALL = (2, 8, 12)
MM = ("halfspace_pack",)  # the kernels of a half step at those sizes


def _kernel_and_plain_ms(kernel_fn, plain_fn):
    """The kernel's ms (the median of 3 runs of 10 launches) and its plain
    version's (one call: they take ~100-300 ms at 576^3)."""
    import statistics

    kernel_fn()
    return statistics.median(_time(kernel_fn, 10) for _ in range(3)), _time(plain_fn, 1)


def _sizes_kernels(m, mp, dt):
    """B3, B4 and B5 at 576^3 against their plain versions, each timed
    with its bound; returns {name: (err, (ms, plain_ms, None, bound))}."""
    import torch

    from zeldovich_tpu_torch.ops.boxmuller import (
        boxmuller, boxmuller_plain, halfspace_boxmuller, halfspace_boxmuller_plain,
    )
    from zeldovich_tpu_torch.ops.modes_real import (
        draw_operands, pack_half_raw, slab_chunk, slab_modes,
    )
    from zeldovich_tpu_torch.ops.synth import halfspace_pack

    n, f, dtype, out = SIZES_N, TAG[dt], getattr(torch, dt), {}
    tb, half = m.tables, n // 2
    for mm, what in ((m, "plain"), (mp, "PLT")):
        a = (mm.cfg, mm.tables, mm.pk_eff, mm.plt_coefs)
        k = counted("halfspace_pack", lambda: halfspace_pack(*a))
        p = pack_half_raw(mm.cfg, mm.tables, dtype, mm.pk_eff, mm.plt_coefs)
        if dt == F64:  # bit-equal draws: the same zeros
            _same_zeros(k, p, f"B3 {n}^3 {what} {f}")
        # float32: a packing is a sum of two products of the deviate, whose
        # fast draws round apart from the plain version's by an ulp; at
        # 576^3 PLT two of 1.5e9 packings cancel to exactly 0 in one and to
        # 1e-13 in the other, so the zeros are held to ZERO_TOL (compare)
        e = compare(k, p, tol_for(dt, B3_TOL), f"B3 {n}^3 {what} {f} {tuple(k.shape)}")
        del k, p
        if mm is m:
            t = _kernel_and_plain_ms(
                lambda: halfspace_pack(*a),
                lambda: pack_half_raw(m.cfg, m.tables, dtype, m.pk_eff, None))
            out["halfspace_pack"] = (e, (*t, None, bound(
                nbytes(m.pk_eff, tb.planes64, tb.mzx64, tb.czx64)
                + m.cfg.narray * 4 * (half + 1) * n * n * m.pk_eff.element_size(),
                0, dt, draws=half * n * n)))
    a = (m.tables, m.pk_eff, False)
    k = counted("halfspace_boxmuller", lambda: halfspace_boxmuller(*a))
    e = _b4_compare(k, halfspace_boxmuller_plain(*a), f"B4 {n}^3 {f}")
    del k
    t = _kernel_and_plain_ms(lambda: halfspace_boxmuller(*a),
                             lambda: halfspace_boxmuller_plain(*a))
    out["halfspace_boxmuller"] = (e, (*t, None, _b4_bound(m.tables, m.pk_eff)))
    rows, err = slab_chunk(n, n), 0.0
    for y0 in (0, half - rows // 2, n - rows):  # generated half, across ppd/2, mirror
        ops = draw_operands(slab_modes(y0, y0 + rows, n, "cuda"), m.cfg, tb, dtype)
        k = counted("boxmuller", lambda: boxmuller(tb, *ops, False))
        p = boxmuller_plain(tb, *ops, False)
        for j, part in enumerate(("re", "im")):
            what = f"B5 {n}^3 {f} y0={y0} D_{part}"
            _same_zeros(k[j], p[j], what)
            err = max(err, compare(k[j], p[j], tol_for(dt, B5_TOL),
                                   f"{what} {tuple(k[j].shape)}"))
        del k, p
        if y0 == 0:
            t = _kernel_and_plain_ms(lambda: boxmuller(tb, *ops, False),
                                     lambda: boxmuller_plain(tb, *ops, False))
            b5 = (*t, None, bound(nbytes(*ops, tb.planes64, tb.mzx64, tb.czx64)
                                  + 2 * nbytes(ops[3]), 0, dt, draws=ops[0].numel()))
        del ops
    out["boxmuller"] = (err, b5)
    for name, (e, (k_ms, p_ms, _, b)) in out.items():
        say(f"  {name} {n}^3 {f}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; bound "
            f"{b['bound_ms']:.3f} ms ({b['bound_by']}), {100 * b['bound_ms'] / k_ms:.1f}% of it")
    return out


def _sizes_small():
    """B3, B4 and B5 (over the whole grid) against their plain versions,
    and the separate half step, plain and PLT, against the plain route
    with its launches (B3 alone), at each ppd of SIZES_SMALL in both
    types."""
    import torch

    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.ops.boxmuller import (
        boxmuller, boxmuller_plain, halfspace_boxmuller, halfspace_boxmuller_plain,
    )
    from zeldovich_tpu_torch.ops.c2r import c2r_y_plain
    from zeldovich_tpu_torch.ops.modes_real import (
        draw_operands, pack_half_raw, slab_modes,
    )
    from zeldovich_tpu_torch.ops.synth import halfspace_pack, halfspace_pack_zx_plain

    say(f"== phase 11: ppd {', '.join(map(str, SIZES_SMALL))}, B3/B4/B5 and the "
        "separate half step")
    for n in SIZES_SMALL:
        for dt in (F32, F64):
            f, dtype = TAG[dt], getattr(torch, dt)
            m = model_for(n, False, dt=dt)
            for mm, what in ((m, "plain"), (model_for(n, True, dt=dt), "PLT")):
                a = (mm.cfg, mm.tables, mm.pk_eff, mm.plt_coefs)
                k = counted("halfspace_pack", lambda: halfspace_pack(*a))
                p = pack_half_raw(mm.cfg, mm.tables, dtype, mm.pk_eff, mm.plt_coefs)
                if dt == F64:
                    _same_zeros(k, p, f"B3 {n}^3 {what} {f}")
                compare(k, p, tol_for(dt, B3_TOL), f"B3 {n}^3 {what} {f} {tuple(k.shape)}")
                xp = c2r_y_plain(halfspace_pack_zx_plain(*a), n)
                kernels.reset_launches()
                x = mm.xspace_half_pair()
                torch.cuda.synchronize()
                _check_launches(f"{n}^3 {what} {f} half step", dict(kernels.launches), MM)
                compare(x, xp, tol_for(dt, ROUTE_TOL),
                        f"{n}^3 {what} {f} separate step vs plain route")
            a = (m.tables, m.pk_eff, False)
            _b4_compare(counted("halfspace_boxmuller", lambda: halfspace_boxmuller(*a)),
                        halfspace_boxmuller_plain(*a), f"B4 {n}^3 {f}")
            ops = draw_operands(slab_modes(0, n, n, m.device), m.cfg, m.tables, dtype)
            k = counted("boxmuller", lambda: boxmuller(m.tables, *ops, False))
            p = boxmuller_plain(m.tables, *ops, False)
            for j, part in enumerate(("re", "im")):
                _same_zeros(k[j], p[j], f"B5 {n}^3 {f} D_{part}")
                compare(k[j], p[j], tol_for(dt, B5_TOL),
                        f"B5 {n}^3 {f} D_{part} {tuple(k[j].shape)}")


def _mm_flops(n: int, elems: int, dtype) -> float:
    """Real operations of the matrix-product DFT of length n on `elems`
    complex elements: three real products of 2 n operations an output
    (dense), or of 2 n1 and 2 n2 and the twiddle's 6 (four-step)."""
    from zeldovich_tpu_torch.ops import mmfft

    if mmfft._dense_takes(n, dtype):
        return 6.0 * n * elems
    n1, n2 = mmfft._factor(n)
    return (6.0 * (n1 + n2) + 6.0) * elems


def _sizes_products(m, dt, spm64):
    """The matrix products of the 576^3 half step (zx_mm on the packed
    spectrum, c2r_y_pair) against complex128 torch.fft on the float64
    spectrum, each timed beside torch.fft on the same shape; returns the
    readings."""
    import torch

    from zeldovich_tpu_torch.ops import mmfft
    from zeldovich_tpu_torch.ops.c2r import c2r_y_plain
    from zeldovich_tpu_torch.ops.fft import zx_dft_plain

    n, f = SIZES_N, TAG[dt]
    spm = spm64.to(getattr(torch, dt))
    tol = tol_for(dt, DFT_TOL)
    # the complex128 results rounded once to dt: compare's zeros are
    # then held at dt's grade
    g = mmfft.zx_mm(spm, +1)
    g64 = zx_dft_plain(spm64, +1)
    e_zx = compare(g, g64.to(g.dtype), tol,
                   f"zx_mm {f} vs complex128 torch.fft {tuple(g.shape)}")
    x = mmfft.c2r_y_pair(g)
    del spm
    x64 = c2r_y_plain(g64, n)
    e_c2r = compare(x, x64.to(x.dtype), tol, f"c2r_y_pair {f} vs complex128 torch.fft")
    del x64, g64, x
    r = _product_times(g, f"{n}^3 {f} {tuple(g.shape)}")
    r.update(zx_err=e_zx, c2r_err=e_c2r)
    del g
    torch.cuda.empty_cache()
    return r


def _product_times(g, what, c2r_rows=None):
    """The matrix products of a half step on the z/x-transformed spectrum g
    (zx_mm in place on it; c2r_y_pair into a buffer, on its first c2r_rows
    z rows when given), each timed with its bound, then torch.fft on the
    same shapes, the buffer freed first (torch.fft.irfft along y holds a
    transposed copy, a copy for cuFFT and its output: at 1152^3 one array's
    spectrum is 12.2 GB); returns the readings."""
    import torch

    from zeldovich_tpu_torch.ops import mmfft

    n, dt = 2 * (g.shape[-3] - 1), _dt_of(g)
    zx_ms = _time(lambda: mmfft.zx_mm(g, +1, g), reps=2)
    c = torch.complex(g[:, :, 0], g[:, :, 1])
    zx_lib = _time(lambda: torch.fft.ifftn(c, dim=(-2, -1), norm="forward"), reps=2)
    del c
    zx_moved = 2 * nbytes(g)
    zx_flops = 2 * _mm_flops(n, g.numel() // 2, g.dtype)
    if c2r_rows is not None:
        g = g[..., :c2r_rows, :].contiguous()
    x = mmfft.c2r_y_pair(g)
    c2r_ms = _time(lambda: mmfft.c2r_y_pair(g, x), reps=2)
    rate = F32_OPS if dt == F32 else F64_TC_OPS
    flops = {"zx": zx_flops,
             "c2r": (2.0 * (2 * (n // 2 + 1)) * x.numel() if mmfft._dense_takes(n, g.dtype)
                     else _mm_flops(n, x.numel() // 2, g.dtype))}
    # the bound: operations at the type's matmul peak, or the bytes (the
    # operand read once, the result written once) at 3.35 TB/s
    moved = {"zx": zx_moved, "c2r": nbytes(g, x)}
    del x
    torch.cuda.empty_cache()
    c = torch.complex(g[:, :, 0], g[:, :, 1])
    c2r_lib = _time(lambda: torch.fft.irfft(c, n=n, dim=-3, norm="forward"), reps=2)
    del c, g
    torch.cuda.empty_cache()
    r = {"zx_ms": zx_ms, "zx_torch_fft_ms": zx_lib, "c2r_ms": c2r_ms,
         "c2r_torch_fft_ms": c2r_lib}
    for k in ("zx", "c2r"):
        tb, to = 1e3 * moved[k] / HBM_BPS, 1e3 * flops[k] / rate
        r[f"{k}_bound_ms"] = max(tb, to)
        r[f"{k}_bound_by"] = "bytes" if tb >= to else "operations"
    say(f"  {what} products: zx_mm {zx_ms:.3f} ms (torch.fft ifftn {zx_lib:.3f} ms, bound "
        f"{r['zx_bound_ms']:.3f} ms by {r['zx_bound_by']}), c2r_y_pair"
        + ("" if c2r_rows is None else f" on {c2r_rows} z rows")
        + f" {c2r_ms:.3f} ms (torch.fft irfft {c2r_lib:.3f} ms, bound "
        f"{r['c2r_bound_ms']:.3f} ms by {r['c2r_bound_by']}), DENSE_MAX "
        f"{mmfft.DENSE_MAX[getattr(torch, dt)]}")
    return r


def _sizes_half_step(dt, table: Path):
    """Phase 11 at 576^3 in dt: B3, B4 and B5 against their plain versions,
    the separate half step (B3, the ky=0 fixup, the matrix products) plain
    and PLT against the plain route with its launches, the products against
    complex128 torch.fft, times and the peak; returns (kernel readings,
    step readings, the plain step's output on the host, in float64 the PLT
    plain route's output on the host, else None).  The plain route runs
    first and alone: at 576^3 PLT float64 it peaks near 50 GB."""
    import statistics

    import torch

    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.ops.c2r import c2r_y_plain
    from zeldovich_tpu_torch.ops.synth import halfspace_pack_zx_plain

    n, f = SIZES_N, TAG[dt]
    say(f"== phase 11: {n}^3 {f}, B3/B4/B5 and the separate half step")
    m = model_for(n, False, dt=dt)
    mp = model_for(n, True, dt=dt, ZD_PLT_filename=f'"{table}"')
    check(mp.tables.eig.shape[0] == n, f"the model did not load the {n} table")
    kern = _sizes_kernels(m, mp, dt)
    step, keep_plt = {}, None
    for mm, what in ((m, "plain"), (mp, "PLT")):
        def plain(mm=mm):
            return c2r_y_plain(halfspace_pack_zx_plain(mm.cfg, mm.tables, mm.pk_eff,
                                                       mm.plt_coefs), n)

        torch.cuda.empty_cache()
        xp = plain()
        kernels.reset_launches()
        x = mm.xspace_half_pair()
        torch.cuda.synchronize()
        _check_launches(f"{n}^3 {what} {f} half step", dict(kernels.launches), MM)
        step[f"{what}_err"] = compare(x, xp, tol_for(dt, ROUTE_TOL),
                                      f"{n}^3 {what} {f} separate step vs plain route")
        if mm is mp and dt == F64:
            keep_plt = xp.cpu()  # the CLI's PLT run is held against it
        del xp
        if mm is m:
            keep = x.cpu()
        del x
        torch.cuda.empty_cache()
        ms = statistics.median(_time(lambda: mm.xspace_half_pair(), 2) for _ in range(3))
        step[f"{what}_ms"] = ms
        say(f"  {n}^3 {what} {f} step: separate route {ms:.3f} ms"
            + (f", plain route {_time(plain, 1):.3f} ms" if mm is m else ""))
    del mp
    torch.cuda.empty_cache()
    step["ms"], step["peak"] = _peak(lambda: m.xspace_half_pair(), n,
                                     f"{n}^3 plain {f} separate step", reps=2)
    spm64 = (m if dt == F64 else model_for(n, False, dt=F64)).kspace_half_pair()
    step.update(_sizes_products(m, dt, spm64))
    del spm64, m
    torch.cuda.empty_cache()
    return kern, step, keep, keep_plt


def _sizes_fnl():
    """The 576^3 f_NL full-grid step in float64 (B4, the matrix products
    over y, z, x, the phi pass) against the plain route."""
    import torch

    from zeldovich_tpu_torch import kernels

    n = SIZES_N
    say(f"== phase 11: {n}^3 f_NL f64 full-grid step")
    m = model_for(n, False, dt=F64, **FNL)
    _ = m.pk_eff
    kernels.reset_launches()
    x = m.xspace_pair()
    torch.cuda.synchronize()
    _check_launches(f"{n}^3 f_NL f64 step", dict(kernels.launches), ("halfspace_boxmuller",))
    compare(x, m.xspace_pair(plain=True), F64_TOL, f"{n}^3 f_NL f64 step vs plain route")
    del x
    t = _turns(lambda: m.xspace_pair(), lambda: m.xspace_pair(plain=True), rounds=1,
               reps=1)
    say(f"  {n}^3 f_NL f64 step: matrix-product route {t[0]:.3f} ms, plain route "
        f"{t[1]:.3f} ms")
    _peak(lambda: m.xspace_pair(), n, f"{n}^3 f_NL f64 step", reps=1)
    del m
    torch.cuda.empty_cache()
    return t


def _sizes_1152():
    """The 1152^3 float32 half step in core: its launches, time and peak."""
    import torch

    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.ops.mmfft import dft_zx

    say("== phase 11: 1152^3 f32 half step in core")
    m = model_for(1152, False, dt=F32)
    _ = m.pk_eff
    kernels.reset_launches()
    x = m.xspace_half_pair()
    torch.cuda.synchronize()
    _check_launches("1152^3 f32 half step", dict(kernels.launches), MM)
    check(x.shape == (2, 2, 1152, 1152, 1152) and bool(torch.isfinite(x).all()),
          "1152^3: non-finite or misshapen step output")
    del x
    ms, peak = _peak(lambda: m.xspace_half_pair(), 1152, "1152^3 plain f32 separate step",
                     reps=1)
    # the products on one array's packed spectrum (a step runs them on each
    # of the narray arrays), the c2r on half its z rows, beside torch.fft on
    # the same shapes (torch.fft.irfft on the whole would not fit)
    g = m.kspace_half_pair()[:1].clone()
    del m
    torch.cuda.empty_cache()
    products = _product_times(dft_zx(g, +1, g), "1152^3 f32, one array's", c2r_rows=576)
    del g
    torch.cuda.empty_cache()
    return ms, peak, products


def _sizes_ooc(ppd: int):
    """One out-of-core slab of each pass at ppd (float32, the CLI's 2048 MB
    slabs): pass 1's y-slab (B5, fields, the z/x products) and pass 2's
    z-slab (the y product) against the plain route, timed."""
    import torch

    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.ops.fft import y_dft_plain, zx_dft_plain
    from zeldovich_tpu_torch.ops.mmfft import dft_y, dft_zx
    from zeldovich_tpu_torch.ops.modes_real import synthesize_pair

    say(f"== phase 11: {ppd}^3 f32 out-of-core slabs")
    m = model_for(ppd, False)
    rows = 2048 * 2**20 // (ppd * ppd * m.cfg.narray * 8)
    while ppd % rows:
        rows -= 1
    cfg, tb, y0 = m.cfg, m.tables, ppd // 2 - rows // 2  # the slab across ppd/2
    kernel = lambda: dft_zx(synthesize_pair(y0, rows, cfg, tb, torch.float32), +1)
    plain = lambda: zx_dft_plain(
        synthesize_pair(y0, rows, cfg, tb, torch.float32, plain=True), +1)
    before = kernels.launches["boxmuller"]
    k = kernel()
    check(kernels.launches["boxmuller"] > before, f"{ppd}^3 pass-1 slab: B5 not launched")
    e1 = compare(k, plain(), ROUTE_TOL,
                 f"{ppd}^3 pass-1 y-slab ({cfg.narray}, 2, {rows}, {ppd}, {ppd})")
    del k
    t1 = _turns(kernel, plain, rounds=1, reps=2)
    del m, cfg, tb
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(ppd)
    z = torch.randn((2, 2, ppd, rows, ppd), device="cuda", generator=gen)
    e2 = compare(dft_y(z, +1), y_dft_plain(z, +1), DFT_TOL,
                 f"{ppd}^3 pass-2 z-slab y product {tuple(z.shape)}")
    t2 = _turns(lambda: dft_y(z, +1), lambda: y_dft_plain(z, +1), rounds=1, reps=2)
    say(f"  {ppd}^3 slabs of {rows}: pass 1 (B5 + fields + z/x products) {t1[0]:.3f} ms, "
        f"plain {t1[1]:.3f} ms; pass 2 (y product) {t2[0]:.3f} ms, torch.fft {t2[1]:.3f} ms")
    del z
    torch.cuda.empty_cache()
    return {"rows": rows, "pass1_ms": t1, "pass2_ms": t2, "errs": (e1, e2)}


def _sizes_cli(tmp: Path, table: Path, x_plt):
    """The CLI at 576^3 in float64 (no --dtype): plain, PLT on the card's
    576 table (held particle by particle against x_plt, the plain route's
    output on the host), then --out-of-core (held against the in-core
    plain run); each launches B3 (out of core B5) and no other kernel.
    Returns the launches over the three runs."""
    import torch

    from zeldovich_tpu_torch import kernels

    n, total = SIZES_N, {k: 0 for k in kernels.launches}
    runs = (("sizes_plain", False, {}, [], MM),
            ("sizes_plt", True, dict(ZD_PLT_filename=f'"{table}"'), [], MM),
            ("sizes_ooc", False, {}, OOC_FLAGS, ("boxmuller",)))
    for name, plt, extra, flags, want in runs:
        par = _write_par(tmp, name, n, plt, extra)
        say(f"-- {name}: {n}^3 {'PLT' if plt else 'plain'} f64 {' '.join(flags)}")
        kernels.reset_launches()
        _run_cli(par, *flags)
        launches = dict(kernels.launches)
        _check_launches(name, launches, want)
        for k, v in launches.items():
            total[k] += v
        if name == "sizes_ooc":
            _same_particles(tmp / name, tmp / "sizes_plain", n, "the in-core run")
        elif plt:
            _against_plain(tmp, name, par, x_plt, ppd=n)
            for d in (name, f"{name}_plain"):
                shutil.rmtree(tmp / d)
        torch.cuda.empty_cache()
    return total


def phase_sizes():
    """Phase 11: ppd that the FFT kernels do not take, on the JAX package's
    route there (B3, B4, B5 and the matrix-product DFTs of ops/mmfft.py)."""
    import torch

    from zeldovich_tpu_torch.ops import lattice
    from zeldovich_tpu_torch.ops.plt import save_eigmodes

    say(f"== phase 11: ppd the FFT kernels do not take, on {smi()}")
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="zt_sizes_"))
    res = {"kernels": {}, "steps": {}}
    try:
        table = tmp / f"eigmodes{SIZES_N}"
        t = time.perf_counter()
        save_eigmodes(table, lattice.generate_eigmodes_table(SIZES_N))
        say(f"  the {SIZES_N} PLT table on the card: {time.perf_counter() - t:.3f} s")
        x64 = x_plt = None
        for dt in (F64, F32):
            kern, step, x, plt = _sizes_half_step(dt, table)
            res["kernels"][dt], res["steps"][dt] = kern, step
            if dt == F64:
                x64, x_plt = x, plt
            else:
                # float32 draws are not float64's (their uniforms carry 32
                # bits), so values alone: no zero pattern is shared
                x, ref = x.cuda().double(), x64.cuda()
                err = ((x - ref).abs().max() / ref.abs().max()).item()
                say(f"  {SIZES_N}^3 plain step f32 vs f64: max|f32-f64| = {err:.3e} "
                    f"* max (tol {F32_VS_F64_TOL:g})")
                check(err <= F32_VS_F64_TOL, "the float32 step strays from the float64 one")
                res["f32_vs_f64"] = err
                del ref
            del x
        del x64
        torch.cuda.empty_cache()
        # the CLI now, while the host holds the PLT plain route's output
        res["launches"] = _sizes_cli(tmp, table, x_plt)
        del x_plt
        say(f"  phase 11 at {time.perf_counter() - t0:.1f} s")
        res["fnl_ms"] = _sizes_fnl()
        res["ms_1152"], res["peak_1152"], res["products_1152"] = _sizes_1152()
        res["ooc"] = {ppd: _sizes_ooc(ppd) for ppd in SIZES_OOC}
        _sizes_small()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"sizes": {k: v for k, v in res.items() if k != "kernels"}},
                   default=str))
    return res


#: phase 12: the sharded step.  (a) the CLI with --sharded over every card
#: (NCCL), against a one-rank CLI run of the same arithmetic, ic_* bytes:
#: name, ppd, PLT, extra keys, the one-rank run's flags, its kernels
SHARDED_CLI = (
    ("sharded_plain512", 512, False, {}, [], HALF),
    ("sharded_plt128", 128, True, {}, [], HALF),
    # the full grid runs z/x before y, as the out-of-core run does
    ("sharded_fnl256", 256, False, dict(FNL, **DOUBLES), OOC_FLAGS, OOC),
    # density only: the full grid's path on the products, its 0.76 GB
    # density file compared where the RVZel run wrote 6.1 GB of ic_*
    ("sharded_576", 576, False, dict(ZD_qdensity="2"), OOC_FLAGS, ("boxmuller",)),
)
#: (b) two ranks sharing the card over gloo, through the model API:
#: name, ppd, extra keys, the kernels each rank must launch
SHARDED_GLOO = (
    ("half256", 256, {}, HALF),
    ("fnl256", 256, FNL, OOC),
    ("full192", 192, {}, ("boxmuller",)),  # 192: the matrix products
)


def _run_ranks(procs, timeout, what):
    """Start the rank processes, wait up to `timeout` s for them all, kill
    any left; every rank must exit 0."""
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"{what}: ranks exited {[p.exitcode for p in procs]}")


def _gloo_rank(rank, world, store, out):
    """Phase 12b's rank: the sharded steps of SHARDED_GLOO in float64 on
    card 0 over a gloo group; its slabs and launch counts into out."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=300))
    try:
        mesh = make_mesh("cuda:0", group=dist.group.WORLD)
        kernels.library()
        res = {}
        for name, ppd, extra, _ in SHARDED_GLOO:
            m = model_for(ppd, False, dt=F64, **extra)
            m.sharded_fields(mesh)
            torch.cuda.synchronize()
            kernels.reset_launches()
            x = m.xspace_half_pair_sharded(mesh)
            torch.cuda.synchronize()
            res[name] = dict(kernels.launches)
            torch.save(x.cpu(), Path(out) / f"{name}.r{rank}.pt")
            del x, m
        (Path(out) / f"r{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _cli_job(argv):
    """A rank's CLI run: its exit code, its launch counts (reset just
    before the run and read just after) and its phases' seconds."""
    from zeldovich_tpu_torch import cli, kernels

    err = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    text = err.getvalue()
    if rc:
        print(text[-4000:], file=sys.stderr)
    return {"rc": rc, "launches": dict(kernels.launches), "phases": {
        m.group(1): float(m.group(2))
        for m in re.finditer(r"^\s*(.+?) took ([0-9.]+) seconds", text, re.M)}}


def _triple(port, world, rank) -> list:
    return ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
            "--process-id", str(rank)]


def _timing_job(ppds):
    """A rank's phase 12c timings at each ppd (the largest over the ranks)."""
    from zeldovich_tpu_torch.parallel.mesh import make_mesh

    with contextlib.redirect_stderr(io.StringIO()):
        mesh = make_mesh("cuda")
    try:
        return [_sharded_timing(mesh, ppd) for ppd in ppds]
    finally:
        mesh.close()


def _card_rank(rank, world, port, out, job, arg):
    """Rank `rank` of `world` in the environment torchrun gives its ranks
    (card `rank`, rendezvous on a localhost port): job(arg)'s result into
    out/r<rank>.json."""
    import os

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    sys.path.insert(0, str(ROOT))
    jobs = {"cli": _cli_job, "timing": _timing_job, "ooc_timing": _ooc_timing_job,
            # --distributed over the loopback triple (the environment aside)
            "dcli": lambda argv: _cli_job(argv + _triple(port, world, rank))}
    res = jobs[job](arg)
    (Path(out) / f"r{rank}.json").write_text(json.dumps(res))


def _card_ranks(world, job, arg, out: Path, timeout):
    """job(arg) in `world` ranks started with the spawn method, a card
    each; every rank's result."""
    import multiprocessing
    import socket

    with socket.socket() as s:  # a free port for the ranks' rendezvous
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for f in out.glob("r*.json"):
        f.unlink()
    ctx = multiprocessing.get_context("spawn")
    _run_ranks([ctx.Process(target=_card_rank, args=(r, world, port, str(out), job, arg))
                for r in range(world)], timeout, f"{job} over {world} cards")
    return [json.loads((out / f"r{r}.json").read_text()) for r in range(world)]


def _sharded_cli(tmp: Path, total: dict):
    """(a): each SHARDED_CLI run with --sharded over every card against its
    one-rank run, byte for byte; each rank's launches, checked and added
    into total."""
    import torch

    from zeldovich_tpu_torch import kernels

    cards = torch.cuda.device_count()
    for name, ppd, plt, extra, one_flags, want in SHARDED_CLI:
        say(f"-- {name}: {ppd}^3 {'PLT' if plt else 'plain'} f64 {extra or ''} --sharded "
            f"over {cards} card(s), against {' '.join(one_flags) or 'the in-core run'}")
        par = _write_par(tmp, name, ppd, plt, extra)
        if cards == 1:  # one rank in this process, as a run without torchrun
            kernels.reset_launches()
            _run_cli(par, "--sharded")
            ranks = [dict(kernels.launches)]
        else:  # a rank a card, each in a process of its own
            res = _card_ranks(cards, "cli", [str(par), "--sharded"], tmp, 600)
            check(all(r["rc"] == 0 for r in res), f"{name}: ranks exited {res}")
            ranks = [r["launches"] for r in res]
        for r, launches in enumerate(ranks):
            _check_launches(f"{name} rank {r}", launches, want)
            for k, v in launches.items():
                total[k] += v
        _same_outputs(tmp / name, _reference(ppd, plt, extra, one_flags), name)
        shutil.rmtree(tmp / name)
        torch.cuda.empty_cache()


#: one-device reference runs of phases 12a and 13a, made once and shared:
#: (ppd, PLT, extra keys, flags) -> output directory
_REFS: dict = {}


def _reference(ppd, plt, extra, flags) -> Path:
    """The output directory of the one-device CLI run (float64) of these
    keys and flags, run the first time it is asked for."""
    key = (ppd, plt, tuple(sorted(extra.items())), tuple(flags))
    if key not in _REFS:
        if not _REFS:
            _REFS["tmp"] = Path(tempfile.mkdtemp(prefix="zt_refs_"))
        name = f"ref{len(_REFS)}"
        say(f"-- one-device reference {name}: {ppd}^3 {'PLT' if plt else 'plain'} f64 "
            f"{extra or ''} {' '.join(flags)}")
        _run_cli(_write_par(_REFS["tmp"], name, ppd, plt, extra), *flags)
        _REFS[key] = _REFS["tmp"] / name
    return _REFS[key]


def _drop_references():
    if "tmp" in _REFS:
        shutil.rmtree(_REFS["tmp"], ignore_errors=True)
    _REFS.clear()


def _same_outputs(got: Path, want: Path, name: str):
    """Every output file of run `name` (ic_* and density) byte for byte
    the reference's, and the same set of files."""
    names = sorted(f.name for f in want.iterdir()
                   if f.name.startswith(("ic_", "density")))
    check(names and names == sorted(f.name for f in got.iterdir()
                                    if f.name.startswith(("ic_", "density"))),
          f"{name}: files {sorted(f.name for f in got.iterdir())}, want {names}")
    nbytes = 0
    for n in names:
        a, b = (got / n).read_bytes(), (want / n).read_bytes()
        check(a == b, f"{name}: {n} differs from the one-device run")
        nbytes += len(a)
    say(f"  {len(names)} output files, {nbytes} bytes, byte for byte the one-device run's")


def _sharded_gloo(tmp: Path) -> dict:
    """(b): two ranks share card 0 over gloo; their slabs against the
    one-device step, their launch counts."""
    import multiprocessing

    import torch

    say("-- two ranks on one card over gloo, through the model API (float64)")
    ctx = multiprocessing.get_context("spawn")
    _run_ranks([ctx.Process(target=_gloo_rank, args=(r, 2, str(tmp / "store"), str(tmp)))
                for r in range(2)], 240, "gloo")
    ranks = [json.loads((tmp / f"r{r}.json").read_text()) for r in range(2)]
    res = {}
    for name, ppd, extra, want in SHARDED_GLOO:
        for r, launches in enumerate(ranks):
            _check_launches(f"{name} rank {r}", launches[name], want)
        x = torch.cat([torch.load(tmp / f"{name}.r{r}.pt") for r in range(2)], dim=-2)
        m = model_for(ppd, False, dt=F64, **extra)
        ref = (m.xspace_half_pair() if m.half_exact else m.xspace_pair()).cpu()
        del m
        if name == "half256":
            # the same kernels on the same planes and columns: bit for bit
            same = torch.equal(x, ref)
            say(f"  {name}: 2 ranks vs the one-device step: bit-equal {same}")
            check(same, f"{name}: the sharded half step differs from the one-device one")
            err = 0.0
        else:
            # the full grid transforms z/x before y, the one-device step y
            # first (and at 192 the separate half route): rounding apart
            err = compare(x, ref, F64_TOL, f"{name}: 2 ranks vs the one-device step")
        res[name] = {"launches": [rk[name] for rk in ranks], "max_abs_err": err}
        del x, ref
    return res


def _exchange_operands(m, mesh):
    """The blocks the step's first exchange moves: (x, out, split axis,
    concat axis, split, concat) at this rank's shapes."""
    import torch

    from zeldovich_tpu_torch.parallel import pencil_mmfft as pm

    n, na, w = m.cfg.ppd, m.cfg.narray, mesh.world
    dev, dt = mesh.device, m.dtype
    if m.half_route_sharded():
        k0, k1 = pm.ky_planes(n, mesh)
        x = torch.rand((na, 2, 2, k1 - k0, n, n), dtype=dt, device=dev)
        out = torch.empty((na, 2, 2, n // 2, n // w, n), dtype=dt, device=dev)
        return x, out, 4, 3, [n // w] * w, pm.split_sizes(n // 2, w)
    x = torch.rand((na, 2, n // w, n, n), dtype=dt, device=dev)
    out = torch.empty((na, 2, n, n // w, n), dtype=dt, device=dev)
    return x, out, 3, 2, [n // w] * w, [n // w] * w


def _sharded_timing(mesh, ppd: int) -> dict:
    """(c) at ppd on this rank's card, plain in float32 and float64 (the
    half route) and f_NL in float64 (the full grid): the sharded step, its
    first exchange alone beside its bound (a rank's blocks read once and
    written once at HBM_BPS), the one-device step on the same card, each
    with its peak memory; every number the largest over the ranks."""
    import torch
    import torch.distributed as dist

    from zeldovich_tpu_torch.parallel import pencil_mmfft as pm

    res = {"ppd": ppd, "world": mesh.world, "backend": mesh.backend, "cases": []}
    for case, dt, extra in (("plain", F32, {}), ("plain", F64, {}), ("fnl", F64, FNL)):
        m = model_for(ppd, False, device=mesh.device, dt=dt, **extra)
        m.sharded_fields(mesh)
        what = f"{ppd}^3 {case} {TAG[dt]} rank {mesh.rank} of {mesh.world}"
        one = m.xspace_half_pair if m.half_exact else m.xspace_pair
        sharded_ms, sharded_peak = _peak(lambda: m.xspace_half_pair_sharded(mesh), ppd,
                                         f"{what}: sharded", reps=3)
        x, out, sa, ca, split, concat = _exchange_operands(m, mesh)
        moved = nbytes(x, out)
        pm.exchange(x, out, sa, ca, split, concat, mesh)  # warm-up
        ex_ms = sorted(_time(lambda: pm.exchange(x, out, sa, ca, split, concat, mesh), 3)
                       for _ in range(3))[1]
        del x, out
        torch.cuda.empty_cache()
        one_ms, one_peak = _peak(one, ppd, f"{what}: one device", reps=3)
        vals = torch.tensor([sharded_ms, sharded_peak / 2**30, ex_ms, one_ms,
                             one_peak / 2**30], dtype=torch.float64, device=mesh.device)
        dist.all_reduce(vals, op=dist.ReduceOp.MAX, group=mesh.group)
        vals = vals.tolist()
        res["cases"].append({
            "case": case, "dtype": dt,
            "route": "half (B1, exchange, B2)" if m.half_route_sharded()
            else "full grid (B5, zx, exchange, y)",
            "sharded_ms": vals[0], "sharded_peak_gib": vals[1], "exchange_ms": vals[2],
            "exchange_bound_ms": 1e3 * moved / HBM_BPS, "one_device_ms": vals[3],
            "one_device_peak_gib": vals[4]})
        del m
        torch.cuda.empty_cache()
    return res


def phase_sharded():
    """Phase 12: the sharded step (--sharded, zeldovich_tpu_torch/parallel)."""
    import torch

    from zeldovich_tpu_torch import kernels

    cards = torch.cuda.device_count()
    say(f"== phase 12: the sharded step, on {smi()}, {cards} card(s)")
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="zt_sharded_"))
    total = {k: 0 for k in kernels.launches}
    try:
        _sharded_cli(tmp, total)
        say(f"  phase 12 at {time.perf_counter() - t0:.1f} s")
        (tmp / "gloo").mkdir()
        gloo = _sharded_gloo(tmp / "gloo")
        say(f"  phase 12 at {time.perf_counter() - t0:.1f} s")
        # 1024^3 where the ranks' slabs fit: a one-rank float64 half step
        # holds B1's output and the z-slab, 2 x 36 GiB
        ppds = [512] if cards == 1 else [512, 1024]
        timing = (_timing_job(ppds) if cards == 1
                  else _card_ranks(cards, "timing", ppds, tmp, 600)[0])
        for t in timing:
            for c in t["cases"]:
                say(f"  {t['ppd']}^3 {c['case']} {TAG[c['dtype']]} ({c['route']}) over "
                    f"{t['world']} rank(s) ({t['backend']}): sharded {c['sharded_ms']:.3f} ms "
                    f"at {c['sharded_peak_gib']:.2f} GiB, one device {c['one_device_ms']:.3f} "
                    f"ms at {c['one_device_peak_gib']:.2f} GiB; exchange "
                    f"{c['exchange_ms']:.3f} ms (bound {c['exchange_bound_ms']:.3f})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"  launches over the sharded CLI runs, every rank: {total}")
    say(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"sharded": {"launches": total, "gloo": gloo, "timing": timing}}))
    return total


#: phase 13 (a): the CLI with --distributed over every card (NCCL; one
#: card: one process joined over the loopback triple), float64, against the
#: one-device run of the same arithmetic, every output byte: name, ppd, PLT,
#: extra keys, each run's flags (with --distributed), the one-device run's
#: flags, the kernels each run must launch.  The out-of-core runs take
#: 64 MB slabs, several lockstep steps a rank; their reference the CLI's
#: 2048 MB ones.
SLABS64 = ["--out-of-core", "--slab-mb", "64"]
MULTIHOST_CLI = (
    ("dist_plain512", 512, False, {}, [[]], [], [HALF]),
    ("dist_fnl256", 256, False, dict(FNL, **DOUBLES), [[]], OOC_FLAGS, [OOC]),
    ("dist_part256", 256, False, {}, PART, OOC_FLAGS, [("boxmuller",), TRANSFORMS]),
    ("dist_ooc256", 256, False, {}, [SLABS64], OOC_FLAGS, [OOC]),
    ("dist_ooc_fnl256", 256, False, dict(FNL, **DOUBLES), [SLABS64], OOC_FLAGS, [OOC]),
    ("dist_ooc576", 576, False, dict(ZD_qdensity="2"), [SLABS64], OOC_FLAGS,
     [("boxmuller",)]),
    ("dist_ooc_part256", 256, False, {}, [SLABS64 + p for p in PART], OOC_FLAGS,
     [("boxmuller", "zx_dft"), ("y_dft",)]),
)
#: (b) two ranks sharing card 0 over gloo, DistributedOutOfCore through the
#: model API (float64, 32 MB slabs of 16 rows: 8 lockstep steps a rank)
MULTIHOST_GLOO = (("ooc256", 256, {}), ("ooc_fnl256", 256, FNL))
GLOO_SLAB = 32 << 20


def _multihost_cli(tmp: Path, total: dict):
    """(a): each MULTIHOST_CLI run with --distributed over every card against
    its one-device run, byte for byte; each rank's launches, checked and
    added into total."""
    import socket

    import torch

    from zeldovich_tpu_torch import kernels

    cards = torch.cuda.device_count()
    for name, ppd, plt, extra, runs, one_flags, wants in MULTIHOST_CLI:
        par = _write_par(tmp, name, ppd, plt, extra)
        for i, (flags, want) in enumerate(zip(runs, wants)):
            argv = [str(par), "--distributed", *flags]
            say(f"-- {name}: {ppd}^3 f64 {extra or ''} {' '.join(argv[1:])} over {cards} "
                f"card(s)")
            if cards == 1:  # one process over NCCL, joined with the triple
                with socket.socket() as sk:
                    sk.bind(("127.0.0.1", 0))
                    port = sk.getsockname()[1]
                kernels.reset_launches()
                _run_cli(*argv, *_triple(port, 1, 0))
                ranks = [dict(kernels.launches)]
            else:  # a process a card
                res = _card_ranks(cards, "dcli", argv, tmp, 600)
                check(all(r["rc"] == 0 for r in res), f"{name}: ranks exited {res}")
                ranks = [r["launches"] for r in res]
            for r, launches in enumerate(ranks):
                _check_launches(f"{name} run {i + 1} rank {r}", launches, want)
                for k, v in launches.items():
                    total[k] += v
        left = [f.name for f in (tmp / name).iterdir() if f.name.startswith("zeldovich.")]
        check(not left, f"{name} left {left} behind")
        _same_outputs(tmp / name, _reference(ppd, plt, extra, one_flags), name)
        shutil.rmtree(tmp / name)
        torch.cuda.empty_cache()


def _nccl_same_card(tmp: Path) -> dict:
    """(d) one card: two --distributed processes over the loopback triple
    land on card 0 both (process id % 1).  NCCL refuses them: both must exit
    non-zero within 120 s with NCCL's "Duplicate GPU", rank 0 having said it
    runs over NCCL; neither falls back to gloo."""
    import socket

    par = _write_par(tmp, "same_card", 64, False, {})
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "zeldovich_tpu_torch", str(par), "--distributed",
         *_triple(port, 2, i)], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    t0 = time.perf_counter()
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    say(f"-- two --distributed processes on one card: exit codes {rcs} after {secs:.1f} s")
    check(all(rc != 0 for rc in rcs), f"two NCCL ranks on one card exited {rcs}")
    check(all("Duplicate GPU" in e for e in errs),
          "two NCCL ranks on one card did not fail in NCCL:\n" + errs[0][-2000:])
    check("(nccl, cuda:0)" in errs[0] and "gloo" not in errs[0] + errs[1],
          "a rank on the card left NCCL")
    shutil.rmtree(tmp / "same_card", ignore_errors=True)
    return {"exit_codes": rcs, "seconds": secs}


def _ooc_model(param, mesh, dt="float64", slab_bytes=GLOO_SLAB, backing="ram"):
    import torch

    from zeldovich_tpu_torch.models.outofcore import DistributedOutOfCore

    with contextlib.redirect_stderr(io.StringIO()):
        return DistributedOutOfCore(param, mesh, dtype=getattr(torch, dt),
                                    slab_bytes=slab_bytes, backing=backing)


def _multihost_gloo_rank(rank, world, store, out):
    """Phase 13b's rank on card 0 over a gloo group: DistributedOutOfCore's
    passes for MULTIHOST_GLOO (its x-space z-slabs and launch counts into
    out), then save_sharded -> load_sharded of its 192^3 k-space y-slab."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.parallel.mesh import make_mesh
    from zeldovich_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=300))
    try:
        mesh = make_mesh("cuda:0", group=dist.group.WORLD)
        kernels.library()
        res = {}
        for name, ppd, extra in MULTIHOST_GLOO:
            m = _ooc_model(_param_for(ppd, **extra), mesh)
            torch.cuda.synchronize()
            kernels.reset_launches()
            stage = m.stage_pass1()
            slabs = {z0: z.cpu() for z0, z in m.pass2(stage)}
            torch.cuda.synchronize()
            res[name] = {"launches": dict(kernels.launches), "stage": list(stage.shape),
                         "steps": len(slabs)}
            torch.save(slabs, Path(out) / f"{name}.r{rank}.pt")
            del m, stage, slabs
        z = model_for(192, False, device=mesh.device, dt=F64)
        k = z.kspace_pair_sharded(mesh)
        save_sharded(k, Path(out) / "ckpt", mesh)
        back = load_sharded(Path(out) / "ckpt", mesh, (2, 2, 192, 192, 192), "float64",
                            mesh.device)
        res["checkpoint_round_trip"] = bool(torch.equal(back, k))
        torch.save(k.cpu(), Path(out) / f"k192.r{rank}.pt")
        (Path(out) / f"r{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _multihost_gloo(tmp: Path) -> dict:
    """(b): two ranks share card 0 over gloo; each must launch B5, zx and y
    and hold half the stage, and their z-slabs are the one-device
    out-of-core step's bit for bit; the sharded checkpoint round-trips."""
    import multiprocessing

    import torch

    from zeldovich_tpu_torch.models.outofcore import OutOfCoreZeldovich
    from zeldovich_tpu_torch.ops.modes_real import synthesize_pair

    say("-- two ranks on one card over gloo: DistributedOutOfCore and the sharded "
        "checkpoint through the model API (float64)")
    ctx = multiprocessing.get_context("spawn")
    _run_ranks([ctx.Process(target=_multihost_gloo_rank,
                            args=(r, 2, str(tmp / "store"), str(tmp)))
                for r in range(2)], 300, "gloo")
    ranks = [json.loads((tmp / f"r{r}.json").read_text()) for r in range(2)]
    res = {}
    for name, ppd, extra in MULTIHOST_GLOO:
        for r, got in enumerate(ranks):
            _check_launches(f"{name} rank {r}", got[name]["launches"], OOC)
            check(got[name]["stage"][2] == ppd // 2,
                  f"{name} rank {r}: stage {got[name]['stage']} is not half the grid")
        with contextlib.redirect_stderr(io.StringIO()):
            one = OutOfCoreZeldovich(_param_for(ppd, **extra), dtype=torch.float64,
                                     slab_bytes=GLOO_SLAB, device="cuda")
        want = {z0: z.cpu() for z0, z in one.pass2(one.stage_pass1())}
        got = {}
        for r in range(2):
            got.update(torch.load(tmp / f"{name}.r{r}.pt"))
        same = got.keys() == want.keys() and all(torch.equal(got[z], want[z]) for z in want)
        say(f"  {name}: {len(want)} z-slabs of 2 ranks (stages {ranks[0][name]['stage']}, "
            f"{ranks[0][name]['steps']} steps a rank) vs the one-device out-of-core "
            f"step: bit-equal {same}")
        check(same, f"{name}: the ranks' z-slabs differ from the one-device step")
        res[name] = {"launches": [rk[name]["launches"] for rk in ranks],
                     "stage": ranks[0][name]["stage"], "bit_equal": same}
        del one, want, got
        torch.cuda.empty_cache()
    k = torch.cat([torch.load(tmp / f"k192.r{r}.pt") for r in range(2)], dim=2)
    m = model_for(192, False, dt=F64)
    ref = synthesize_pair(0, 192, m.cfg, m.tables, torch.float64).cpu()
    same = bool(torch.equal(k, ref)) and all(rk["checkpoint_round_trip"] for rk in ranks)
    say(f"  192^3 k space: save_sharded -> load_sharded on both ranks, their y-slabs "
        f"the one-device synthesis (B5): {same}")
    check(same, "sharded checkpoint round trip")
    res["checkpoint"] = same
    return res


def _ooc_timing_job(ppd):
    """(c) on this rank's card: DistributedOutOfCore at ppd^3 plain float32
    (the CLI's 2048 MB slabs): pass 1, pass 2 without the writer (to the
    host, one slab ahead), the exchange alone at pass 2's shapes and steps,
    the stage a rank, the peak device memory; the largest over the ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from zeldovich_tpu_torch.parallel.mesh import make_mesh
    from zeldovich_tpu_torch.parallel.outofcore import zslab_from_rows
    from zeldovich_tpu_torch.utils.streamio import stream_to_host

    with contextlib.redirect_stderr(io.StringIO()):
        mesh = make_mesh("cuda")
    try:
        tmp = Path(tempfile.mkdtemp(prefix="zt_mh_ooc_"))
        need = 2 * 2 * ppd**3 * 4 // mesh.world
        ram, disk = _host_space(tmp)
        backing = "ram" if ram > need + (16 << 30) else "disk"
        m = _ooc_model(_param_for(ppd, InitialConditionsDirectory=f'"{tmp / "ic"}"'),
                       mesh, dt=F32, slab_bytes=2048 << 20, backing=backing)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.barrier()
        t0 = time.perf_counter()
        stage = m.stage_pass1()
        torch.cuda.synchronize()
        pass1 = time.perf_counter() - t0
        mesh.barrier()
        finite = []
        t0 = time.perf_counter()
        stream_to_host(m.pass2(stage), lambda z0, h: finite.append(
            bool(np.isfinite(h[:, :, ::97, :, ::97]).all())))
        pass2 = time.perf_counter() - t0
        check(finite and all(finite), "1024^3 pass 2: non-finite z-slab")
        peak = torch.cuda.max_memory_allocated()
        na, w, yl = m.cfg.narray, mesh.world, ppd // mesh.world
        rows = torch.rand((na, 2, yl, w, m.slab, ppd), device=mesh.device)
        zslab_from_rows(rows, mesh)  # warm-up
        ex_ms = sorted(_time(lambda: zslab_from_rows(rows, mesh), 3) for _ in range(3))[1]
        steps = len(finite)
        vals = torch.tensor([pass1, pass2, ex_ms, steps * ex_ms / 1e3, stage.nbytes / 1e9,
                             peak / 2**30], dtype=torch.float64, device=mesh.device)
        dist.all_reduce(vals, op=dist.ReduceOp.MAX, group=mesh.group)
        v = vals.tolist()
        res = {"ppd": ppd, "world": mesh.world, "backend": mesh.backend, "backing": backing,
               "slab": m.slab, "steps": steps, "pass1_s": v[0], "pass2_s": v[1],
               "exchange_ms_a_step": v[2], "exchange_s": v[3],
               "exchange_share_of_pass2": v[3] / v[1], "stage_gb_a_rank": v[4],
               "peak_gib": v[5]}
        del stage, rows
        shutil.rmtree(tmp, ignore_errors=True)
        return res
    finally:
        mesh.close()


#: (c) with more than one card: the Output phase of --distributed (each
#: rank its own planes) against --sharded (rank 0 writes every slab), in
#: core, float64: ppd, .par keys (1024^3 in ZelSimple: 12.9 GB of ic_* a
#: run where RVZel would write 34.4 GB)
OUTPUT_RUNS = ((512, {}), (1024, dict(ICFormat='"ZelSimple"')))


def _output_phases(tmp: Path, cards: int) -> list:
    res = []
    for ppd, extra in OUTPUT_RUNS:
        row = {"ppd": ppd, "format": extra.get("ICFormat", "RVZel").strip('"')}
        for mode, job in (("--sharded", "cli"), ("--distributed", "dcli")):
            name = f"out{ppd}{mode.strip('-')}"
            par = _write_par(tmp, name, ppd, False, extra)
            rk = _card_ranks(cards, job, [str(par), mode], tmp, 900)
            check(all(r["rc"] == 0 for r in rk), f"{name}: ranks exited {rk}")
            row[mode.strip("-")] = {k: rk[0]["phases"].get(k) for k in (
                "Mode synthesis (+ f_NL phi pass)", "Inverse FFT", "Output")}
        _same_outputs(tmp / f"out{ppd}distributed", tmp / f"out{ppd}sharded",
                      f"{ppd}^3 --distributed vs --sharded")
        for mode in ("sharded", "distributed"):
            shutil.rmtree(tmp / f"out{ppd}{mode}")
        say(f"  {ppd}^3 {row['format']} over {cards} cards, rank 0's phases (s): "
            f"--sharded {row['sharded']}, --distributed {row['distributed']}")
        res.append(row)
    return res


def phase_multihost():
    """Phase 13: several processes (--distributed), the sharded checkpoints
    and DistributedOutOfCore (zeldovich_tpu_torch/parallel/multihost.py,
    parallel/outofcore.py)."""
    import torch

    from zeldovich_tpu_torch import kernels

    cards = torch.cuda.device_count()
    say(f"== phase 13: several processes and sharded out of core, on {smi()}, "
        f"{cards} card(s)")
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="zt_multihost_"))
    total = {k: 0 for k in kernels.launches}
    try:
        _multihost_cli(tmp, total)
        _drop_references()
        same_card = _nccl_same_card(tmp) if cards == 1 else None
        say(f"  phase 13 at {time.perf_counter() - t0:.1f} s")
        (tmp / "gloo").mkdir()
        gloo = _multihost_gloo(tmp / "gloo")
        say(f"  phase 13 at {time.perf_counter() - t0:.1f} s")
        timing = (_ooc_timing_job(1024) if cards == 1
                  else _card_ranks(cards, "ooc_timing", 1024, tmp, 900)[0])
        say(f"  1024^3 f32 DistributedOutOfCore over {timing['world']} rank(s) "
            f"({timing['backend']}, {timing['backing']} stage of "
            f"{timing['stage_gb_a_rank']:.2f} GB a rank): pass 1 {timing['pass1_s']:.3f} s, "
            f"pass 2 without the writer {timing['pass2_s']:.3f} s ({timing['steps']} steps "
            f"of {timing['slab']} planes), the exchange {timing['exchange_ms_a_step']:.3f} "
            f"ms a step, {100 * timing['exchange_share_of_pass2']:.1f}% of pass 2; peak "
            f"{timing['peak_gib']:.2f} GiB")
        output = _output_phases(tmp, cards) if cards > 1 else None
    finally:
        _drop_references()
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"  launches over the --distributed CLI runs, every rank: {total}")
    say(f"  phase 13 took {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"multihost": {"launches": total, "same_card": same_card,
                                  "gloo": gloo, "timing": timing, "output": output}}))
    return total


#: phase 14: a kernel's name in a trace (its template, demangled by CUPTI)
#: -> the launch counters of the wrappers that launch it once a call
TRACE_KERNELS = {
    "pack_rows_kernel": ("halfspace_pack_zx",),
    "axis_cols_kernel": ("halfspace_pack_zx", "c2r_y", "zx_dft", "y_dft"),
    "axis_rows_kernel": ("zx_dft",),
    "boxmuller_kernel": ("halfspace_boxmuller",),
    "boxmuller_at_kernel": ("boxmuller",),
    "pack_kernel": ("halfspace_pack",),
}


def _trace(d: Path, rank: int = 0, runs: int = 1) -> tuple[Path, list]:
    """The newest trace rank `rank` wrote into d after `runs` runs (one
    file a run), and its events."""
    files = sorted(d.glob(f"rank{rank}.*.pt.trace.json"),
                   key=lambda f: int(f.name.split(".")[1]))
    check(len(files) == runs, f"{d}: rank {rank} wrote {len(files)} traces in {runs} runs")
    return files[-1], json.loads(files[-1].read_text())["traceEvents"]


def _trace_summary(path: Path, events: list, launches: dict, what: str,
                   phases: tuple) -> dict:
    """Checks that the trace's kernel events are the launch counters' (each
    kernel of TRACE_KERNELS as often as its wrappers launched it) and that
    every launch of the port's kernels, the CUDA runtime call the trace
    correlates with the kernel, lies inside a range of one of
    `phases`; returns the trace's size, event count and kernel events by
    name (NCCL's too)."""
    kernels = {k: 0 for k in TRACE_KERNELS}
    kernels["nccl"] = 0
    ours = set()  # correlation ids of the port's kernels
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for k in TRACE_KERNELS:
            if re.search(rf"\b{k}<", e["name"]):
                kernels[k] += 1
                ours.add(e["args"]["correlation"])
        kernels["nccl"] += "nccl" in e["name"].lower()
    want = {k: sum(launches[c] for c in cs) for k, cs in TRACE_KERNELS.items()}
    check(all(kernels[k] == n for k, n in want.items()),
          f"{what}: the trace's kernel events {kernels}, the launch counters' {want}")
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in phases]
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and e.get("args", {}).get("correlation") in ours]
    check({e["args"]["correlation"] for e in calls} == ours,
          f"{what}: {len(ours)} kernels, launches found for "
          f"{len({e['args']['correlation'] for e in calls})}")
    outside = [e["name"] for e in calls
               if not any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in spans)]
    check(spans and not outside, f"{what}: {len(outside)} launches outside {phases} "
          f"({len(spans)} such ranges)")
    res = {"trace_mb": path.stat().st_size / 1e6, "events": len(events),
           "kernel_events": {k: n for k, n in kernels.items() if n},
           "launch_calls_inside": len(calls)}
    say(f"  {what}: {path.name}, {res['trace_mb']:.2f} MB, {len(events)} events; "
        f"kernel events {res['kernel_events']}, {len(calls)} launch calls inside "
        f"{' or '.join(phases)}")
    return res


def _union(spans) -> tuple[float, float]:
    """The time (us) the spans (start, end) cover together, and the
    longest time between them."""
    covered, gap, end = 0.0, 0.0, None
    for a, b in sorted(spans):
        if end is not None and a > end:
            gap = max(gap, a - end)
        if end is None or a > end:
            covered += b - a
            end = b
        elif b > end:
            covered += b - end
            end = b
    return covered, gap


def _phase_gaps(events: list, phase: str) -> dict:
    """Inside the (first) range `phase` of a trace: its length, the card's
    busy time (kernels, copies and sets together) and its longest idle
    gap, the copies' count and bytes, and the main thread's time inside
    torch ops (the rest of it is Python and numpy, or waiting)."""
    span = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == phase)
    a, b = span["ts"], span["ts"] + span["dur"]
    inside = [e for e in events if "dur" in e and a <= e["ts"] < b]
    dev = [(e["ts"], min(e["ts"] + e["dur"], b)) for e in inside
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, gap = _union([(a, a), *dev, (b, b)])  # the range's ends bound the gaps
    host, _ = _union((e["ts"], min(e["ts"] + e["dur"], b)) for e in inside
                     if e.get("cat") == "cpu_op" and e["tid"] == span["tid"])
    copies = [e for e in inside if e.get("cat") == "gpu_memcpy"]
    res = {"phase_s": span["dur"] / 1e6, "device_busy_s": busy / 1e6,
           "device_busy_share": busy / span["dur"], "longest_device_gap_s": gap / 1e6,
           "copies": len(copies),
           "copy_gb": sum(e["args"].get("bytes", 0) for e in copies) / 1e9,
           "host_ops_s": host / 1e6, "host_ops_share": host / span["dur"]}
    say(f"  inside {phase!r} ({res['phase_s']:.3f} s): the card busy {res['device_busy_s']:.3f} s "
        f"({100 * res['device_busy_share']:.1f}%), longest idle gap "
        f"{res['longest_device_gap_s']:.3f} s, {len(copies)} copies of "
        f"{res['copy_gb']:.2f} GB; the main thread in torch ops {res['host_ops_s']:.3f} s "
        f"({100 * res['host_ops_share']:.1f}%)")
    return res


def _profile_run(argv: list) -> dict:
    """cli.main(argv) with the launch counters reset just before it and
    read just after, its wall and phases (s)."""
    t0 = time.perf_counter()
    res = _cli_job(argv)
    res["wall_s"] = time.perf_counter() - t0
    check(res["rc"] == 0, f"{' '.join(argv[1:])}: exited {res['rc']}")
    return res


#: the phases a kernel of the path launches in: in core, a --part 1 run,
#: out of core
IFFT, SYNTH = ("Inverse FFT",), ("Mode synthesis (+ f_NL phi pass)",)
OOC_RUN = ("Out-of-core streamed run",)


def _profile_512(tmp: Path) -> dict:
    """(a) the 512^3 plain CLI without and with --profile in this process,
    after one empty trace: the profiler's first start in a process (torch
    imports torch._inductor then; ~7 s on the card's machine, timed in a
    fresh process by scripts/torch_profile_start.py) is paid before the
    pair, here or by an earlier phase."""
    from torch.profiler import profile

    t0 = time.perf_counter()
    with profile():
        pass
    warm = time.perf_counter() - t0
    say(f"  an empty trace first: {warm:.3f} s")
    keep = ("Inverse FFT", "Output")
    runs = {}
    for name, flags in (("plain512", []), ("plain512_traced", ["--profile", str(tmp / "t512")])):
        par = _write_par(tmp, name, 512, False, {})
        runs[name] = r = _profile_run([str(par), *flags])
        r["outside_output_s"] = r["wall_s"] - r["phases"]["Output"]
        say(f"  512^3 plain f64 {' '.join(flags) or 'without --profile'}: wall "
            f"{r['wall_s']:.3f} s, " + ", ".join(f"{k} {r['phases'][k]:.3f} s" for k in keep)
            + f", outside Output {r['outside_output_s']:.3f} s; launches {r['launches']}")
    check(runs["plain512"]["launches"] == runs["plain512_traced"]["launches"],
          "--profile changed the launch counts")
    _same_outputs(tmp / "plain512_traced", tmp / "plain512", "512^3 --profile")
    for name in runs:
        shutil.rmtree(tmp / name)
    path, events = _trace(tmp / "t512")
    res = _trace_summary(path, events, runs["plain512_traced"]["launches"],
                         "512^3 plain trace", IFFT)
    res["output_gaps"] = _phase_gaps(events, "Output")
    res["empty_trace_first_s"] = warm
    res.update({k: {"wall_s": r["wall_s"], "outside_output_s": r["outside_output_s"],
                    **{p: r["phases"][p] for p in keep}}
                for k, r in (("without", runs["plain512"]), ("with", runs["plain512_traced"]))})
    return res


def _profile_paths(tmp: Path) -> dict:
    """(b) the 256^3 f_NL --out-of-core run (64 MB slabs), (c) at 128^3
    f_NL in core (the full grid), --part 1 then --part 2 into one DIR and
    --sharded (one rank), each with --profile, in this process."""
    res = {}
    par = _write_par(tmp, "ooc_fnl256", 256, False, FNL)
    r = _profile_run([str(par), *SLABS64, "--profile", str(tmp / "tooc")])
    _check_launches("256^3 f_NL --out-of-core --profile", r["launches"], OOC)
    res["ooc_fnl256"] = _trace_summary(*_trace(tmp / "tooc"), r["launches"],
                                       "256^3 f_NL out-of-core trace", OOC_RUN)
    res["ooc_fnl256"]["wall_s"] = r["wall_s"]
    shutil.rmtree(tmp / "ooc_fnl256")
    for name, extra, flag_sets, phases in (
            ("fnl128", FNL, [[]], [IFFT]), ("part128", {}, PART, [SYNTH, IFFT]),
            ("sharded128", {}, [["--sharded"]], [IFFT])):
        par = _write_par(tmp, name, 128, False, extra)
        for i, (flags, ph) in enumerate(zip(flag_sets, phases)):
            r = _profile_run([str(par), *flags, "--profile", str(tmp / f"t{name}")])
            res[f"{name}.{i + 1}"] = _trace_summary(
                *_trace(tmp / f"t{name}", runs=i + 1), r["launches"],
                f"128^3 {name} {' '.join(flags)} trace", ph)
        shutil.rmtree(tmp / name)
    return res


def _profile_distributed(tmp: Path) -> list:
    """(d) --distributed --profile at 256^3 plain in core over every card
    (one card: one process over the loopback triple; more: a process a
    card): a trace a rank, each with its rank's kernel events and, on more
    than one card, NCCL's."""
    import socket

    import torch

    cards = torch.cuda.device_count()
    par = _write_par(tmp, "dist256", 256, False, {})
    argv = [str(par), "--distributed", "--profile", str(tmp / "tdist")]
    if cards == 1:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        ranks = [_profile_run(argv + _triple(port, 1, 0))]
    else:
        ranks = _card_ranks(cards, "dcli", argv, tmp, 600)
        check(all(x["rc"] == 0 for x in ranks), f"--distributed --profile: {ranks}")
    wrote = sorted(f.name for f in (tmp / "tdist").iterdir())
    check(len(wrote) == cards, f"--distributed --profile over {cards} card(s) wrote {wrote}")
    res = []
    for rank, rk in enumerate(ranks):
        _check_launches(f"--distributed --profile rank {rank}", rk["launches"], HALF)
        t = _trace_summary(*_trace(tmp / "tdist", rank), rk["launches"],
                           f"256^3 --distributed rank {rank} of {cards} trace", IFFT)
        check(cards == 1 or t["kernel_events"].get("nccl", 0) > 0,
              f"rank {rank}'s trace holds no NCCL kernel")
        res.append(t)
    shutil.rmtree(tmp / "dist256")
    return res


def phase_profile(parts=("512", "paths", "distributed")):
    """Phase 14: --profile (torch.profiler, a trace a rank and run) on the
    port's paths, float64; `parts` of it alone where asked."""
    import torch

    say(f"== phase 14: --profile, on {smi()}, {torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="zt_profile_"))
    run = {"512": _profile_512, "paths": _profile_paths,
           "distributed": _profile_distributed}
    try:
        res = {part: run[part](tmp) for part in parts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    say(f"  phase 14 took {res['seconds']:.1f} s")
    say(json.dumps({"profile": {"card": smi(), **res}}))


#: phase 15: the PLT coefficient kernel against its plain version, each
#: plane to this share of its largest value: float64 as
#: tests/test_torch_synth.py holds the plain version to the JAX package,
#: float32 4 ulp (a library sqrt or pow may round by one)
PLT_TOL = {"float64": 1e-13, "float32": 4 * 2.0**-23}


def _plt_compare(k, p, dt, what) -> float:
    """Each of the four planes within PLT_TOL[dt] of its largest value;
    returns the largest error over the planes, relative."""
    import torch

    check(k.shape == p.shape and k.dtype == p.dtype,
          f"{what}: kernel gave {k.dtype} {tuple(k.shape)}, plain {p.dtype} {tuple(p.shape)}")
    worst = 0.0
    for j, name in enumerate(("cx", "cy", "cz", "f")):
        scale = p[j].abs().max().item()
        err = (k[j] - p[j]).abs().max().item()
        check(bool(torch.isfinite(k[j]).all()), f"{what} {name}: non-finite kernel output")
        check(err <= PLT_TOL[dt] * scale,
              f"{what} {name}: kernel disagrees with plain by {err:.3e} of {scale:.3e}")
        worst = max(worst, err / scale if scale else 0.0)
    say(f"  {what}: max|k-p| = {worst:.3e} * max|p| over the planes "
        f"(tol {PLT_TOL[dt]:.3g}); bit for bit: {bool(torch.equal(k, p))}")
    return worst


def phase_plt(dt="float64") -> dict:
    """Phase 15: the PLT coefficient kernel against its plain version, its
    time at 512^3 and a 512^3 PLT realization on its planes, in dt."""
    import torch

    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.ops.modes_real import plt_coef_fields, plt_coef_fields_plain

    dtype = getattr(torch, dt)
    say(f"== phase 15: PLT coefficient kernel vs plain, {TAG[dt]}, on {smi()}")
    res = {"dtype": dt, "errs": {}}
    for ppd, extra in ((16, {}), (24, {}), (24, {"ZD_qPLT_rescale": "1"}), (512, {})):
        m = model_for(ppd, True, dt=dt, **extra)
        a = (m.cfg, m.tables, dtype)
        g = kernels.plt_geometry(ppd, m.tables.eig.shape[0], dtype)
        tag = (f"{ppd}^3 {TAG[dt]}{' rescaled' if extra else ''} "
               f"({'direct' if g['step'] else 'interpolated, cap %d' % g['cap']})")
        before = kernels.plt_launches
        k = plt_coef_fields(*a)
        torch.cuda.synchronize()
        check(kernels.plt_launches == before + 1, f"{tag}: want one launch a call")
        p = plt_coef_fields_plain(*a)
        res["errs"][tag] = _plt_compare(k, p, dt, tag)
        del p
        if ppd != 512:
            continue
        rows = (100, 137)
        kr = plt_coef_fields(*a, rows)
        res["errs"][f"{tag} planes {rows}"] = _plt_compare(
            kr, plt_coef_fields_plain(*a, rows), dt, f"{tag} planes {rows}")
        check(torch.equal(kr, k[:, rows[0]:rows[1]]),
              f"{tag}: planes {rows} differ from the same planes of the whole")
        del kr
        before = kernels.plt_launches
        ms, plain_ms = _turns(lambda: plt_coef_fields(*a), lambda: plt_coef_fields_plain(*a))
        calls = kernels.plt_launches - before
        # _turns calls the kernel 21 times: a warm-up, 2 rounds of 2 x 5
        check(calls == 21, f"{tag}: {calls} launches over 21 calls")
        b = bound(nbytes(k, m.tables.eig), 0.0, dt)
        say(f"  {tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
            f"{b['bound_ms']:.3f} ms ({b['bound_by']}: {nbytes(k) / 1e9:.3f} GB written, "
            f"{nbytes(m.tables.eig) / 1e6:.1f} MB of table), "
            f"{100 * b['bound_ms'] / ms:.1f}% of it; {calls} launches over 21 calls")
        res.update(ms=ms, plain_ms=plain_ms, **b, geometry=g)
        del k, m, a
        torch.cuda.empty_cache()
        # a whole realization: one PLT launch, then B1 and B2 on its planes,
        # against the same realization on the plain version's planes
        kernels.reset_launches()
        m = model_for(512, True, dt=dt)
        xk = m.xspace_half_pair()
        torch.cuda.synchronize()
        check(kernels.plt_launches == 1,
              f"a 512^3 PLT realization launched the PLT kernel {kernels.plt_launches} times")
        _check_launches("512^3 PLT realization", dict(kernels.launches), HALF)
        m._plt_coefs = plt_coef_fields_plain(m.cfg, m.tables, dtype)
        xp = m.xspace_half_pair()
        res["realization_err"] = compare(xk, xp, tol_for(dt, ROUTE_TOL),
                                         f"512^3 PLT {TAG[dt]} realization on the kernel's "
                                         "planes vs the plain planes")
        say(f"  bit for bit: {bool(torch.equal(xk, xp))}")
        del xk, xp, m
        torch.cuda.empty_cache()
    say(json.dumps({"plt": {"card": smi(), **res}}))
    return res


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on the GPU.")
    ap.add_argument("--only", choices=["sharded"],
                    help="phases 1, 12, 13 and 14 alone (no kernel summary)")
    args = ap.parse_args(argv)
    if not (ROOT / "zeldovich_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1
    t0 = time.perf_counter()

    def stamp(what):  # where the script's time goes, phase by phase
        say(f"-- {what} done at {time.perf_counter() - t0:.1f} s")

    phase_card()
    if args.only == "sharded":
        phase_sharded()
        phase_multihost()
        phase_profile()
        say(f"phases 1, 12, 13 and 14 passed in {time.perf_counter() - t0:.1f} s")
        say(smi())
        return 0
    phase_eigmodes()
    stamp("phases 1, 1b")
    res = {}
    for dt in (F32, F64):
        r = res[dt] = {}
        r["errs"] = phase_kernels(dt)
        r["full_errs"], r["full_ms"], r["b4_more"] = phase_fullgrid_kernels(dt)
        r["per_kernel"] = phase_timing(dt)
        phase_fullgrid_timing(dt)
        r["b5_err"], r["b5_ms"] = phase_b5(dt)
        r["b3_err"], r["b3_ms"] = phase_b3(dt)
        stamp(f"phases 2-8 {TAG[dt]}")
    phase_outofcore()
    stamp("phase 9")
    launches = phase_end_to_end()
    stamp("phase 10")
    sizes = phase_sizes()
    stamp("phase 11")
    sharded = phase_sharded()
    stamp("phase 12")
    multihost = phase_multihost()
    stamp("phase 13")
    phase_profile()
    stamp("phase 14")
    for dt in (F32, F64):
        phase_plt(dt)
    stamp("phase 15")
    card = smi()

    def entry(dt, name, source, replaces, err, ms, **more):
        kernel_ms, plain_ms, library_ms, b = ms
        stem = source.removesuffix(".cu") + ("_f64.cu" if dt == F64 else ".cu")
        at = sizes["kernels"][dt].get(name)
        if at is not None:  # B3, B4, B5 at 576^3 as well
            more[f"at_{SIZES_N}"] = {"max_abs_err": at[0], "ms": at[1][0],
                                     "plain_ms": at[1][1], **at[1][3]}
        return {"name": name, "dtype": dt, "route": "cuda",
                "source": f"zeldovich_tpu_torch/csrc/{stem}",
                "templates": f"zeldovich_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[dt][name],
                # phase 11's and 12's CLI runs are float64: no float32 count
                "launches_sizes": sizes["launches"][name] if dt == F64 else None,
                "launches_sharded": sharded[name] if dt == F64 else None,
                "launches_multihost": multihost[name] if dt == F64 else None,
                "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms, **b,
                "library_ms": library_ms, **more}

    def entries(dt):
        r = res[dt]
        return [
            entry(dt, "halfspace_pack_zx", "synth.cu",
                  "zeldovich_tpu/ops/pallas_synth.py:946",
                  r["errs"][("b1", 512)], r["per_kernel"]["b1"]),
            entry(dt, "c2r_y", "c2r.cu", "zeldovich_tpu/ops/pallas_fft.py:700",
                  r["errs"][("b2", 512)], r["per_kernel"]["b2"]),
            entry(dt, "halfspace_boxmuller", "boxmuller.cu",
                  "zeldovich_tpu/ops/pallas_synth.py:546", r["full_errs"]["b4"],
                  r["full_ms"]["b4"], **r["b4_more"]),
            entry(dt, "zx_dft", "fft_axis.cu", "zeldovich_tpu/ops/pallas_fft.py:305",
                  r["full_errs"]["zx"], r["full_ms"]["zx"],
                  also_replaces="zeldovich_tpu/ops/pallas_fft.py:374"),
            entry(dt, "y_dft", "fft_axis.cu", "zeldovich_tpu/ops/pallas_fft.py:437",
                  r["full_errs"]["y"], r["full_ms"]["y"]),
            entry(dt, "boxmuller", "boxmuller.cu",
                  "zeldovich_tpu/ops/pallas_synth.py:301", r["b5_err"], r["b5_ms"]),
            entry(dt, "halfspace_pack", "synth.cu",
                  "zeldovich_tpu/ops/pallas_synth.py:470", r["b3_err"], r["b3_ms"]),
        ]

    summary = {"kernels": entries(F32) + entries(F64)}
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s "
        "(every kernel once per element type; max_abs_err and ms at 512^3: "
        "B1/B2 the plain half step (B2 timed into a buffer of its own), B4 the "
        "plain configuration's half space, zx/y a (2, 2, 512, 512, 512) grid, "
        "B5 the 64-row chunk of the y0 = 0 slab (max_abs_err over three "
        "slabs), B3 the plain configuration's packed half spectrum; library_ms "
        "torch.fft.irfft for B2, ifftn/ifft for zx/y, on complex64 or "
        f"complex128; bound_ms at {HBM_BPS / 1e12:g} TB/s, {F32_OPS / 1e12:g} "
        f"TFLOP/s float32 and {F64_OPS / 1e12:g} TFLOP/s float64, draw work "
        f"counted as {DRAW_OPS} 32-bit operations a mode and, in float64, "
        f"{DRAW_F64_OPS} float64 ones; launches: the float32 and the float64 "
        f"end-to-end runs apart; launches_sizes: phase 11's {SIZES_N}^3 float64 CLI "
        f"runs (null in float32: none ran); launches_sharded: phase 12's float64 "
        f"--sharded CLI runs (null in float32); launches_multihost: phase 13's float64 "
        f"--distributed CLI runs, every rank (null in float32); at_{SIZES_N}: B3, B4, "
        f"B5 at {SIZES_N}^3)")
    say(card)
    say(json.dumps(summary))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
