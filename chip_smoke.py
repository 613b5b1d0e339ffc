#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (zeldovich_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from a checkout, with no install step; it needs one CUDA card and
nvcc.  Phases, each printed on its own lines; any failure raises and the
script exits non-zero without printing a result:

1. card: nvidia-smi name and power limit, torch and CUDA versions; build
   the kernels from csrc/ and print ptxas registers, shared memory, spills;
2. kernel B1 (halfspace_pack_zx) against its plain version on the card, at
   128^3 with example.par's PLT configuration and at 512^3 plain float32;
3. kernel B2 (c2r_y) against its plain version on phase 2's outputs;
4. the forward step (B1 + B2) timed against the plain route (torch ops +
   torch.fft) with CUDA events, in turns plain, kernel, kernel, plain:
   512^3 plain, 512^3 PLT, and 1024^3 plain (kernel route, peak memory);
5. end to end through zeldovich_tpu_torch.cli.main: example.par (128^3
   PLT, RVZel; every particle held against the same run through the plain
   route), a 256^3 plain run and a 512^3 PLT run, with the launch counters
   reset just before and read just after.

The last two lines are the kernel JSON summary and the result line
{"ok": true, "device": {...}}.  No JAX is imported: the port reuses only
the JAX package's jax-free host modules (parameters, power spectrum, host
pcg64, the ic_* writer).
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


def par_text(ppd: int, outdir, plt: bool, seed: int = 12346) -> str:
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
    return "".join(f"{k} = {v}\n" for k, v in keys.items())


def model_for(ppd, plt, device="cuda"):
    import torch

    from zeldovich_tpu_torch.models.pipeline import Parameters, Zeldovich

    tmp = Path(tempfile.mkdtemp(prefix="zt_model_"))
    try:
        (tmp / "m.par").write_text(par_text(ppd, tmp / "ic", plt))
        param = Parameters.from_file(tmp / "m.par")
    finally:
        shutil.rmtree(tmp)
    with contextlib.redirect_stderr(io.StringIO()):
        return Zeldovich(param, dtype=torch.float32, device=device)


def compare(k, p, tol, what):
    """max|k - p| <= tol * max|p|, and matching zeros (to ZERO_TOL)."""
    import torch

    scale = p.abs().max().item()
    err = (k - p).abs().max().item()
    zk = (k[p == 0].abs().max().item() if (p == 0).any() else 0.0)
    zp = (p[k == 0].abs().max().item() if (k == 0).any() else 0.0)
    finite = bool(torch.isfinite(k).all())
    say(f"  {what}: max|k-p| = {err:.3e} = {err / scale:.3e} * max|p| "
        f"(tol {tol:g}); zeros {zk:.1e}/{zp:.1e} of {scale:.3e}")
    check(finite, f"{what}: non-finite kernel output")
    check(err <= tol * scale, f"{what}: kernel disagrees with plain")
    check(zk <= ZERO_TOL * scale and zp <= ZERO_TOL * scale,
          f"{what}: zero pattern differs")
    return err


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
    for line in kernels.ptxas_report():
        say("  ptxas " + line)


def phase_kernels():
    """Phases 2 and 3: B1 and B2 against their plain versions."""
    import torch

    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.ops.c2r import c2r_y, c2r_y_plain
    from zeldovich_tpu_torch.ops.synth import (
        halfspace_pack_zx, halfspace_pack_zx_plain,
    )

    errs = {}
    for ppd, plt in ((128, True), (512, False)):
        m = model_for(ppd, plt)
        cfg, tables, pk, coefs = m.cfg, m.tables, m.pk_eff, m.plt_coefs
        tag = f"{ppd}^3 {'PLT' if plt else 'plain'}"
        say(f"== phase 2: B1 vs plain, {tag}")
        before = kernels.launches["halfspace_pack_zx"]
        k = halfspace_pack_zx(cfg, tables, pk, coefs)
        torch.cuda.synchronize()
        check(kernels.launches["halfspace_pack_zx"] == before + 1,
              "B1 launch counter did not move")
        p = halfspace_pack_zx_plain(cfg, tables, pk, coefs)
        check(k.shape == p.shape, f"B1 shape {k.shape} != {p.shape}")
        errs[("b1", ppd)] = compare(k, p, B1_TOL, f"B1 {tag} {tuple(k.shape)}")
        del p
        say(f"== phase 3: B2 vs plain, {tag}")
        before = kernels.launches["c2r_y"]
        xk = c2r_y(k, ppd)
        torch.cuda.synchronize()
        check(kernels.launches["c2r_y"] == before + 1,
              "B2 launch counter did not move")
        xp = c2r_y_plain(k, ppd)
        errs[("b2", ppd)] = compare(xk, xp, B2_TOL, f"B2 {tag} {tuple(xk.shape)}")
        del k, xk, xp, m
        torch.cuda.empty_cache()
    return errs


def _time(fn):
    """One call of fn, in ms, between CUDA events."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    del out
    return a.elapsed_time(b)


def _turns(kernel_fn, plain_fn, rounds=3):
    """Medians over rounds of plain, kernel, kernel, plain (after warm-up)."""
    import statistics

    kernel_fn(), plain_fn()
    ks, ps = [], []
    for _ in range(rounds):
        ps.append(_time(plain_fn))
        ks.append(_time(kernel_fn))
        ks.append(_time(kernel_fn))
        ps.append(_time(plain_fn))
    return statistics.median(ks), statistics.median(ps)


def phase_timing():
    import torch

    from zeldovich_tpu_torch.ops.c2r import c2r_y, c2r_y_plain
    from zeldovich_tpu_torch.ops.synth import (
        halfspace_pack_zx, halfspace_pack_zx_plain,
    )

    say(f"== phase 4: forward step timing on {smi()}")
    per_kernel = {}
    for ppd, plt in ((512, False), (512, True)):
        m = model_for(ppd, plt)
        a = (m.cfg, m.tables, m.pk_eff, m.plt_coefs)
        g = halfspace_pack_zx(*a)
        b1 = _turns(lambda: halfspace_pack_zx(*a), lambda: halfspace_pack_zx_plain(*a))
        b2 = _turns(lambda: c2r_y(g, ppd), lambda: c2r_y_plain(g, ppd))
        del g
        step = _turns(lambda: c2r_y(halfspace_pack_zx(*a), ppd),
                      lambda: c2r_y_plain(halfspace_pack_zx_plain(*a), ppd))
        tag = f"{ppd}^3 {'PLT' if plt else 'plain'} f32"
        for name, (k, p) in (("B1", b1), ("B2", b2), ("step", step)):
            say(f"  {tag} {name}: kernel {k:.3f} ms, plain {p:.3f} ms"
                + (f"; {ppd**3 / k / 1e3:.1f} vs {ppd**3 / p / 1e3:.1f} Mpart/s"
                   if name == "step" else ""))
        if not plt:
            per_kernel = {"b1": b1, "b2": b2}
        del m, a
        torch.cuda.empty_cache()

    m = model_for(1024, False)
    a = (m.cfg, m.tables, m.pk_eff, m.plt_coefs)
    step = lambda: c2r_y(halfspace_pack_zx(*a), 1024)  # noqa: E731
    _time(step)  # warm-up
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = [_time(step) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated()
    say(f"  1024^3 plain f32 step: kernel {sorted(ms)[1]:.3f} ms "
        f"({1024**3 / sorted(ms)[1] / 1e3:.1f} Mpart/s), peak "
        f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB of setup fields)")
    del m, a
    torch.cuda.empty_cache()
    return per_kernel


def _run_cli(par: Path) -> dict:
    """cli.main on a .par; returns the parsed QA statistics."""
    from zeldovich_tpu_torch import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main([str(par)])
    text = err.getvalue()
    for line in text.splitlines():
        if "took" in line or "rms" in line or "displacements" in line:
            say("  " + line)
    check(rc == 0, f"cli exited {rc}:\n{text}")
    rms = float(re.search(r"pixels is (\S+)", text).group(1))
    disp = re.search(r"displacements are \((\S+), (\S+), (\S+)\)", text).groups()
    qa = {"rms": rms, "max_disp": [float(v) for v in disp]}
    check(all(math.isfinite(v) for v in [rms, *qa["max_disp"]]), f"QA {qa}")
    return qa


def _ic_files(d: Path, ppd: int, cpd: int):
    """The ic_* files: one per slab file index z*cpd//ppd, 32 B a particle."""
    files = sorted(d.glob("ic_*"))
    total = sum(f.stat().st_size for f in files)
    nfiles = len({z * cpd // ppd for z in range(ppd)})
    say(f"  {len(files)} ic_* files, {total} bytes")
    check(len(files) == nfiles, f"wrote {len(files)} files, want {nfiles}")
    check(total == ppd**3 * 32, f"wrote {total} bytes, want {ppd**3 * 32}")
    return files


def phase_end_to_end():
    import numpy as np
    import torch

    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.models.pipeline import OutputWriter, Parameters
    from zeldovich_tpu_torch.ops.c2r import c2r_y_plain
    from zeldovich_tpu_torch.ops.synth import halfspace_pack_zx_plain
    from zeldovich_tpu_torch.utils.streamio import stream_xspace

    say("== phase 5: end to end through zeldovich_tpu_torch.cli.main")
    tmp = Path(tempfile.mkdtemp(prefix="zt_smoke_"))
    try:
        runs = {}
        kernels.reset_launches()
        for name, ppd, plt in (("example", 128, True), ("plain256", 256, False),
                               ("plt512", 512, True)):
            par = tmp / f"{name}.par"
            if name == "example":
                text = EXAMPLE.read_text()
                text = re.sub(r"InitialConditionsDirectory.*",
                              f'InitialConditionsDirectory = "{tmp / name}"', text)
                text = re.sub(r'(ZD_\w+_filename\s*=\s*)"zeldovich_tpu/',
                              rf'\1"{ROOT}/zeldovich_tpu/', text)
                par.write_text(text)
            else:
                par.write_text(par_text(ppd, tmp / name, plt))
            say(f"-- {name}: {ppd}^3 {'PLT' if plt else 'plain'}")
            runs[name] = _run_cli(par)
            _ic_files(tmp / name, ppd, cpd_for(ppd))
            if name != "example":
                shutil.rmtree(tmp / name)
        launches = dict(kernels.launches)
        say(f"  launches during the runs: {launches}")
        for k, v in launches.items():
            check(v >= 1, f"kernel {k} never launched on the main path")

        say("-- example.par through the plain route, particle by particle")
        param = Parameters.from_file(tmp / "example.par")
        param.output_dir = str(tmp / "plain")
        (tmp / "plain").mkdir()
        m = model_for(128, True)
        x = c2r_y_plain(halfspace_pack_zx_plain(m.cfg, m.tables, m.pk_eff,
                                                m.plt_coefs), 128)
        writer = OutputWriter(param)
        with contextlib.redirect_stderr(io.StringIO()):
            stream_xspace(x, writer)
        files = _ic_files(tmp / "example", 128, cpd_for(128))
        worst = {"displ": 0.0, "vel": 0.0}
        for f in files:
            # the writer's RVZel record layout, as read_particles reads it
            got = np.fromfile(f, dtype=writer.dtype)
            want = np.fromfile(tmp / "plain" / f.name, dtype=writer.dtype)
            for c in ("i", "j", "k"):
                check(np.array_equal(got[c], want[c]), f"{f.name} {c} differs")
            for c in ("displ", "vel"):
                scale = float(np.abs(want[c]).max())
                err = float(np.abs(got[c] - want[c]).max())
                worst[c] = max(worst[c], err / scale)
        say(f"  worst |kernel - plain| / max: displ {worst['displ']:.3e}, "
            f"vel {worst['vel']:.3e} (tol {PARTICLE_TOL:g})")
        check(max(worst.values()) <= PARTICLE_TOL, "particles differ")
        del x, m
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
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
    phase_card()
    errs = phase_kernels()
    per_kernel = phase_timing()
    launches = phase_end_to_end()
    card = smi()
    summary = {"kernels": [
        {"name": "halfspace_pack_zx", "route": "cuda",
         "source": "zeldovich_tpu_torch/csrc/synth.cu",
         "replaces": "zeldovich_tpu/ops/pallas_synth.py:946",
         "launches": launches["halfspace_pack_zx"],
         "max_abs_err": errs[("b1", 512)],
         "ms": per_kernel["b1"][0], "plain_ms": per_kernel["b1"][1]},
        {"name": "c2r_y", "route": "cuda",
         "source": "zeldovich_tpu_torch/csrc/c2r.cu",
         "replaces": "zeldovich_tpu/ops/pallas_fft.py:700",
         "launches": launches["c2r_y"],
         "max_abs_err": errs[("b2", 512)],
         "ms": per_kernel["b2"][0], "plain_ms": per_kernel["b2"][1]},
    ]}
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s "
        "(max_abs_err and ms at 512^3 plain f32)")
    say(card)
    say(json.dumps(summary))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
