#!/usr/bin/env python3
"""Trees of the PyTorch + CUDA port on one GPU, in turns A, B, B, A.

    python3 scripts/torch_axis_turns.py A_ROOT B_ROOT [C_ROOT ...] [--out FILE]
                                        [--dtype float32|float64]

With more than two trees the turns go forward and back: A, B, C, C, B, A.
One tree given twice (``. .``) is timed alone, as both A and B.

Each turn is a fresh process that imports ``zeldovich_tpu_torch`` from
its tree's root (building that tree's kernels into its own ``_build/``)
and measures, in ``--dtype`` (float32 unless given; float64 needs trees
whose kernels have the double instances), CUDA events around several
launches:

* zx_dft and y_dft at the shapes the paths launch (chip_smoke.py's
  ZX_SHAPES and Y_SHAPES), out of place, sign +1, and zx's z pass alone
  (y_dft on (B K, 2, n, 1, n): the same tiles, columns and strides as the
  column kernel's launch inside zx_dft on (B, 2, K, n, n));
* B1 (halfspace_pack_zx) and B2 (c2r_y, out of place) at 512^3 plain,
  and the tree's 512^3 plain half step (``Zeldovich.xspace_half_pair``)
  with its device time by kernel (torch.profiler);
* the draw kernels, which share csrc/pcg.cuh: B4 (halfspace_boxmuller) at
  512^3 and 1024^3, drawn and fixed power, B3 (halfspace_pack) at 512^3
  and B5 (boxmuller) on the 16.8M-mode chunk of the y0 = 0 slab at 512^3,
  each with a SHA-256 of its output's bytes (B1's too);
* one 512^3 f_NL full-grid step: the wall of the step (median of 5) and
  its device time by kernel; the device time of one 512^3 CornerModes
  (k_cutoff = 2) step and of one 1024^3 f_NL step.

Each turn prints one JSON line; the parent process prints every turn and a table
of medians per tree, says for each hashed output whether every tree gave
the same bits (and exits 1 if one did not), and writes all turns to --out
(JSON).  Compare trees only within one call: the card and its power limit
are printed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ZX_SHAPES = ((2, 2, 512, 512, 512), (2, 2, 128, 1024, 1024), (2, 2, 32, 2048, 2048))
Y_SHAPES = ((2, 2, 512, 512, 512), (2, 2, 1024, 128, 1024), (2, 2, 2048, 32, 2048))
ZCOLS_SHAPES = tuple((b * k, 2, n, 1, n) for b, _, k, n, _ in ZX_SHAPES)


def _per_call(fn, reps):
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _by_kernel(fn) -> dict:
    """Device ms by kernel of one call of fn (torch.profiler), largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by[e.key[:90]] = by.get(e.key[:90], 0.0) + e.self_device_time_total / 1e3
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def _digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _model(cs, dt, n, plt, **extra):
    """chip_smoke.model_for of the tree in dt (a tree from before the
    double instances takes no element type: float32)."""
    kw = {} if dt == "float32" else {"dt": dt}
    return cs.model_for(n, plt, device="cuda", **kw, **extra)


def _draw_kernels(cs, res: dict, dt: str):
    """B4, B3 and B5 of the tree: ms and the digests of their outputs."""
    import torch

    from zeldovich_tpu_torch.ops.boxmuller import boxmuller, halfspace_boxmuller
    from zeldovich_tpu_torch.ops.modes_real import draw_operands, slab_modes
    from zeldovich_tpu_torch.ops.synth import halfspace_pack

    res["b4"], res["bits"] = {}, res.get("bits", {})
    for n in (512, 1024):
        m = _model(cs, dt, n, False)
        for fixed in (False, True):
            key = f"{n}^3" + (" fixed power" if fixed else "")
            res["b4"][key] = _per_call(
                lambda: halfspace_boxmuller(m.tables, m.pk_eff, fixed), 10)
            if n == 512 or not fixed:
                res["bits"][f"B4 {key}"] = _digest(
                    *halfspace_boxmuller(m.tables, m.pk_eff, fixed))
        if n == 512:
            a = (m.cfg, m.tables, m.pk_eff, m.plt_coefs)
            res["b3"] = _per_call(lambda: halfspace_pack(*a), 10)
            res["bits"]["B3 512^3"] = _digest(halfspace_pack(*a))
            ops = draw_operands(slab_modes(0, 64, 512, "cuda"), m.cfg, m.tables,
                                getattr(torch, dt))
            res["b5"] = _per_call(lambda: boxmuller(m.tables, *ops, False), 10)
            res["bits"]["B5 16.8M modes"] = _digest(*boxmuller(m.tables, *ops, False))
            del a, ops
        del m
        torch.cuda.empty_cache()


def worker(root: Path, dt: str) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.ops.c2r import c2r_y
    from zeldovich_tpu_torch.ops.fft import y_dft, zx_dft
    from zeldovich_tpu_torch.ops.synth import halfspace_pack_zx

    assert Path(kernels.__file__).resolve().is_relative_to(root.resolve())
    kernels.library()
    res = {"root": str(root), "dtype": dt, "zx": {}, "y": {}, "zcols": {}}
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, fn, shapes in (("zx", zx_dft, ZX_SHAPES), ("y", y_dft, Y_SHAPES),
                             ("zcols", y_dft, ZCOLS_SHAPES)):
        for shape in shapes:
            x = torch.randn(shape, device="cuda", generator=gen, dtype=getattr(torch, dt))
            out = torch.empty_like(x)
            res[name][str(shape)] = _per_call(lambda: fn(x, +1, out=out), 10)
            del x, out
            torch.cuda.empty_cache()

    m = _model(cs, dt, 512, False)
    a = (m.cfg, m.tables, m.pk_eff, m.plt_coefs)
    res["b1"] = _per_call(lambda: halfspace_pack_zx(*a), 10)
    g = halfspace_pack_zx(*a)
    res["bits"] = {"B1 512^3": _digest(g)}
    res["b2"] = _per_call(lambda: c2r_y(g, 512), 10)
    del g
    torch.cuda.empty_cache()
    res["half_step_ms"] = _per_call(lambda: m.xspace_half_pair(), 10)
    res["half_kernels"] = _by_kernel(lambda: m.xspace_half_pair())
    del m, a
    torch.cuda.empty_cache()

    m = _model(cs, dt, 512, False, **cs.FNL)
    _ = m.pk_eff
    m.xspace_pair()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        walls.append(_per_call(lambda: m.xspace_pair(), 1))
    res["fnl_step_ms"] = statistics.median(walls)
    by = _by_kernel(lambda: m.xspace_pair())
    res["fnl_device_ms"] = sum(by.values())
    res["fnl_kernels"] = dict(list(by.items())[:8])
    del m
    torch.cuda.empty_cache()

    m = _model(cs, dt, 512, False, **cs.CORNER)
    _ = m.pk_eff
    res["corner_device_ms"] = sum(_by_kernel(lambda: m.xspace_pair()).values())
    del m
    torch.cuda.empty_cache()
    m = _model(cs, dt, 1024, False, **cs.FNL)
    _ = m.pk_eff
    res["fnl1024_device_ms"] = sum(_by_kernel(lambda: m.xspace_pair()).values())
    del m
    torch.cuda.empty_cache()
    _draw_kernels(cs, res, dt)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--worker", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    args = ap.parse_args()
    if args.worker:
        print("TURN " + json.dumps(worker(Path(args.worker), args.dtype)), flush=True)
        return 0
    roots = [Path(r).resolve() for r in args.roots]
    if len(roots) < 2:
        ap.error("give two or more trees")
    labels = [chr(ord("A") + i) for i in range(len(roots))]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    turns = []
    order = list(zip(labels, roots))
    for label, root in order + order[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root),
                               "--dtype", args.dtype],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.split("TURN ", 1)[1])
        res["tree"] = label
        turns.append(res)
        print(f"{label} {json.dumps(res)}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card.stdout.strip(), "dtype": args.dtype, "turns": turns}))

    def med(label, get):
        return statistics.median(get(r) for r in turns if r["tree"] == label)

    rows = [(f"{n} {s}", lambda r, n=n, s=s: r[n][str(s)])
            for n, shapes in (("zx", ZX_SHAPES), ("y", Y_SHAPES), ("zcols", ZCOLS_SHAPES))
            for s in shapes]
    rows += [(f"B4 {k}", lambda r, k=k: r["b4"][k]) for k in turns[0]["b4"]]
    rows += [("B3 512^3", lambda r: r["b3"]), ("B5 16.8M modes", lambda r: r["b5"]),
             ("512^3 CornerModes step device", lambda r: r["corner_device_ms"]),
             ("1024^3 f_NL step device", lambda r: r["fnl1024_device_ms"])]
    rows += [("B1 512^3", lambda r: r["b1"]), ("B2 512^3", lambda r: r["b2"]),
             ("512^3 plain half step", lambda r: r["half_step_ms"]),
             ("512^3 plain half step device", lambda r: sum(r["half_kernels"].values())),
             ("512^3 f_NL step wall", lambda r: r["fnl_step_ms"]),
             ("512^3 f_NL step device", lambda r: r["fnl_device_ms"])]
    print(f"{args.dtype + ' ms (median of 2 turns)':40s}" + "".join(f"{x:>10s}" for x in labels))
    for what, get in rows:
        print(f"{what:40s}" + "".join(f"{med(x, get):10.3f}" for x in labels))
    same = True
    for what in turns[0]["bits"]:
        digests = {r["bits"][what] for r in turns}
        same &= len(digests) == 1
        print(f"bits of {what}: "
              + ("identical in every turn" if len(digests) == 1 else "DIFFER between trees"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
