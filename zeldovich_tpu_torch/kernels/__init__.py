"""Build, load and launch the hand-written CUDA kernels.

The sources under ``zeldovich_tpu_torch/csrc`` are compiled with nvcc for
``sm_90a``, one nvcc process per ``.cu`` file, all started together, and
linked into one shared library with a plain C interface, at first use,
into ``zeldovich_tpu_torch/_build/`` (rebuilt when a source is newer than
the library), and loaded with ctypes.  Nothing is built when this module
is imported, and nothing here falls back: a missing compiler, a failed
build or a failed launch raises.

Every kernel exists for float32 and float64: ``X.cu`` holds the templates
and instantiates them for float, ``X_f64.cu`` includes it with the element
type set to double and exports the same entry points as ``*_f64``.  A
launch wrapper picks the entry by the dtype of the tensor it writes.

Each launch wrapper adds one to its entry of ``launches`` (one counter a
kernel, whatever the element type); a run reads the counts to show that
its main path went through the kernels.  The PLT coefficient kernel
counts in ``plt_launches`` instead: the benchmark's work model
(bench_torch/kernelwork.py) reckons the work of every key of
``launches`` and has no entry for it yet.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
LIB = BUILD / "libzt_kernels.so"
LOG = BUILD / "build.log"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name -> number of launches since the last reset_launches()
launches = {"halfspace_pack_zx": 0, "c2r_y": 0, "halfspace_boxmuller": 0,
            "zx_dft": 0, "y_dft": 0, "boxmuller": 0, "halfspace_pack": 0}

#: launches of the PLT coefficient kernel (launch_plt_coefs) since the last
#: reset_launches()
plt_launches = 0

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the kernels' element types -> (entry-point suffix, the C type of a scalar)
REAL = {torch.float32: ("", ctypes.c_float), torch.float64: ("_f64", ctypes.c_double)}


def reset_launches():
    global plt_launches
    for k in launches:
        launches[k] = 0
    plt_launches = 0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build(force: bool = False) -> float:
    """Compile the library if stale; returns the seconds spent compiling.

    One nvcc per source, all running at once, then one link; the
    compilers' output (ptxas register and spill reports) goes to LOG.
    """
    srcs = _sources()
    if (not force and LIB.exists()
            and LIB.stat().st_mtime >= max(s.stat().st_mtime for s in srcs)):
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD) as work:
        work = Path(work)
        jobs, report, failed = [], [], []
        try:
            for src in (s for s in srcs if s.suffix == ".cu"):
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"),
                       str(src)]
                log = open(work / f"{src.stem}.log", "w+")
                jobs.append((cmd, log, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
            for cmd, log, proc in jobs:
                rc = proc.wait()
                log.seek(0)
                text = log.read()
                report.append(" ".join(cmd) + "\n" + text)
                if rc != 0:
                    failed.append(f"{cmd[-1]} ({rc}):\n{text}")
        finally:
            for _, log, proc in jobs:  # none outlives the build
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        if not failed:
            tmp = work / LIB.name
            cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp),
                   *[str(work / f"{src.stem}.o")
                     for src in srcs if src.suffix == ".cu"]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            report.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
        LOG.write_text("\n".join(report))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, LIB)
    return time.perf_counter() - t0


def ptxas_report() -> list[str]:
    """Per-kernel registers, shared memory and spills from the build log,
    each line ``<entry> [<source>]: ...``.  ptxas also reports the device
    functions it did not inline (the double sincos's large-argument
    reduction): those lines read ``<function> in <entry> [<source>]``."""
    if not LOG.exists():
        return []
    out, entry, fn, src = [], None, None, "?"
    for line in LOG.read_text().splitlines():
        cu = re.search(r" -c -o \S+ \S*?(\w+)\.cu$", line)
        m = re.search(r"Compiling entry function '(\w+)'", line)
        f = re.search(r"Function properties for (\w+)", line)
        if cu:  # an nvcc command line: the source of the entries below
            src = cu.group(1)
        elif m:
            entry = fn = m.group(1)
        elif f:
            fn = f.group(1)
        elif entry and ("Used" in line or "spill" in line):
            who = entry if fn == entry or "Used" in line else f"{fn} in {entry}"
            out.append(f"{who} [{src}]: {line.split(':', 1)[-1].strip()}")
    return out


_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB))
        for suffix, R in REAL.values():
            for name, argtypes in (
                    ("zt_b1_pack_zx", [_VP] * 7 + [_I] * 3 + [R, R] + [_I] * 3 + [_VP]),
                    ("zt_b2_c2r_y", [_VP] * 3 + [_I, _LL] + [_I] * 3 + [_VP]),
                    ("zt_b4_boxmuller", [_VP] * 7 + [_I] * 4 + [_VP]),
                    ("zt_b5_boxmuller_at", [_VP] * 10 + [_LL, _I, _I, _I, _VP]),
                    ("zt_b3_pack", [_VP] * 6 + [_I] * 3 + [R, R, _I, _VP]),
                    ("zt_zx_dft", [_VP] * 3 + [_I, _I, _LL, _I, _VP]),
                    ("zt_y_dft", [_VP] * 3 + [_I, _LL, _LL, _I, _VP]),
                    ("zt_plt_coefs", [_VP] * 2 + [_I] * 9 + [R] * 6 + [_I, _I, _VP])):
                fn = getattr(lib, name + suffix)
                fn.restype, fn.argtypes = _I, argtypes
        lib.zt_error_string.restype = ctypes.c_char_p
        lib.zt_error_string.argtypes = [_I]
        _lib = lib
    return _lib


def _check(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.zt_error_string(rc).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _entry(lib, name: str, out: torch.Tensor):
    """The entry point `name` of out's element type (float32 or float64)."""
    if out.dtype not in REAL:
        raise TypeError(f"{name}: the kernels are float32 and float64, got {out.dtype}")
    return getattr(lib, name + REAL[out.dtype][0])


def launch_pack_zx(planes64, mzx64, czx64, pk, coefs, tw, out, n, narray,
                   flags, fund, fund2, ky0):
    """B1: synthesis + packing + ky=0 fixup + x/z inverse DFTs of the
    generated planes [ky0, ky0 + len(pk)) into out."""
    lib = library()
    rc = _entry(lib, "zt_b1_pack_zx", out)(
        planes64.data_ptr(), mzx64.data_ptr(), czx64.data_ptr(),
        pk.data_ptr(), None if coefs is None else coefs.data_ptr(),
        tw.data_ptr(), out.data_ptr(), n, narray, flags, fund, fund2, ky0,
        pk.shape[0], out.device.index, _stream(out),
    )
    _check(lib, rc, "halfspace_pack_zx")
    launches["halfspace_pack_zx"] += 1


def launch_c2r_y(g, tw, out, n, narray, has_nyq):
    """B2: half-spectrum c2r inverse DFT along y into out (out may be g
    when it has no Nyquist row)."""
    lib = library()
    rc = _entry(lib, "zt_b2_c2r_y", out)(
        g.data_ptr(), tw.data_ptr(), out.data_ptr(), n,
        g.shape[-2] * g.shape[-1], narray, int(has_nyq), out.device.index,
        _stream(out),
    )
    _check(lib, rc, "c2r_y")
    launches["c2r_y"] += 1


def launch_boxmuller(planes64, mzx64, czx64, pk, live, re, im, n, half,
                     fixed_power):
    """B4: draws + Box-Muller over the `half` generated planes whose start
    states are planes64's rows, into re, im."""
    lib = library()
    rc = _entry(lib, "zt_b4_boxmuller", re)(
        planes64.data_ptr(), mzx64.data_ptr(), czx64.data_ptr(), pk.data_ptr(),
        None if live is None else live.data_ptr(), re.data_ptr(), im.data_ptr(),
        n, half, int(fixed_power), re.device.index, _stream(re),
    )
    _check(lib, rc, "halfspace_boxmuller")
    launches["halfspace_boxmuller"] += 1


def launch_boxmuller_at(sy, sz, sx, planes64, mzx64, czx64, pk, live, re, im,
                        count, n, fixed_power):
    """B5: draws + Box-Muller at per-mode source indices into re, im."""
    lib = library()
    rc = _entry(lib, "zt_b5_boxmuller_at", re)(
        sy.data_ptr(), sz.data_ptr(), sx.data_ptr(), planes64.data_ptr(),
        mzx64.data_ptr(), czx64.data_ptr(), pk.data_ptr(), live.data_ptr(),
        re.data_ptr(), im.data_ptr(), count, n, int(fixed_power),
        re.device.index, _stream(re),
    )
    _check(lib, rc, "boxmuller")
    launches["boxmuller"] += 1


def launch_halfspace_pack(planes64, mzx64, czx64, pk, coefs, out, n, narray,
                          flags, fund, fund2):
    """B3: the packed half spectrum (ky=0 raw, Nyquist row zero) into out."""
    lib = library()
    rc = _entry(lib, "zt_b3_pack", out)(
        planes64.data_ptr(), mzx64.data_ptr(), czx64.data_ptr(),
        pk.data_ptr(), None if coefs is None else coefs.data_ptr(),
        out.data_ptr(), n, narray, flags, fund, fund2, out.device.index,
        _stream(out),
    )
    _check(lib, rc, "halfspace_pack")
    launches["halfspace_pack"] += 1


def launch_zx_dft(pair, out, tw, n, K, batch):
    """B6/B7: DFT over (z, x) of (batch, 2, K, n, n) pairs into out."""
    lib = library()
    rc = _entry(lib, "zt_zx_dft", out)(
        pair.data_ptr(), out.data_ptr(), tw.data_ptr(), n, K, batch,
        out.device.index, _stream(out))
    _check(lib, rc, "zx_dft")
    launches["zx_dft"] += 1


def launch_y_dft(pair, out, tw, n, inner, batch):
    """B8: DFT along y of (batch, 2, n, inner) pairs into out."""
    lib = library()
    rc = _entry(lib, "zt_y_dft", out)(
        pair.data_ptr(), out.data_ptr(), tw.data_ptr(), n, inner, batch,
        out.device.index, _stream(out))
    _check(lib, rc, "y_dft")
    launches["y_dft"] += 1


#: the PLT coefficient kernel's most threads a block (csrc/plt.cu's
#: PLT_THREADS) and the z rows a block walks
PLT_THREADS, PLT_ZT = 128, 8


def nyquist_fix(f, eig_ppd: int):
    """The lookup's rule at the +/- Nyquist discontinuity of the table
    (ops/plt.py): f in (E/2, E/2 + 1) moves up to E/2 + 1."""
    return np.where((f > eig_ppd // 2) & (f < eig_ppd // 2 + 1), np.floor(f + 1), f)


def plt_geometry(n: int, eig_ppd: int, dtype) -> dict:
    """The PLT coefficient kernel's launch at ppd n on a table of eig_ppd:
    ``vec`` x a thread (16-byte stores; 8-byte float ones where n % 4),
    ``threads`` a block (a tile of threads * vec x), ``zt`` z rows a block,
    ``step`` (E / n where n divides E, the direct gather; else 0),
    ``scale`` = fl(E / n) in dtype, and ``cap``: the most table x entries
    a tile stages when the lookup interpolates, computed in dtype as the
    kernel computes each tile's range (its first x's lower neighbour to
    its last x's upper one)."""
    npf = np.float32 if dtype == torch.float32 else np.float64
    vec = 4 if npf is np.float32 and n % 4 == 0 else 2
    threads = min(PLT_THREADS, (n // vec + 31) // 32 * 32)
    step = eig_ppd // n if eig_ppd % n == 0 else 0
    scale = npf(eig_ppd) / npf(n)
    cap = 0
    if not step:
        ixl = nyquist_fix(scale * np.arange(n, dtype=npf), eig_ppd).astype(np.int64)
        x0 = np.arange(0, n, threads * vec)
        cap = int((ixl[np.minimum(x0 + threads * vec, n) - 1] + 2 - ixl[x0]).max())
        izl = int(nyquist_fix(scale * npf(n // 2), eig_ppd))
        if izl > eig_ppd // 2:
            raise ValueError(f"ppd {n} on a {eig_ppd} eigenmode table: the lookup "
                             f"of kz = {n // 2} lands at iz {izl}, outside the table")
    return {"vec": vec, "threads": threads, "zt": PLT_ZT, "step": step,
            "scale": float(scale), "cap": cap}


def launch_plt_coefs(eig, out, y0, fund, fund2, f_cluster, rescale_base,
                     target_f, rescale):
    """The PLT coefficient planes (cx, cy, cz, f) of the generated planes
    [y0, y0 + rows) into out (4, rows, n, n), from the float64 eigenmode
    table eig (E, E, E/2 + 1, 4): one launch.  The scalars are the plain
    version's, rounded to out's element type."""
    if out.dtype not in REAL:
        raise TypeError(f"plt_coefs: the kernel is float32 and float64, got {out.dtype}")
    E = eig.shape[0] if eig.dim() == 4 else -1
    if eig.dtype != torch.float64 or tuple(eig.shape) != (E, E, E // 2 + 1, 4):
        raise ValueError(f"plt_coefs: want a float64 (E, E, E/2 + 1, 4) eigenmode "
                         f"table, got {eig.dtype} {tuple(eig.shape)}")
    if out.dim() != 4 or out.shape[0] != 4 or out.shape[2] != out.shape[3]:
        raise ValueError(f"plt_coefs: want out (4, rows, n, n), got {tuple(out.shape)}")
    n, rows = out.shape[3], out.shape[1]
    if n % 2 or not (n >= 2 and rows >= 1 and 0 <= y0 and y0 + rows <= n // 2):
        raise ValueError(f"plt_coefs: planes [{y0}, {y0 + rows}) of ppd {n}: want an "
                         f"even ppd and 0 <= y0 < y0 + rows <= ppd/2")
    if not (eig.is_contiguous() and out.is_contiguous()):
        raise ValueError("plt_coefs: the table and out must be contiguous")
    if eig.device.type != "cuda" or out.device != eig.device:
        raise ValueError(f"plt_coefs: want both on one CUDA device, got the table on "
                         f"{eig.device} and out on {out.device}")
    if eig.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("plt_coefs: the table and out must be 16-byte aligned")
    g = plt_geometry(n, E, out.dtype)
    if 16 * g["cap"] * out.element_size() > 232448:
        raise ValueError(f"plt_coefs: ppd {n} on a {E} table stages {g['cap']} x "
                         "entries a block, past the card's 227 KB of shared memory")
    lib = library()
    rc = _entry(lib, "zt_plt_coefs", out)(
        eig.data_ptr(), out.data_ptr(), n, E, y0, rows, g["step"], g["cap"],
        g["threads"], g["vec"], g["zt"], g["scale"], fund, fund2, f_cluster,
        rescale_base, target_f, int(rescale), out.device.index, _stream(out))
    _check(lib, rc, "plt_coefs")
    global plt_launches
    plt_launches += 1
