"""Build, load and launch the hand-written CUDA kernels.

The sources under ``zeldovich_tpu_torch/csrc`` are compiled with nvcc for
``sm_90a``, one nvcc process per ``.cu`` file, all started together, and
linked into one shared library with a plain C interface, at first use,
into ``zeldovich_tpu_torch/_build/`` (rebuilt when a source is newer than
the library), and loaded with ctypes.  Nothing is built when this module
is imported, and nothing here falls back: a missing compiler, a failed
build or a failed launch raises.

Each launch wrapper adds one to its entry of ``launches``; a run reads the
counts to show that its main path went through the kernels.
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

_VP, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def reset_launches():
    for k in launches:
        launches[k] = 0


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
    """Per-kernel registers, shared memory and spills from the build log."""
    if not LOG.exists():
        return []
    out, name = [], None
    for line in LOG.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("Used" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB))
        lib.zt_b1_pack_zx.restype = _I
        lib.zt_b1_pack_zx.argtypes = [_VP] * 7 + [_I] * 3 + [_F, _F] + [_I] * 3 + [_VP]
        lib.zt_b2_c2r_y.restype = _I
        lib.zt_b2_c2r_y.argtypes = [_VP] * 3 + [_I, _LL] + [_I] * 3 + [_VP]
        lib.zt_b4_boxmuller.restype = _I
        lib.zt_b4_boxmuller.argtypes = [_VP] * 7 + [_I] * 4 + [_VP]
        lib.zt_b5_boxmuller_at.restype = _I
        lib.zt_b5_boxmuller_at.argtypes = [_VP] * 10 + [_LL, _I, _I, _I, _VP]
        lib.zt_b3_pack.restype = _I
        lib.zt_b3_pack.argtypes = [_VP] * 6 + [_I] * 3 + [_F, _F, _I, _VP]
        lib.zt_zx_dft.restype = _I
        lib.zt_zx_dft.argtypes = [_VP] * 3 + [_I, _I, _LL, _I, _VP]
        lib.zt_y_dft.restype = _I
        lib.zt_y_dft.argtypes = [_VP] * 3 + [_I, _LL, _LL, _I, _VP]
        lib.zt_error_string.restype = ctypes.c_char_p
        lib.zt_error_string.argtypes = [_I]
        _lib = lib
    return _lib


def _check(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.zt_error_string(rc).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_pack_zx(planes64, mzx64, czx64, pk, coefs, tw, out, n, narray,
                   flags, fund, fund2, ky0):
    """B1: synthesis + packing + ky=0 fixup + x/z inverse DFTs of the
    generated planes [ky0, ky0 + len(pk)) into out."""
    lib = library()
    rc = lib.zt_b1_pack_zx(
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
    rc = lib.zt_b2_c2r_y(
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
    rc = lib.zt_b4_boxmuller(
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
    rc = lib.zt_b5_boxmuller_at(
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
    rc = lib.zt_b3_pack(
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
    rc = lib.zt_zx_dft(pair.data_ptr(), out.data_ptr(), tw.data_ptr(), n, K,
                       batch, out.device.index, _stream(out))
    _check(lib, rc, "zx_dft")
    launches["zx_dft"] += 1


def launch_y_dft(pair, out, tw, n, inner, batch):
    """B8: DFT along y of (batch, 2, n, inner) pairs into out."""
    lib = library()
    rc = lib.zt_y_dft(pair.data_ptr(), out.data_ptr(), tw.data_ptr(), n, inner,
                      batch, out.device.index, _stream(out))
    _check(lib, rc, "y_dft")
    launches["y_dft"] += 1
