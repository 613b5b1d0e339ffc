"""Native runtime: threaded particle pack/IO (C++, loaded via ctypes).

Compiled on demand with the system C++ compiler into the package's
gitignored ``_build/`` directory (never the JAX package's library); every
entry point has a pure-numpy fallback in utils/output.py, so the package
works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "packio.cpp"
_OUT = Path(__file__).resolve().parent.parent / "_build" / "libzt_packio.so"
_LIB: ctypes.CDLL | None = None
_TRIED = False

FORMAT_CODES = {"RVZel": 0, "RVdoubleZel": 1, "Zeldovich": 2, "ZelSimple": 3}


def _build() -> Path | None:
    out = _OUT
    if out.exists() and out.stat().st_mtime >= _SRC.stat().st_mtime:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-std=c++17",
        "-pthread",
        str(_SRC),
        "-o",
        str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # whole, even with several processes building
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        tmp.unlink(missing_ok=True)
        return None
    return out


def load() -> ctypes.CDLL | None:
    """The native library, or None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("ZT_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.zt_pack_slab.restype = ctypes.c_long
    lib.zt_pack_slab.argtypes = [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_long,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.zt_append.restype = ctypes.c_long
    lib.zt_append.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_int,
    ]
    lib.zt_zero_buffer.restype = None
    lib.zt_zero_buffer.argtypes = [ctypes.c_void_p, ctypes.c_long]
    _LIB = lib
    return _LIB


def pack_slab(
    icformat: str,
    z: int,
    slabs: np.ndarray,
    qplt: bool,
    vnorm: float,
    out: np.ndarray,
    stats: np.ndarray,
    nthreads: int = 0,
) -> bool:
    """Native decode+pack of one z-slab into ``out`` (raw bytes).

    slabs: (narray, ppd, ppd) complex128, C-contiguous.
    stats: float64[4] {sumsq, max_x, max_y, max_z}, updated in place.
    Returns False if the native library is unavailable.
    """
    lib = load()
    if lib is None:
        return False
    ppd = slabs.shape[-1]
    A = np.ascontiguousarray(slabs[0])
    B = np.ascontiguousarray(slabs[1]) if slabs.shape[0] > 1 else A
    if qplt:
        V1 = np.ascontiguousarray(slabs[2])
        V2 = np.ascontiguousarray(slabs[3])
        v1p, v2p = V1.ctypes.data, V2.ctypes.data
    else:
        v1p = v2p = None
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    rc = lib.zt_pack_slab(
        FORMAT_CODES[icformat],
        z,
        ppd,
        A.ctypes.data,
        B.ctypes.data,
        v1p,
        v2p,
        int(qplt),
        vnorm,
        out.ctypes.data,
        stats.ctypes.data,
        nthreads,
    )
    return rc > 0


def append(path, buf: np.ndarray, direct: bool = False) -> bool:
    lib = load()
    if lib is None:
        return False
    rc = lib.zt_append(str(path).encode(), buf.ctypes.data, buf.nbytes, int(direct))
    return rc == buf.nbytes
