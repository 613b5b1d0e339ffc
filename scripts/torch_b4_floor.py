#!/usr/bin/env python3
"""What sets kernel B4's floor on one GPU: timing-only copies, tile
variants and the SASS instruction count.

    python3 scripts/torch_b4_floor.py [--sweep] [--out FILE]

B4 (``zeldovich_tpu_torch/csrc/boxmuller.cu``, ``zt_b4_boxmuller``) draws
the Gaussian deviates of the generated half space.  This script builds a
small library that includes that source (so the tile constants, the
cache hints and ``pcg.cuh`` are the library's own) and adds two copies of
its kernel that compute nothing useful and are never held against
anything:

* ``no tables``: the same walk and the same arithmetic a mode, but the
  (z, x) jump map and the plane states come from index arithmetic instead
  of loads (what the jump-map traffic costs);
* ``no draws``: every load and store of the kernel, the jump map and the
  plane states included, but no draw arithmetic (what the bytes cost).

With ``--sweep`` it also builds the kernel at other tile constants: the
library's source has none to set, so each variant is a copy of ``csrc/``
with the ``constexpr`` lines of B4_TY, B4_U and B4_MIN_BLOCKS rewritten
(and, for the variant without cache hints, ``__ldcs``/``__stcs`` made
plain accesses), one nvcc each, in parallel.  It prints each build's
registers and spills, holds each variant's output bit for bit against the
package's kernel, and times all of them.  Times are float32 at 512^3 and
1024^3 (plain pk_eff of example.par's keys, drawn and fixed power), CUDA
events around 10 launches, two rounds in opposite order.  Then it reads
the SASS of the package's B4 kernels with ``cuobjdump -sass``: the static
instruction count of each instance, and the count and opcodes inside its
largest loop (the B4_U modes of one group).  Last it keeps the package's
kernel running at each size while ``nvidia-smi`` reads the SM clock, and
from that clock, the loop's count and the kernel's time gives the share
of the card's warp-instruction issue rate (SMs x 4 schedulers x clock)
that the kernel uses.  The card and its power limit are printed; --out
writes everything as JSON.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include "boxmuller.cu"

namespace {

// COPY 0: no table loads; COPY 1: no draw arithmetic
template <int COPY>
__global__ void __launch_bounds__(B4_THREADS, B4_MIN_BLOCKS) copy_kernel(
    const u64* __restrict__ planes, const u64* __restrict__ mzx,
    const u64* __restrict__ czx, const float* __restrict__ pk,
    float* __restrict__ re, float* __restrict__ im, int n, int half) {
  __shared__ u64 sp[2 * B4_TY];
  const int y0 = blockIdx.y * B4_TY;
  const int rows = min(B4_TY, half - y0);
  for (int i = threadIdx.x; i < 2 * rows; i += B4_THREADS)
    sp[i] = COPY == 0 ? 0x9E3779B97F4A7C15ULL * (u64)(2 * y0 + i + 1)
                      : __ldg(planes + 2 * (size_t)y0 + i);
  __syncthreads();
  const size_t nn = (size_t)n * n;
  const size_t zx = (size_t)blockIdx.x * B4_THREADS + threadIdx.x;
  if (zx >= nn) return;
  u128 m, c;
  if (COPY == 0) {
    m = ((u128)(0xBF58476D1CE4E5B9ULL * (zx + 1)) << 64) | (0x94D049BB133111EBULL * zx | 1);
    c = ((u128)(0xD6E8FEB86659FD93ULL * (zx + 3)) << 64) | (0xA0761D6478BD642FULL * zx | 1);
  } else {
    m = zt::load_u128(mzx + zx, mzx + nn + zx);
    c = zt::load_u128(czx + zx, czx + nn + zx);
  }
  const u64 fold = (u64)m ^ (u64)(m >> 64) ^ (u64)c ^ (u64)(c >> 64);
  size_t idx = (size_t)y0 * nn + zx;
  int j = 0;
  for (; j + B4_U <= rows; j += B4_U, idx += B4_U * nn) {
    float p[B4_U];
    float2 rt[B4_U];
#pragma unroll
    for (int u = 0; u < B4_U; ++u) p[u] = __ldcs(pk + idx + u * nn);
#pragma unroll
    for (int u = 0; u < B4_U; ++u) {
      const u128 st = ((u128)sp[2 * (j + u) + 1] << 64) | (u128)sp[2 * (j + u)];
      if (COPY == 0) {
        rt[u] = zt::mode_uniforms<float>(m * st + c);
      } else {
        const float bit = (float)(int)((fold ^ (u64)st ^ (u64)(st >> 64)) & 1);
        rt[u] = make_float2(bit, -bit);
      }
    }
#pragma unroll
    for (int u = 0; u < B4_U; ++u) {
      const float2 D = COPY == 0 ? zt::mode_deviate(rt[u], p[u], false, 1.0f)
                                 : make_float2(p[u] + rt[u].x, p[u] + rt[u].y);
      __stcs(re + idx + u * nn, D.x);
      __stcs(im + idx + u * nn, D.y);
    }
  }
  for (; j < rows; ++j, idx += nn) {
    const float pv = __ldcs(pk + idx);
    const u128 st = ((u128)sp[2 * j + 1] << 64) | (u128)sp[2 * j];
    float2 D;
    if (COPY == 0) {
      D = zt::gaussian_mode<float>(m * st + c, pv, false, 1.0f);
    } else {
      const float bit = (float)(int)((fold ^ (u64)st ^ (u64)(st >> 64)) & 1);
      D = make_float2(pv + bit, pv - bit);
    }
    __stcs(re + idx, D.x);
    __stcs(im + idx, D.y);
  }
}

}  // namespace

extern "C" int zt_b4_copy(int which, const void* planes, const void* mzx,
                          const void* czx, const void* pk, void* re, void* im, int n,
                          int half, void* stream) {
  const size_t nn = (size_t)n * n;
  const dim3 grid((unsigned)((nn + B4_THREADS - 1) / B4_THREADS),
                  (unsigned)((half + B4_TY - 1) / B4_TY));
  const cudaStream_t s = (cudaStream_t)stream;
  if (which == 0)
    copy_kernel<0><<<grid, B4_THREADS, 0, s>>>(
        (const u64*)planes, (const u64*)mzx, (const u64*)czx, (const float*)pk,
        (float*)re, (float*)im, n, half);
  else
    copy_kernel<1><<<grid, B4_THREADS, 0, s>>>(
        (const u64*)planes, (const u64*)mzx, (const u64*)czx, (const float*)pk,
        (float*)re, (float*)im, n, half);
  return (int)cudaGetLastError();
}
"""

#: tile variants of --sweep: (B4_TY, B4_U, B4_MIN_BLOCKS, cache hints)
SWEEP = ((32, 4, 4, 0), (32, 2, 4, 1), (32, 1, 4, 1), (16, 4, 4, 1), (64, 4, 4, 1),
         (128, 4, 4, 1), (32, 4, 3, 1), (32, 4, 2, 1), (32, 8, 2, 1), (32, 2, 6, 1),
         (32, 1, 8, 1))
CONSTANTS = ("B4_TY", "B4_U", "B4_MIN_BLOCKS")
_VP, _I = ctypes.c_void_p, ctypes.c_int


def _source_defaults() -> tuple:
    text = (ROOT / "zeldovich_tpu_torch" / "csrc" / "boxmuller.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                 for k in CONSTANTS) + (1,)


def _variant_text(text: str, v: tuple) -> str:
    """`text` (CUDA source) with the tile constants of variant `v`."""
    for k, x in zip(CONSTANTS, v):
        text, hits = re.subn(rf"(constexpr int {k} = )\d+;", rf"\g<1>{x};", text)
        if hits > 1:
            raise RuntimeError(f"{k} is defined {hits} times")
    if not v[3]:
        text = text.replace("__ldcs(", "__ldg(")
        text = re.sub(r"__stcs\(([^,;]+), ([^;]+)\);", r"*(\1) = \2;", text)
    return text


def build(variants) -> dict:
    """One library a variant, each from its own copy of csrc/, all nvcc
    processes at once; returns {variant: (CDLL, ptxas lines of the B4
    kernels)}."""
    from zeldovich_tpu_torch import kernels

    work = kernels.BUILD / "b4_floor"
    shutil.rmtree(work, ignore_errors=True)
    default = _source_defaults()
    jobs = {}
    for v in variants:
        vdir = work / "_".join(map(str, v))
        vdir.mkdir(parents=True)
        for name in ("boxmuller.cu", "pcg.cuh", "real.cuh"):
            text = (kernels.CSRC / name).read_text()
            (vdir / name).write_text(text if v == default else _variant_text(text, v))
        src = vdir / "b4_floor.cu"
        src.write_text(SOURCE if v == default else _variant_text(SOURCE, v))
        lib = vdir / "libb4.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(vdir),
               "-shared", "-o", str(lib), str(src)]
        jobs[v] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    out = {}
    for v, (lib, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{text}")
        used, name = [], None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = re.search(r"(boxmuller_kernelIfLb\dELb\d|copy_kernelILi\d|"
                                 r"boxmuller_at_kernel)", m.group(1))
                name = name.group(1) if name else None
            elif name and ("Used" in line or "spill" in line) and "at_kernel" not in name:
                used.append(f"{name}: {line.split(':', 1)[-1].strip()}")
        dll = ctypes.CDLL(str(lib))
        dll.zt_b4_boxmuller.restype = _I
        dll.zt_b4_boxmuller.argtypes = [_VP] * 7 + [_I] * 4 + [_VP]
        dll.zt_b4_copy.restype = _I
        dll.zt_b4_copy.argtypes = [_I] + [_VP] * 6 + [_I, _I, _VP]
        out[v] = (dll, used)
    return out


def per_call(fn, reps=10) -> float:
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def clock_under_load(fn, warm_s=0.5) -> dict:
    """The SM clock (MHz) that nvidia-smi reads while `fn` keeps the card
    busy: launches for `warm_s` seconds, then goes on launching until the
    query has returned."""
    import torch

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        fn()
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader,nounits"],
                            stdout=subprocess.PIPE, text=True)
    while proc.poll() is None:
        fn()
    torch.cuda.synchronize()
    sm, top = (float(x) for x in proc.stdout.read().strip().split(","))
    return {"sm_mhz": sm, "max_sm_mhz": top}


def sass_counts(lib: Path) -> dict:
    """Static SASS instruction count of each B4 kernel in `lib`, and the
    count and opcode histogram of its largest loop."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr[-300:]}
    out = {}
    for chunk in re.split(r"Function : ", proc.stdout)[1:]:
        name = re.search(r"boxmuller_kernelIfLb\dELb\d", chunk.split("\n", 1)[0])
        if not name:
            continue
        ins = [(int(a, 16), t) for a, t in
               re.findall(r"/\*([0-9a-f]{4,6})\*/\s+(.+?) ;", chunk)]
        loops = []
        for a, t in ins:
            tgt = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)
            if tgt and int(tgt.group(1), 16) < a:
                loops.append((int(tgt.group(1), 16), a))
        body = []
        if loops:
            lo, hi = max(loops, key=lambda r: r[1] - r[0])
            body = [t for a, t in ins if lo <= a <= hi]
        ops = collections.Counter(
            (t.split()[1] if t.startswith("@") else t.split()[0]).split(".")[0]
            for t in body)
        out[name.group(0)] = {"static": len(ins), "largest_loop": len(body),
                              "loop_opcodes": dict(ops.most_common())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from zeldovich_tpu_torch import kernels
    from zeldovich_tpu_torch.ops.boxmuller import halfspace_boxmuller

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    default = _source_defaults()
    variants = (default,) + (tuple(v for v in SWEEP if v != default) if args.sweep else ())
    libs = build(variants)
    for v, (_, used) in libs.items():
        for line in used:
            print(f"ptxas {v} {line}", flush=True)
    result = {"card": card.stdout.strip(), "default": default, "rows": [], "issue": [],
              "ptxas": {str(v): used for v, (_, used) in libs.items()}}
    stream = torch.cuda.current_stream().cuda_stream
    for n in (512, 1024):
        m = cs.model_for(n, False)
        tb, pk, half = m.tables, m.pk_eff, n // 2
        want = {f: halfspace_boxmuller(tb, pk, f) for f in (False, True)}
        re_, im_ = torch.empty_like(pk), torch.empty_like(pk)

        def b4(dll, fixed):
            rc = dll.zt_b4_boxmuller(tb.planes64.data_ptr(), tb.mzx64.data_ptr(),
                                     tb.czx64.data_ptr(), pk.data_ptr(), None,
                                     re_.data_ptr(), im_.data_ptr(), n, half, int(fixed),
                                     pk.device.index, stream)
            if rc != 0:
                raise RuntimeError(f"zt_b4_boxmuller failed: {rc}")

        def copy(dll, which):
            rc = dll.zt_b4_copy(which, tb.planes64.data_ptr(), tb.mzx64.data_ptr(),
                                tb.czx64.data_ptr(), pk.data_ptr(), re_.data_ptr(),
                                im_.data_ptr(), n, half, stream)
            if rc != 0:
                raise RuntimeError(f"zt_b4_copy failed: {rc}")

        runs = {"package kernel": lambda: halfspace_boxmuller(tb, pk, False),
                "package kernel, fixed power": lambda: halfspace_boxmuller(tb, pk, True)}
        for v, (dll, _) in libs.items():
            for fixed in (False, True):
                b4(dll, fixed)
                torch.cuda.synchronize()
                if not (torch.equal(re_, want[fixed][0]) and torch.equal(im_, want[fixed][1])):
                    raise AssertionError(f"variant {v} at {n}^3 differs from the package's B4")
            runs[f"B4 {v}"] = lambda dll=dll: b4(dll, False)
            runs[f"B4 {v} fixed power"] = lambda dll=dll: b4(dll, True)
            if v == default:
                runs[f"no tables {v}"] = lambda dll=dll: copy(dll, 0)
                runs[f"no draws {v}"] = lambda dll=dll: copy(dll, 1)
        del want
        ms = {k: [] for k in runs}
        for order in (list(runs), list(runs)[::-1]):
            for k in order:
                ms[k].append(per_call(runs[k]))
        bound = cs._b4_bound(tb, pk)["bound_ms"]
        for k, v in ms.items():
            row = {"n": n, "what": k, "ms": statistics.mean(v), "rounds": v,
                   "bound_ms": bound}
            result["rows"].append(row)
            print(json.dumps(row), flush=True)
        clock = clock_under_load(runs["package kernel"])
        clock.update(n=n, ms=statistics.mean(ms["package kernel"]),
                     warps=pk.numel() // 32)
        result["issue"].append(clock)
        del m, tb, pk, re_, im_
        torch.cuda.empty_cache()
    result["sass"] = sass_counts(kernels.LIB)
    print("SASS " + json.dumps(result["sass"]), flush=True)
    loop = result["sass"].get("boxmuller_kernelIfLb0ELb0", {}).get("largest_loop")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for row in result["issue"]:
        if loop:
            row["instructions_a_mode"] = loop / default[1]
            row["warp_instructions_per_s"] = (row["warps"] * row["instructions_a_mode"]
                                              / (row["ms"] * 1e-3))
            row["issue_rate_per_s"] = sms * 4 * row["sm_mhz"] * 1e6
            row["issue_share"] = row["warp_instructions_per_s"] / row["issue_rate_per_s"]
        print("CLOCK " + json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
