#!/usr/bin/env python3
"""The memory floor of the axis DFTs' column tiles on one GPU.

    python3 scripts/torch_axis_floor.py [--out FILE]

A copy kernel moves the same tiles as the column kernel of
``zeldovich_tpu_torch/csrc/fft_axis.cu`` (y_dft, and zx_dft's z pass):
1024 threads a block, the warp's lanes along TX columns and the threads
along the rows, 16 rows a thread, every load issued before the first
store, and one block a SM (139 KB of shared memory reserved, as the
column kernel takes).  It runs at the column pass's path shapes with the
kernel's own tile (TX = 32, 16, 8 at n = 512, 1024, 2048, all n rows) and,
at n = 2048, with 16- and 32-column tiles of 1024 and 512 rows, beside
y_dft itself; float32, CUDA events around 10 launches, in two rounds.
The copy is built with nvcc into zeldovich_tpu_torch/_build/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
template <int TX, int ROWS>
__global__ void __launch_bounds__(1024, 1)
    tile_copy(const float* in, float* out, long long n, long long inner, long long comp) {
  constexpr int E = ROWS * TX / 1024, T = ROWS / E;
  const long long ntiles = inner / TX, item = blockIdx.x / ntiles;
  const long long rb = item % (n / ROWS), b = item / (n / ROWS);
  const long long c = threadIdx.x % TX, t = threadIdx.x / TX;
  const size_t base = b * 2 * comp + rb * ROWS * inner + (blockIdx.x - item * ntiles) * TX + c;
  float re[E], im[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const size_t o = base + (t + r * T) * inner;
    re[r] = in[o];
    im[r] = in[o + comp];
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const size_t o = base + (t + r * T) * inner;
    out[o] = re[r];
    out[o + comp] = im[r];
  }
}

template <int TX, int ROWS>
int launch(const float* in, float* out, long long nb, long long n, long long inner) {
  const int smem = 139 * 1024;
  cudaFuncSetAttribute(tile_copy<TX, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  tile_copy<TX, ROWS><<<(unsigned)(nb * (n / ROWS) * (inner / TX)), 1024, smem>>>(
      in, out, n, inner, n * inner);
  return (int)cudaGetLastError();
}

extern "C" int copy_tiles(int tx, int rows, const float* in, float* out, long long nb,
                          long long n, long long inner) {
  if (tx == 32 && rows == 512) return launch<32, 512>(in, out, nb, n, inner);
  if (tx == 16 && rows == 1024) return launch<16, 1024>(in, out, nb, n, inner);
  if (tx == 8 && rows == 2048) return launch<8, 2048>(in, out, nb, n, inner);
  return -1;
}
"""

#: (shape of y_dft's input (B, 2, n, Bz, X), tiles (TX, rows) to copy)
CASES = (((2, 2, 512, 512, 512), ((32, 512),)),
         ((1024, 2, 512, 1, 512), ((32, 512),)),
         ((2, 2, 1024, 128, 1024), ((16, 1024),)),
         ((256, 2, 1024, 1, 1024), ((16, 1024),)),
         ((2, 2, 2048, 32, 2048), ((8, 2048), (16, 1024), (32, 512))),
         ((64, 2, 2048, 1, 2048), ((8, 2048), (16, 1024), (32, 512))))


def build() -> ctypes.CDLL:
    from zeldovich_tpu_torch import kernels

    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = kernels.BUILD / "axis_floor.cu", kernels.BUILD / "libzt_axis_floor.so"
    src.write_text(SOURCE)
    subprocess.run([kernels.nvcc_path(), *kernels.ARCH, "-O3", "-Xcompiler", "-fPIC",
                    "-shared", "-o", str(lib), str(src)], check=True)
    out = ctypes.CDLL(str(lib))
    out.copy_tiles.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from zeldovich_tpu_torch.ops.fft import y_dft

    lib = build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    rows = []
    for shape, tiles in CASES:
        x = torch.randn(shape, device="cuda")
        y = torch.empty_like(x)
        nb, n, inner = shape[0], shape[2], shape[3] * shape[4]

        def copy(tx, r):
            rc = lib.copy_tiles(tx, r, x.data_ptr(), y.data_ptr(), nb, n, inner)
            if rc != 0:
                raise RuntimeError(f"copy_tiles({tx}, {r}) failed: {rc}")

        copy(*tiles[0])
        torch.cuda.synchronize()
        if not torch.equal(x, y):
            raise AssertionError(f"the tile copy of {shape} is not a copy")
        runs = {f"copy {tx} x {r}": lambda tx=tx, r=r: copy(tx, r) for tx, r in tiles}
        runs["y_dft"] = lambda: y_dft(x, +1, out=y)
        ms = {k: [] for k in runs}
        for order in (list(runs), list(runs)[::-1]):
            for k in order:
                ms[k].append(per_call(runs[k]))
        row = {"shape": shape, **{k: statistics.mean(v) for k, v in ms.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, y
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card.stdout.strip(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
