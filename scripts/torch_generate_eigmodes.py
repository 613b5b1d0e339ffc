#!/usr/bin/env python
"""Generate a PLT eigenmode table (the reference eigmodes128 format) on the card.

Usage: python scripts/torch_generate_eigmodes.py N OUTPUT [--alpha A] [--device cuda|cpu]

The counterpart of scripts/generate_eigmodes.py through the PyTorch port
(zeldovich_tpu_torch/ops/lattice.py): the Ewald-summed dynamical matrix of
the gravitating simple-cubic lattice for every k of an N^3 grid half-space
and its growing mode, in float64 on the device.  The header goes first;
the planes stream into a memory map of the file behind it, so a table is
never held twice on the host (17 GB at N = 1024).  Prints the wall time
and the device's name.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("N", type=int)
    ap.add_argument("output")
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from zeldovich_tpu_torch.ops.lattice import generate_eigmodes_table

    N = args.N
    shape = (N, N, N // 2 + 1, 4)
    t0 = time.perf_counter()
    with open(args.output, "wb") as fp:
        np.array([N], dtype="<i4").tofile(fp)
        fp.truncate(4 + 8 * int(np.prod(shape)))
    table = np.memmap(args.output, dtype="<f8", mode="r+", offset=4, shape=shape)
    generate_eigmodes_table(N, alpha=args.alpha, device=args.device, out=table,
                            verbose=True)
    table.flush()
    del table
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "the host CPU"
    print(f"wrote {args.output} ({N}^3 half-space) in {time.perf_counter() - t0:.3f} s "
          f"on {name}")


if __name__ == "__main__":
    main()
