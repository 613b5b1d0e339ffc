"""The exchange between ranks against the links' rate: the least time of
the bytes rank 0 moves across links in the window's ``shard.exchange``
spans (parallel/pencil_mmfft.py ``exchange``) over the device time of the
NCCL kernels inside those spans' ranges in rank 0's trace, %.

The least time is the larger of the bytes rank 0 sends to the other ranks
and the bytes it receives from them, over ``LINK_BPS``.  The bytes are
reckoned here from the cell's shapes and the spans' ``calls`` (not from the
program's own ``bytes`` count): on the in-core half route a call is one
block (array, component, sign) of B1's output, and rank 0 holds the first
ceil(ppd/2 / ranks) ky planes of it and receives the rest of its z-slab of
ppd/ranks planes.  Nothing where the program keeps no such span records,
where the trace holds no NCCL kernel inside them, or off the half route.
"""

import math

from zeldovich_tpu_torch.utils import timers

SPAN = "shard.exchange"
#: NVIDIA H100 SXM data sheet: NVLink 4 at 900 GB/s both ways, a card's
#: links together, so 450 GB/s each way
LINK_BPS = 450e9


def half_route(config) -> bool:
    """Whether the configuration's sharded step takes the half route (B1,
    the exchange, B2): in core, Hermitian, at a ppd the FFT kernels take."""
    par = config["par"]
    n = round(int(par["NP"]) ** (1 / 3))
    return ("--out-of-core" not in config.get("flags", [])
            and float(par.get("ZD_f_NL", 0)) == 0 and int(par.get("ZD_Version", 2)) == 2
            and not (int(par.get("ZD_CornerModes", 0)) and float(par.get("ZD_k_cutoff", 1)) != 1)
            and 16 <= n <= 2048 and n & (n - 1) == 0)


def call_bytes(config, ranks: int) -> float:
    """Bytes rank 0 moves across links in one call, the larger way: it
    sends its ky planes' z-parts of the other ranks and receives the other
    ranks' ky planes of its z-slab."""
    n = round(int(config["par"]["NP"]) ** (1 / 3))
    s = 8 if config["dtype"] == "float64" else 4
    rows, zl = math.ceil(n // 2 / ranks), n // ranks
    sent = rows * (n - zl) * n * s
    received = (n // 2 - rows) * zl * n * s
    return max(sent, received)


def read(run):
    if not hasattr(timers, "records") or not half_route(run.config):
        return None
    calls = sum(r["counts"].get("calls", 0) for q in run.requests
                for r in timers.records(q["t0"], q["t1"]) if r["name"] == SPAN)
    spans = run.ranges(SPAN)
    nccl = sum(max(0.0, min(e["t1"], h["t1"]) - max(e["t0"], h["t0"]))
               for e in run.events if e["cat"] == "kernel" and "nccl" in e["name"].lower()
               for h in spans)
    if not calls or not nccl:
        return None
    least = calls * call_bytes(run.config, int(run.cell["chips"])) / LINK_BPS
    return 100.0 * least / nccl
