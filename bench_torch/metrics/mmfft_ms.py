"""The matrix-product DFTs of the separate half route (ops/mmfft.py: the
(z, x) pass ``zx_mm`` in place on the packed spectrum, then the c2r along
y ``c2r_y_pair`` into the output; each synced at its open and close while
tracing): the median over the window's realizations of the seconds in the
program's spans ``mmfft.zx`` and ``mmfft.c2r`` that lie inside each, both
summed, ms (nothing where the program keeps no such span)."""

import statistics

from zeldovich_tpu_torch.utils import timers

SPANS = ("mmfft.zx", "mmfft.c2r")


def read(run):
    if not hasattr(timers, "records"):
        return None
    each = []
    for q in run.requests:
        secs = [r["t1"] - r["t0"] for r in timers.records(q["t0"], q["t1"])
                if r["name"] in SPANS]
        if secs:
            each.append(sum(secs))
    return 1e3 * statistics.median(each) if each else None
