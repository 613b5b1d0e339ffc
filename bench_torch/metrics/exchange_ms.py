"""The exchange between ranks (parallel/pencil_mmfft.py ``exchange``: the
blocks' packing, their ``all_to_all_single`` and the unpacking, synced at
its close while tracing): the median over the window's realizations of the
seconds in the program's spans ``shard.exchange`` that lie inside each, on
rank 0, ms (nothing where the program keeps no such span records)."""

import statistics

from zeldovich_tpu_torch.utils import timers

SPAN = "shard.exchange"


def read(run):
    if not hasattr(timers, "records"):
        return None
    each = []
    for q in run.requests:
        secs = [r["t1"] - r["t0"] for r in timers.records(q["t0"], q["t1"])
                if r["name"] == SPAN]
        if secs:
            each.append(sum(secs))
    return 1e3 * statistics.median(each) if each else None
