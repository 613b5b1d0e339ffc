"""The pcg64 tables on the host and their copies to the device
(ops/modes.py ``SynthTables.build``, in ``Zeldovich.__init__``): the
median over the window's realizations of the seconds in the program's
spans ``setup.rng_tables`` that lie inside each, ms (nothing where the
program keeps no span records)."""

import statistics

from zeldovich_tpu_torch.utils import timers

SPAN = "setup.rng_tables"


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
