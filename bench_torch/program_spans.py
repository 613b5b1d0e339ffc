"""What the span readers of ``metrics/`` share: the program's span records
(``zeldovich_tpu_torch/utils/timers.py``, kept while a profiler runs) taken
a realization at a time."""

import statistics

from zeldovich_tpu_torch.utils import timers


def median_ms(run, name: str):
    """The median over the window's requests of the seconds in the
    program's spans ``name`` that lie inside each, ms; None where the
    program keeps no span records or none of that name."""
    if not hasattr(timers, "records"):
        return None
    each = []
    for q in run.requests:
        secs = [r["t1"] - r["t0"] for r in timers.records(q["t0"], q["t1"])
                if r["name"] == name]
        if secs:
            each.append(sum(secs))
    return 1e3 * statistics.median(each) if each else None
