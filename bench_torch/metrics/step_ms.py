"""Forward step (models/pipeline.py, ops/synth.py, ops/c2r.py): the median
over the window's realizations of the card's busy time inside the
harness's "bench.step" range around xspace_half_pair() and its sync, ms
(nothing where the trace holds no such range with activity of the card)."""

import statistics


def read(run):
    busy = [s for s in run.busy_in("bench.step") if s > 0]
    return 1e3 * statistics.median(busy) if busy else None
