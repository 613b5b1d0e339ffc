"""Share of the jobs' wall waiting on the writer thread: the program's
spans ``output.submit_wait`` (utils/streamio.py ``AsyncSlabWriter``: a
full queue, then the last slabs at close), % (nothing where the program
keeps no span records)."""

from zeldovich_tpu_torch.utils import timers

SPANS = ("output.submit_wait",)


def read(run):
    if not hasattr(timers, "records") or not run.requests:
        return None
    recs = timers.records(run.requests[0]["t0"], run.requests[-1]["t1"])
    wall = run.request_wall_s()
    if not recs or not wall:
        return None
    return 100.0 * sum(r["t1"] - r["t0"] for r in recs if r["name"] in SPANS) / wall
