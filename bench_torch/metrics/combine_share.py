"""Share of the jobs' wall forming complex planes from pairs for the
writer: the program's spans ``output.combine`` (utils/streamio.py
``_flush_chunk``), % (nothing where the program keeps no span records)."""

from zeldovich_tpu_torch.utils import timers

SPANS = ("output.combine",)


def read(run):
    if not hasattr(timers, "records") or not run.requests:
        return None
    recs = timers.records(run.requests[0]["t0"], run.requests[-1]["t1"])
    wall = run.request_wall_s()
    if not recs or not wall:
        return None
    return 100.0 * sum(r["t1"] - r["t0"] for r in recs if r["name"] in SPANS) / wall
