"""Share of the jobs' wall in pass 1 of the out-of-core run: the program's
spans ``ooc.pass1`` (models/outofcore.py ``stage_pass1``), % (nothing
where the program keeps no span records)."""

from zeldovich_tpu_torch.utils import timers

SPANS = ("ooc.pass1",)


def read(run):
    if not hasattr(timers, "records") or not run.requests:
        return None
    recs = timers.records(run.requests[0]["t0"], run.requests[-1]["t1"])
    wall = run.request_wall_s()
    if not recs or not wall:
        return None
    return 100.0 * sum(r["t1"] - r["t0"] for r in recs if r["name"] in SPANS) / wall
