"""The sink's own rate: bytes over seconds of the program's spans
``output.write`` on the writer thread (utils/output.py), MB/s (nothing
where the program keeps no span records or wrote nothing)."""

from zeldovich_tpu_torch.utils import timers


def read(run):
    if not hasattr(timers, "records") or not run.requests:
        return None
    recs = [r for r in timers.records(run.requests[0]["t0"], run.requests[-1]["t1"])
            if r["name"] == "output.write"]
    moved = sum(r["counts"].get("bytes", 0) for r in recs)
    secs = sum(r["t1"] - r["t0"] for r in recs)
    return moved / secs / 1e6 if moved and secs else None
