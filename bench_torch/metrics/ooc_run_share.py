"""Share of the jobs' wall inside the CLI's "Out-of-core streamed run"
phase (models/outofcore.py: both passes and the writer behind pass 2), %."""


def read(run):
    spans = run.ranges("Out-of-core streamed run")
    wall = run.request_wall_s()
    if not spans or not wall:
        return None
    return 100.0 * sum(e["t1"] - e["t0"] for e in spans) / wall
