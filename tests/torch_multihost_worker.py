"""A process of the port's multi-process runs on the CPU, for
tests/test_torch_multihost.py.

``run(rank, world, jobs, out)`` is the target of a process that
``torch.multiprocessing`` starts with the ``spawn`` method.  It runs the
jobs in order, each a dict:

* ``kind`` "cli": ``zeldovich_tpu_torch.cli.main(argv)`` as process
  ``rank`` of ``world``.  With ``port`` the argv gains ``--coordinator
  127.0.0.1:<port> --num-processes <world> --process-id <rank>`` (the
  loopback triple); with ``torchrun`` the environment torchrun gives its
  ranks (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) is set
  for the run alone.  Its exit code, its stderr, the z planes its writers
  wrote and the number of ``torch.distributed.recv`` calls it made go to
  ``out/<name>.r<rank>.json``;
* ``kind`` "stage": ``DistributedOutOfCore(...).stage_pass1()`` over a
  gloo group on ``port``, with every collective made to raise while it
  runs (f_NL aside: its pass 1 takes the reflected rows from other ranks);
  the rank's stage goes to ``out/<name>.r<rank>.npy`` and its layout to the
  JSON file.

``after``: a file that must exist before the job starts (a job of another
world, e.g. the ``--part 1`` whose checkpoint this ``--part 2`` refuses).
It imports torch and the port only (no JAX).
"""

import contextlib
import io
import json
import os
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from zeldovich_tpu_torch import cli
from zeldovich_tpu_torch.utils.output import OutputWriter

WAIT_S = 240


def _wait_for(path):
    deadline = time.monotonic() + WAIT_S
    while not Path(path).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.05)


def _cli(rank, world, job, log):
    argv = list(job["argv"])
    env = {}
    if job.get("torchrun"):
        env = dict(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(job["port"]))
    else:
        argv += ["--coordinator", f"127.0.0.1:{job['port']}", "--num-processes",
                 str(world), "--process-id", str(rank)]
    os.environ.update(env)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        for k in env:
            del os.environ[k]
    return {"rc": rc, "stderr": err.getvalue(), **log}


def _stage(rank, world, job, out):
    from zeldovich_tpu_torch.models.outofcore import DistributedOutOfCore
    from zeldovich_tpu_torch.parallel.mesh import make_mesh
    from zeldovich_tpu_torch.utils.params import Parameters

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{job['port']}",
                            world_size=world, rank=rank, timeout=timedelta(seconds=120))
    try:
        mesh = make_mesh("cpu", group=dist.group.WORLD)
        m = DistributedOutOfCore(Parameters.from_dict(job["keys"]), mesh,
                                 slab_bytes=job["slab_bytes"])
        saved = {}
        if job["no_collective"]:
            def refuse(*a, **kw):
                raise AssertionError("pass 1 ran a collective")
            for name in ("all_to_all_single", "all_gather", "all_reduce", "send",
                         "recv", "broadcast", "barrier"):
                saved[name] = getattr(dist, name)
                setattr(dist, name, refuse)
        try:
            stage = m.stage_pass1()
        finally:
            for name, f in saved.items():
                setattr(dist, name, f)
        np.save(out / f"{job['name']}.r{rank}.npy", stage)
        return {"layout": list(m.stage_layout()[0]), "slab": m.slab}
    finally:
        dist.destroy_process_group()


def run(rank, world, jobs, out):
    torch.set_num_threads(1)
    out = Path(out)
    planes, recvs = [], [0]
    write_slab, recv = OutputWriter.write_slab, dist.recv

    def logged_write(self, z, slabs):
        planes.append(int(z))
        return write_slab(self, z, slabs)

    def logged_recv(*a, **kw):
        recvs[0] += 1
        return recv(*a, **kw)

    OutputWriter.write_slab = logged_write
    dist.recv = logged_recv
    for job in jobs:
        if job.get("after"):
            _wait_for(job["after"])
        planes.clear()
        recvs[0] = 0
        try:
            if job["kind"] == "cli":
                res = _cli(rank, world, job, {})
                res.update(planes=sorted(planes), recvs=recvs[0])
            else:
                res = _stage(rank, world, job, out)
        except Exception:  # noqa: BLE001 - reported to the test, the next job runs
            res = {"error": traceback.format_exc()}
        (out / f"{job['name']}.r{rank}.json").write_text(json.dumps(res))
