"""The general traffic generator: one closed-loop client sending requests of
the kind the traffic file names.

A traffic file (``traffic/<mix>.json``) holds parameters only: its
``kind`` names a module ``kinds/<kind>.py`` that supplies how one request
drives the program (``warm_up``, ``step``), the end-to-end values of a
window (``end_to_end``) and the comparison of one request's output with
the reference (``check``).  A new mix of a known kind
is a data file; a new kind is a module of its own.

Every request has its own ``ZD_Seed`` from (``--seed``, request index).
The window starts before the first request and closes when the request
running at ``seconds`` has ended.  A kind that sets ``COLLECTIVE = True``
runs on every rank of a mesh in lockstep (``lockstep.py``): rank 0's
clock decides each request, a request is ok where it is ok on every
rank, and a rank that raises leaves the run.  The program is imported
inside the functions: the benchmark takes from it the system under test
and its counters and ranges only.
"""

from __future__ import annotations

import hashlib
import importlib.util
import io
import sys
import time
import traceback
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def load_kind(name: str):
    """The request kind ``kinds/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"kind_{name}", HERE / "kinds" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def request_seed(seed: int, index: int) -> int:
    """A ZD_Seed in [1, 2^31) from the run's seed and the request index."""
    h = hashlib.sha256(f"{seed}:{index}".encode()).digest()
    return 1 + int.from_bytes(h[:4], "little") % (2**31 - 1)


def par_keys(root: Path, config: dict, seed: int, outdir: Path) -> dict:
    """The configuration's .par keys for one request, file names absolute."""
    keys = dict(config["par"])
    for k in ("ZD_Pk_filename", "ZD_PLT_filename"):
        if k in keys:
            keys[k] = str((root / keys[k]).resolve())
    keys["ZD_Seed"] = seed
    keys["InitialConditionsDirectory"] = str(outdir)
    return keys


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


class Mix:
    """One cell's traffic: set-up, the window, and what the check needs.
    ``held`` is the last request's output that its kind keeps on the
    device until the window has closed, as (request, tensor).  ``mesh``:
    this rank's mesh, for a collective kind."""

    def __init__(self, root: Path, run_dir: Path, config: dict, traffic: dict,
                 seed: int, device: str, mesh=None):
        self.root, self.run_dir = root, run_dir
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.mesh = mesh
        self.kind = load_kind(traffic["kind"])
        self.dtype = getattr(torch, config["dtype"])
        self.ppd = round(int(config["par"]["NP"]) ** (1 / 3))
        self.requests: list[dict] = []
        self.held = None
        self.log = io.StringIO()

    def warm_up(self):
        """The program's kernels and packer loaded, and the kind's warm-up
        at the cell's shapes, with no output."""
        from zeldovich_tpu_torch import native

        if self.device == "cuda":
            from zeldovich_tpu_torch import kernels

            kernels.library()
        native.load()
        self.kind.warm_up(self)
        sync(self.device)

    def run_window(self, seconds: float) -> float:
        """Requests until the one running at ``seconds`` has ended; returns
        the window's length in seconds.  In lockstep an exception leaves
        the window, and this rank the run."""
        from torch.profiler import record_function

        label = f"bench.{self.traffic['kind']}"
        t_w0 = time.perf_counter()
        with record_function("bench.window"):
            i = 0
            while self._go(i == 0 or time.perf_counter() - t_w0 < seconds):
                r = {"index": i, "seed": request_seed(self.seed, i), "spans": {}}
                r["t0"] = time.perf_counter()
                with record_function(label):
                    r["ok"] = self._step(r) if self.mesh is None else self._lockstep(r)
                sync(self.device)
                r["t1"] = time.perf_counter()
                self.requests.append(r)
                i += 1
        return time.perf_counter() - t_w0

    def _step(self, r) -> bool:
        try:
            return self.kind.step(self, r)
        except Exception:  # a failed request is counted, the run goes on
            traceback.print_exc(file=sys.stderr)
            return False

    def _go(self, go: bool) -> bool:
        """Rank 0's go or stop, on every rank of the mesh."""
        if self.mesh is None:
            return go
        import torch.distributed as dist

        t = torch.tensor([int(go)], dtype=torch.int32, device=self.mesh.device)
        dist.broadcast(t, 0, group=self.mesh.group)
        return bool(t.item())

    def _lockstep(self, r) -> bool:
        """One request on this rank, synced; ok where it is ok on every
        rank (the all-reduce is the request's closing barrier).  Nothing
        is caught: the other ranks could not go on without this one."""
        ok = self.kind.step(self, r)
        sync(self.device)
        return self.mesh.agree(ok)

    def release(self):
        """The held output for the check: on one rank copied to the host,
        its device memory freed; in lockstep a rank's slab stays on its
        card (four ranks' slabs of a 1024^3 PLT float64 output in pageable
        host memory would take 69 GB of the host's RAM)."""
        if self.held is not None:
            r, out = self.held
            r["whole"] = out if self.mesh is not None else out.cpu()
            self.held = None

    def particles(self) -> int:
        return sum(self.ppd ** 3 for r in self.requests if r["ok"])
