"""A cell of N > 1 chips as N ranks in lockstep, one process a card.

Rank 0 is the process that ``run.py`` runs; it writes the run's spec
(the cell, its configuration as resized, traffic, limits, seed, window)
to ``spec.json`` in the run directory and starts ranks 1 .. N-1 as

    python3 bench_torch/lockstep.py <spec.json> <rank> <rank 0's pid>

each on ``cuda:<rank>`` (the CPU with gloo in the tests), their standard
output sent to standard error, so that rank 0's result stays the last
line of standard output.  The ranks join one process group over a
``FileStore`` in the run directory with a timeout of ``GROUP_TIMEOUT``,
and take the program's mesh (``parallel/mesh.py::make_mesh``) on it.
``torch.distributed.run`` would start them too, but its rendezvous looks
up the host's fully qualified name (``socket.getfqdn``), which may ask a
name server, and the machine with the cards has no network; a
``FileStore`` needs none.

Every rank then runs the same sequence of collectives: the kind's
warm-up, a barrier, the window (before each request rank 0 broadcasts go
or stop; a request ends in an all-reduce of the ranks' flags, once every
rank has synced), the maximum of the peaks, the check (each rank tallies
its part; ``checks.Tally.reduce``), and whether any rank holds JAX.  Then
the followers leave, and rank 0 alone reads its trace and prints the
result.

A rank that raises or exits ends the run with no result: a follower
exits 1, and rank 0's watcher, seeing a follower end with a code other
than 0, stops the others and exits 1.  A rank that stalls leaves the
others waiting in a collective until ``GROUP_TIMEOUT``, where they raise
(gloo) or their watchdog ends them (NCCL), and the run ends the same way.
"""

from __future__ import annotations

import ctypes
import json
import os
import signal
import subprocess
import sys
import threading
import time
import traceback
from datetime import timedelta
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: how long a rank waits in a collective for the others
GROUP_TIMEOUT = timedelta(minutes=2)
#: how long rank 0 waits for the followers to leave after their last collective
JOIN_S = 60


def child_argv(spec_path: Path, rank: int) -> list[str]:
    """The command of follower ``rank``."""
    return [sys.executable, str(HERE / "lockstep.py"), str(spec_path), str(rank),
            str(os.getpid())]


def join(spec: dict, rank: int):
    """This rank in the run's process group, as the program's mesh."""
    import torch.distributed as dist

    from zeldovich_tpu_torch.parallel.mesh import make_mesh

    backend = "nccl" if spec["device"] == "cuda" else "gloo"
    store = dist.FileStore(spec["store"], spec["world"])
    dist.init_process_group(backend, store=store, rank=rank, world_size=spec["world"],
                            timeout=GROUP_TIMEOUT)
    return make_mesh(spec["device"], group=dist.group.WORLD)


def max_over(mesh, value: int) -> int:
    """The largest ``value`` over the ranks (each must call it)."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t.item())


def jax_held() -> list[str]:
    """The top-level names of JAX or the JAX package this process holds."""
    names = {"jax", "jaxlib", "flax", "zeldovich_tpu"}
    return sorted({name.split(".")[0] for name in sys.modules} & names)


class Ranks:
    """Rank 0's side of a lockstep run: the followers' processes, the
    group, and the watcher that ends the run where a follower fails."""

    def __init__(self, spec: dict, run_dir: Path, launch=None):
        self.world = spec["world"]
        self.done = False
        path = run_dir / "spec.json"
        path.write_text(json.dumps(spec))
        launch = launch or child_argv
        self.procs = [subprocess.Popen(launch(path, r), stdout=2)
                      for r in range(1, self.world)]
        threading.Thread(target=self._watch, daemon=True).start()
        try:
            self.mesh = join(spec, 0)
        except BaseException:
            self.stop()
            raise

    def _watch(self):
        while not self.done:
            time.sleep(0.5)
            gone = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
                    if p.poll() not in (None, 0)]
            if gone and not self.done:
                print("lockstep: rank {} exited with code {}; the run ends with no result"
                      .format(*gone[0]), file=sys.stderr, flush=True)
                self.stop()
                os._exit(1)

    def stop(self):
        """Stop every follower and wait for each."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def close(self, wait: bool = True):
        """Stop watching, wait for the followers to leave (after their last
        collective; else stop them), and leave the group."""
        if self.done:
            return
        self.done = True
        deadline = time.monotonic() + (JOIN_S if wait else 0)
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        self.stop()
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _die_with_parent(parent: int):
    """End this process when rank 0's does (Linux prctl PR_SET_PDEATHSIG)."""
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def follow(spec: dict, rank: int) -> None:
    """Follower ``rank``'s part of the run: rank 0's sequence of
    collectives without the clock, the trace and the result."""
    import torch

    sys.path[:0] = [str(HERE), spec["root"]]
    from mixes import Mix

    import run

    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    mesh = join(spec, rank)
    mix = Mix(Path(spec["root"]), Path(spec["run_dir"]), spec["config"], spec["traffic"],
              spec["seed"], device, mesh=mesh)
    mix.warm_up()
    mesh.barrier()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mix.run_window(spec["seconds"])
    max_over(mesh, torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    mix.release()
    run.check(mix, Path(spec["root"]), device, spec["seed"])
    held = jax_held()
    if held:
        print(f"rank {rank} holds {', '.join(held)} once the window has closed",
              file=sys.stderr)
    max_over(mesh, int(bool(held)))


def main(argv=None) -> int:
    spec_path, rank, parent = (argv or sys.argv[1:])[:3]
    _die_with_parent(int(parent))
    spec = json.loads(Path(spec_path).read_text())
    try:
        follow(spec, int(rank))
    except BaseException:  # leave at once: rank 0 sees the exit and ends the run
        traceback.print_exc(file=sys.stderr)
        sys.stderr.flush()
        os._exit(1)
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
