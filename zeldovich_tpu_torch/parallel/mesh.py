"""The ranks of a sharded run: one flat axis of torch.distributed ranks.

Counterpart of ``zeldovich_tpu/parallel/mesh.py`` (``make_mesh`` :18).  The
JAX package shards the grid over a 2-D ("z", "y") device mesh for its
pencil transforms; the port decomposes it into slabs
(``parallel/pencil_mmfft.py``): a rank holds a contiguous block of y rows
(or ky planes) before an exchange and a contiguous block of z planes after
it, so its mesh is one flat axis of ranks and the JAX mesh's (nz, ny) shape
has no meaning here.

``make_mesh`` starts the ranks' process group three ways, the counterpart
of ``zeldovich_tpu/parallel/multihost.py::init_distributed`` (:32):

* with the triple ``coordinator`` ("HOST:PORT"), ``num_processes`` and
  ``process_id`` (the CLI's ``--coordinator``, ``--num-processes``,
  ``--process-id``), over ``tcp://HOST:PORT``: the processes may sit on
  several hosts.  The three go together (``check_triple``);
* under ``torchrun`` (``WORLD_SIZE`` set in the environment), over
  ``env://``: JAX's auto-detection has this role;
* otherwise as a group of one rank, still a real process group (over a
  ``FileStore`` in a temporary directory: no network), so the exchanges
  run as they do across ranks.

A rank takes ``cuda:LOCAL_RANK`` where that is set, else card
``process_id % device_count``, with NCCL; the CPU with gloo.  A card never
falls back from NCCL to gloo (two NCCL ranks on one card fail in NCCL).
Every group has a timeout, so a rank that waits on a failed one raises
instead of hanging.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

#: how long a rank waits on the others: rank 0 writes every rank's slabs
#: while the others wait to send theirs (utils/streamio.py)
TIMEOUT = timedelta(minutes=30)


def check_triple(coordinator, num_processes, process_id):
    """Raise ValueError unless the triple is given whole or not at all, and
    names a rank of its world."""
    triple = (coordinator, num_processes, process_id)
    if any(v is not None for v in triple) and any(v is None for v in triple):
        raise ValueError(
            "--coordinator, --num-processes and --process-id go together (got "
            f"{triple}); under torchrun give none of them")
    if coordinator is not None and not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not a rank of "
                         f"--num-processes {num_processes}")


@dataclass
class Mesh:
    """rank, world size, device and process group of a sharded run
    (``group`` None: the default group)."""

    rank: int
    world: int
    device: torch.device
    group: object = None
    _owned: bool = False  # make_mesh initialized the default group
    _store_dir: str | None = None

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def all_to_all_single(self, out, inp, out_splits, in_splits):
        """``dist.all_to_all_single`` over this mesh's group (1-D tensors,
        element counts a rank)."""
        dist.all_to_all_single(out, inp, out_splits, in_splits, group=self.group)

    def all_gather(self, t) -> list:
        """Every rank's ``t`` (a tensor on this mesh's device), in rank order."""
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t, group=self.group)
        return out

    def barrier(self):
        """Wait for every rank: a one-element all-reduce on the mesh's
        device, the same on NCCL and gloo (NCCL's ``dist.barrier`` would
        have to guess the rank's card)."""
        self.agree(True)

    def agree(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every rank (each rank must call it)."""
        t = torch.tensor([int(ok)], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return bool(t.item())

    def close(self):
        """Destroy the process group make_mesh made, if it made one."""
        if self._owned and dist.is_initialized():
            dist.destroy_process_group()
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)


def _rank_card(index: int) -> torch.device:
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", index)))
    torch.cuda.set_device(dev)
    return dev


def make_mesh(device="cuda", group=None, coordinator=None, num_processes=None,
              process_id=None) -> Mesh:
    """The mesh of this process on ``device``.

    With ``group`` (or an initialized default group) it is that group's
    ranks.  Else with the triple ``coordinator``, ``num_processes``,
    ``process_id`` it joins that group over TCP; else under ``torchrun``
    the launch's ranks; else it is one rank, and one stderr line names the
    command that runs a rank on every card.  NCCL on the rank's card, gloo
    on the CPU.
    """
    check_triple(coordinator, num_processes, process_id)
    dev = torch.device(device)
    if group is not None or dist.is_initialized():
        return Mesh(dist.get_rank(group), dist.get_world_size(group), dev, group)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator is not None:
        if dev.type == "cuda":
            dev = _rank_card(process_id % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=TIMEOUT)
        return Mesh(process_id, num_processes, dev, _owned=True)
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            dev = _rank_card(0)
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
        return Mesh(dist.get_rank(), dist.get_world_size(), dev, _owned=True)
    n = torch.cuda.device_count()
    print(f"without torchrun or --coordinator the run is one rank ({n} CUDA "
          "device(s) here); "
          f"python -m torch.distributed.run --nproc-per-node {max(n, 1)} -m "
          "zeldovich_tpu_torch --sharded ... runs a rank on each", file=sys.stderr)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    store_dir = tempfile.mkdtemp(prefix="zt_mesh_")
    try:
        store = dist.FileStore(os.path.join(store_dir, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                timeout=TIMEOUT)
    except BaseException:
        shutil.rmtree(store_dir, ignore_errors=True)
        raise
    return Mesh(0, 1, dev, _owned=True, _store_dir=store_dir)
