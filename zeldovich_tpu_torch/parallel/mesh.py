"""The ranks of a sharded run: one flat axis of torch.distributed ranks.

Counterpart of ``zeldovich_tpu/parallel/mesh.py`` (``make_mesh`` :18).  The
JAX package shards the grid over a 2-D ("z", "y") device mesh for its
pencil transforms; the port decomposes it into slabs
(``parallel/pencil_mmfft.py``): a rank holds a contiguous block of y rows
(or ky planes) before an exchange and a contiguous block of z planes after
it, so its mesh is one flat axis of ranks and the JAX mesh's (nz, ny) shape
has no meaning here.

``make_mesh`` joins the ranks of a ``torchrun`` launch (``WORLD_SIZE`` set
in the environment): rank r takes ``cuda:LOCAL_RANK`` with NCCL, or the
CPU with gloo.  Without one it is a group of one rank, still a real
process group (over a ``FileStore`` in a temporary directory: no network),
so the exchanges run as they do across ranks.  A card never falls back from
NCCL to gloo.  Every group has a timeout, so a rank that waits on a failed
one raises instead of hanging.
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

    def close(self):
        """Destroy the process group make_mesh made, if it made one."""
        if self._owned and dist.is_initialized():
            dist.destroy_process_group()
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)


def make_mesh(device="cuda", group=None) -> Mesh:
    """The mesh of this process on ``device``.

    With ``group`` (or an initialized default group) it is that group's
    ranks.  Else under ``torchrun`` it joins the launch's ranks (NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU); else it is one rank, and one
    stderr line names the command that runs a rank on every card.
    """
    dev = torch.device(device)
    if group is not None or dist.is_initialized():
        return Mesh(dist.get_rank(group), dist.get_world_size(group), dev, group)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
        return Mesh(dist.get_rank(), dist.get_world_size(), dev, _owned=True)
    n = torch.cuda.device_count()
    print(f"--sharded without torchrun runs one rank ({n} CUDA device(s) here); "
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
