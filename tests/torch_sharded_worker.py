"""A rank of the port's sharded steps on the CPU, for tests/test_torch_sharded.py.

``run(rank, world, store, cases, out)`` is the target of a process that
``torch.multiprocessing`` starts with the ``spawn`` method: it joins a
gloo group of ``world`` ranks over the ``FileStore`` at ``store`` (a file
path: no port), and for each case ``(name, keys, dtype, route)`` writes
this rank's slab of the step to ``out/<name>.r<rank>.npy``:

* route "step": ``Zeldovich.xspace_half_pair_sharded(mesh)``, its z-slab;
* route "half": the half route's function itself, at a ppd whose model
  would take the full grid (ppd 12 over 4 ranks splits the 6 ky planes
  2, 2, 1, 1);
* route "kspace": ``Zeldovich.kspace_pair_sharded(mesh)``, its y-slab.

It imports torch and the port only (no JAX), and ends by writing
``out/done.r<rank>``.
"""

from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from zeldovich_tpu_torch.models.pipeline import Zeldovich
from zeldovich_tpu_torch.ops.modes_real import pk_effective, plt_coef_fields
from zeldovich_tpu_torch.parallel import pencil_mmfft
from zeldovich_tpu_torch.parallel.mesh import make_mesh
from zeldovich_tpu_torch.utils.params import Parameters

TIMEOUT = timedelta(seconds=120)


def step(model, mesh, route):
    if route == "step":
        return model.xspace_half_pair_sharded(mesh)
    if route == "kspace":
        return model.kspace_pair_sharded(mesh)
    cfg = model.cfg
    k0, k1 = pencil_mmfft.ky_planes(cfg.ppd, mesh)
    pk = pk_effective(cfg, model.tables, model.dtype, rows=(k0, k1))
    coefs = (plt_coef_fields(cfg, model.tables, model.dtype, rows=(k0, k1))
             if cfg.qPLT else None)
    return pencil_mmfft.xspace_half_pair_sharded(cfg, model.tables, pk, coefs, mesh,
                                                 model.dtype)


def run(rank, world, store, cases, out):
    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        mesh = make_mesh("cpu", group=dist.group.WORLD)
        assert (mesh.rank, mesh.world) == (rank, world)
        for name, keys, dtype, route in cases:
            model = Zeldovich(Parameters.from_dict(keys), dtype=getattr(torch, dtype),
                              device="cpu")
            np.save(out / f"{name}.r{rank}.npy", step(model, mesh, route).numpy())
        (out / f"done.r{rank}").touch()
    finally:
        dist.destroy_process_group()
