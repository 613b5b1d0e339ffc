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

``spans(rank, world, store, keys, out)``, the same way, runs the step of
``keys`` twice on fresh models, first under a CPU profiler and then with
none, and writes the two slabs (``traced.r<rank>.npy``,
``plain.r<rank>.npy``) and the span records the traced step kept
(``spans.r<rank>.json``).
"""

import json
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from zeldovich_tpu_torch.models.pipeline import Zeldovich
from zeldovich_tpu_torch.ops.modes_real import pk_effective, plt_coef_fields
from zeldovich_tpu_torch.parallel import pencil_mmfft
from zeldovich_tpu_torch.parallel.mesh import make_mesh
from zeldovich_tpu_torch.utils import timers
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


def spans(rank, world, store, keys, out):
    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        mesh = make_mesh("cpu", group=dist.group.WORLD)
        model = Zeldovich(Parameters.from_dict(keys), device="cpu")
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU]):
            traced = model.xspace_half_pair_sharded(mesh)
        recs = [{k: r[k] for k in ("name", "counts", "parent")} for r in timers.records(t0)]
        plain = Zeldovich(Parameters.from_dict(keys), device="cpu").xspace_half_pair_sharded(mesh)
        np.save(out / f"traced.r{rank}.npy", traced.numpy())
        np.save(out / f"plain.r{rank}.npy", plain.numpy())
        (out / f"spans.r{rank}.json").write_text(json.dumps(recs))
    finally:
        dist.destroy_process_group()
