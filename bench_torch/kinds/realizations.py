"""Request kind ``realizations``: each request is ``Zeldovich(param with its
seed, dtype)``, its static fields, ``.xspace_half_pair()`` and a sync
through the model API, each part in a synced harness range
(``bench.setup_tables``, ``bench.static_fields``, ``bench.step``).  The
consumer then reads ``POINTS`` points drawn from the run's seed and lets
the realization go, so only one is alive at a time; the last stays on the
device until the window has closed.  Nothing is written.

End to end: ``mem_Mpart_s``, every particle of every realization over
the window.  Check: the last realization whole and the sampled others at
their points against the reference.
"""

from __future__ import annotations

import contextlib
import time

import checks
from mixes import par_keys, sync

#: points of each realization the consumer reads and the check compares
POINTS = 4096


def model(mix, seed):
    from zeldovich_tpu_torch.models.pipeline import Zeldovich
    from zeldovich_tpu_torch.utils.params import Parameters

    keys = par_keys(mix.root, mix.config, seed, mix.run_dir / "unused")
    with contextlib.redirect_stderr(mix.log):
        return Zeldovich(Parameters.from_dict(keys), dtype=mix.dtype, device=mix.device)


def warm_up(mix):
    """One realization at the cell's shapes."""
    m = model(mix, 1)
    out = m.xspace_half_pair()
    del out, m
    mix.points = None


def realize(mix, r, forward):
    """One request's model and ``forward(model)``, each part in a synced
    harness range; returns the step's output."""
    from torch.profiler import record_function

    mix.held = None  # one realization alive at a time
    t0 = time.perf_counter()
    with record_function("bench.setup_tables"):
        m = model(mix, r["seed"])
        sync(mix.device)
    t1 = time.perf_counter()
    with record_function("bench.static_fields"):
        _ = (m.pk_eff, m.plt_coefs)
        sync(mix.device)
    t2 = time.perf_counter()
    with record_function("bench.step"):
        out = forward(m)
        sync(mix.device)
    r["spans"]["setup_tables"] = t1 - t0
    r["spans"]["static_fields"] = t2 - t1
    return out


def step(mix, r) -> bool:
    out = realize(mix, r, lambda m: m.xspace_half_pair())
    if mix.points is None:
        mix.points = checks.sample_points(mix.seed, tuple(out.shape), POINTS, out.device)
    r["values"] = out.reshape(-1)[mix.points]  # the consumer's read
    r["shape"] = tuple(out.shape)
    mix.held = (r, out)
    return True


def end_to_end(mix, window_s: float) -> dict:
    return {"mem_Mpart_s": mix.particles() / window_s / 1e6}


def check(mix, r, fields) -> dict:
    if "whole" in r:
        return checks.check_pairs(r["whole"], fields, mix.ppd)
    return checks.check_points(r["values"], mix.points, r["shape"], fields)
