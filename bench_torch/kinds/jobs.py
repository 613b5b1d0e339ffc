"""Request kind ``jobs``: each request is one in-process
``zeldovich_tpu_torch.cli.main([par, *flags])``, the path users run,
writing its ``ic_*`` files into a directory of its own under the run
directory; the next starts when it has returned.

End to end: ``file_Mpart_s``, every particle of every job over the
window.  Check: the sampled jobs' files against the reference
(``checks.check_files``).
"""

from __future__ import annotations

import contextlib
import io
import sys

import checks
from mixes import par_keys


def write_par(path, keys: dict):
    path.write_text("".join(f'{k} = "{v}"\n' if isinstance(v, str) else f"{k} = {v}\n"
                            for k, v in keys.items()))
    return path


def _slab_mb(flags) -> int:
    return int(flags[flags.index("--slab-mb") + 1]) if "--slab-mb" in flags else 2048


def warm_up(mix):
    """One forward step of the job's route at the cell's shapes, nothing
    written: in core the half step; out of core pass 1's synthesis and zx
    on one y-slab and pass 2's y DFT on a z-slab of that shape."""
    from zeldovich_tpu_torch.utils.params import Parameters

    keys = par_keys(mix.root, mix.config, 1, mix.run_dir / "warm")
    flags = mix.config.get("flags", [])
    with contextlib.redirect_stderr(mix.log):
        param = Parameters.from_dict(keys)
        if "--out-of-core" in flags:
            from zeldovich_tpu_torch.models.outofcore import OutOfCoreZeldovich
            from zeldovich_tpu_torch.ops.mmfft import dft_y

            m = OutOfCoreZeldovich(param, dtype=mix.dtype, slab_bytes=_slab_mb(flags) << 20,
                                   device=mix.device)
            y = m._pass1_slab(0)
            z = y.transpose(2, 3).contiguous()
            dft_y(z, +1, out=z)
            del y, z, m
        else:
            from zeldovich_tpu_torch.models.pipeline import Zeldovich

            m = Zeldovich(param, dtype=mix.dtype, device=mix.device)
            out = m.xspace_half_pair()
            del out, m


def step(mix, r) -> bool:
    from zeldovich_tpu_torch.cli import main as cli_main

    outdir = mix.run_dir / f"job{r['index']}"
    par = write_par(mix.run_dir / f"job{r['index']}.par",
                    par_keys(mix.root, mix.config, r["seed"], outdir))
    flags = [*mix.config.get("flags", []), "--dtype", mix.config["dtype"],
             "--device", mix.device]
    log = io.StringIO()
    with contextlib.redirect_stderr(log):
        rc = cli_main([str(par), *flags])
    r["outdir"] = outdir
    if rc != 0:
        print(f"job {r['index']} exited {rc}:\n{log.getvalue()[-2000:]}", file=sys.stderr)
    return rc == 0


def end_to_end(mix, window_s: float) -> dict:
    return {"file_Mpart_s": mix.particles() / window_s / 1e6}


def check(mix, r, ref) -> dict:
    par = mix.config["par"]
    plt = bool(int(par.get("ZD_qPLT", 0)))
    f_vel = ((1.0 + 24 * float(par.get("ZD_f_cluster", 1.0))) ** 0.5 - 1) * 0.25
    return checks.check_files(r["outdir"], mix.ppd, int(par["CPD"]), ref, plt, f_vel, mix.device)
