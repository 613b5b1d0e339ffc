#!/usr/bin/env python3
"""Whether the k_cutoff sphere alone parts ``bench_torch/reference.py`` from
the program at a configuration's size.

    python3 scripts/sphere_witness.py [--config odd576] [--ppd N]
        [--seeds S ...] [--device cuda] [--out FILE]

For each ``ZD_Seed`` it runs the model API's step
(``Zeldovich.xspace_half_pair``) on the configuration in float64, and
prints the numbers of ``bench_torch/checks.py::check_pairs`` for three
comparisons:

* ``program_sphere``: the step against ``reference_sphere.fields`` (the
  Nyquist wavenumber as pi / separation, as zeldovich-PLT and the program
  derive it);
* ``program_plain``: the step against ``reference.fields`` (pi ppd /
  BoxSize);
* ``sphere_plain``: ``reference_sphere``'s fields, packed as the step packs
  its output, against ``reference.fields``: the two references alone.

Where the sphere is the whole cause, ``program_sphere`` reads rounding and
``program_plain`` reads what ``sphere_plain`` reads.  ``--ppd`` cuts the
configuration as the CPU rehearsal does (``rehearse.shrink``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "bench_torch"))
sys.path.insert(0, str(ROOT))

import checks  # noqa: E402
import reference  # noqa: E402
import reference_sphere  # noqa: E402
import rehearse  # noqa: E402
from mixes import par_keys  # noqa: E402


def packed(fields, narray: int, ppd: int, device):
    """Reference fields in the step's (narray, 2, Y, Z, X) layout."""
    out = torch.zeros((narray, 2, ppd, ppd, ppd), dtype=torch.float64, device=device)
    for name, f in fields:
        a, c = checks.PAIR_SLOTS[name]
        out[a, c] = f
        del f
    return out


def witness(config: dict, seed: int, device: str) -> dict:
    from zeldovich_tpu_torch.models.pipeline import Zeldovich
    from zeldovich_tpu_torch.utils.params import Parameters

    ppd = round(int(config["par"]["NP"]) ** (1 / 3))
    keys = par_keys(ROOT, config, seed, Path("unused"))
    out = Zeldovich(Parameters.from_dict(keys), dtype=torch.float64,
                    device=device).xspace_half_pair()
    narray = out.shape[0]
    res = {"seed": seed, "ppd": ppd,
           "program_sphere": checks.check_pairs(
               out, reference_sphere.fields(keys, ROOT, device=device), ppd),
           "program_plain": checks.check_pairs(
               out, reference.fields(keys, ROOT, device=device), ppd)}
    del out
    sphere = packed(reference_sphere.fields(keys, ROOT, device=device), narray, ppd, device)
    res["sphere_plain"] = checks.check_pairs(
        sphere, reference.fields(keys, ROOT, device=device), ppd)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="odd576")
    ap.add_argument("--ppd", type=int)
    ap.add_argument("--seeds", type=int, nargs="+", default=[12345])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    config = json.loads((ROOT / "bench_torch" / "configs" / f"{args.config}.json").read_text())
    if args.ppd:
        rehearse.shrink(args.ppd)(config)
    lines = []
    for seed in args.seeds:
        lines.append(witness(config, seed, args.device))
        print(json.dumps(lines[-1]), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
