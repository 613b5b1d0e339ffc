"""Chunked k-space checkpoints: the in-core PART1/PART2 boundary.

Port of ``zeldovich_tpu/utils/checkpoint.py::save_kspace`` for torch
tensors, in the JAX package's format, so either package reads the
other's checkpoint:

    zeldovich.kspace.ckpt/
      k_00000.npy          y-chunks [.., y0:y0+chunk, Z, X]
      ...
      meta.json            {shape, dtype, chunk}, written LAST (the
                           validity marker)

The chunks stream off the device one ahead (``stream_to_host``).
``load_kspace`` and ``remove_kspace`` are the JAX package's (numpy only).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from zeldovich_tpu.utils.checkpoint import _chunk_y, load_kspace, remove_kspace

from .streamio import stream_to_host

__all__ = ["save_kspace", "load_kspace", "remove_kspace"]


def save_kspace(kgrid, path, target_bytes: int = 1 << 30) -> Path:
    """Checkpoint a k-space tensor [.., Y, Z, X] to a chunk directory."""
    path = Path(path)
    # a partial re-save over stale chunks must never pass for a
    # checkpoint: wipe first, write meta.json last
    remove_kspace(path)
    path.mkdir(parents=True, exist_ok=True)
    Y = kgrid.shape[-3]
    chunk = _chunk_y(kgrid.shape, kgrid.element_size(), target_bytes)
    items = ((y0, kgrid[..., y0:y0 + chunk, :, :].contiguous())
             for y0 in range(0, Y, chunk))
    stream_to_host(items, lambda y0, h: np.save(path / f"k_{y0:05d}.npy", h))
    dtype = np.dtype(str(kgrid.dtype).removeprefix("torch."))
    (path / "meta.json").write_text(json.dumps(
        {"shape": list(kgrid.shape), "dtype": dtype.str, "chunk": chunk}
    ))
    return path
