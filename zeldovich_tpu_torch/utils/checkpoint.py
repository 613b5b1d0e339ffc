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
``_chunk_y``, ``load_kspace`` and ``remove_kspace`` are copies of the JAX
package's (numpy only).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .streamio import stream_to_host

__all__ = ["save_kspace", "load_kspace", "remove_kspace"]


def _chunk_y(shape, itemsize, target_bytes):
    Y = shape[-3]
    per_plane = int(np.prod(shape)) // Y * itemsize
    want = max(1, min(Y, int(target_bytes // per_plane) or 1))
    while Y % want:
        want -= 1
    return want


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


def load_kspace(path) -> np.ndarray:
    """Load a chunked checkpoint back into one host array."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    shape, chunk = tuple(meta["shape"]), meta["chunk"]
    out = np.empty(shape, dtype=np.dtype(meta["dtype"]))
    for y0 in range(0, shape[-3], chunk):
        out[..., y0 : y0 + chunk, :, :] = np.load(path / f"k_{y0:05d}.npy")
    return out


def remove_kspace(path):
    import shutil

    shutil.rmtree(path, ignore_errors=True)
