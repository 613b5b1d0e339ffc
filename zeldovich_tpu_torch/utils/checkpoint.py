"""Chunked k-space checkpoints: the in-core PART1/PART2 boundary.

Port of ``zeldovich_tpu/utils/checkpoint.py::save_kspace`` for torch
tensors, in the JAX package's format:

    zeldovich.kspace.ckpt/
      k_00000.npy          y-chunks [.., y0:y0+chunk, Z, X]
      ...
      meta.json            {shape, dtype, chunk}, written LAST (the
                           validity marker)

The chunks stream off the device one ahead (``stream_to_host``).
``_chunk_y``, ``load_kspace`` and ``remove_kspace`` are copies of the JAX
package's (numpy only).

Which layouts cross over.  The port writes the pair layout, real
``(narray, 2, Y, Z, X)``; the JAX package's ``load_kspace`` reads it, and
its ``--pair`` runs write the same.  The JAX CLI's default in-core
checkpoint is the complex grid of ``Zeldovich.kspace()``, complex
``(narray, Y, Z, X)``: ``load_kspace_pair`` reads either and returns the
pair layout, ``stack([k.real, k.imag], axis=1)``, converting a complex
checkpoint one y-chunk at a time.  ``kspace_layout`` tells a caller what
a checkpoint holds before anything is loaded.  The JAX package's sharded
checkpoints are not read (ROADMAP A10).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .streamio import stream_to_host

__all__ = ["save_kspace", "load_kspace", "load_kspace_pair", "kspace_layout",
           "remove_kspace"]


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


def kspace_layout(path) -> tuple[tuple, np.dtype, int]:
    """(shape, dtype, y-chunk) of the grid a checkpoint holds, from its
    meta.json."""
    meta = json.loads((Path(path) / "meta.json").read_text())
    return tuple(meta["shape"]), np.dtype(meta["dtype"]), meta["chunk"]


def load_kspace_pair(path) -> np.ndarray:
    """Load a checkpoint as the pair layout, real (narray, 2, Y, Z, X).

    A complex (narray, Y, Z, X) checkpoint is split into its real and
    imaginary parts chunk by chunk, straight into the one real host array,
    so no second whole grid exists; a real checkpoint loads as it is.
    """
    path = Path(path)
    shape, dtype, chunk = kspace_layout(path)
    if dtype.kind != "c":
        return load_kspace(path)
    out = np.empty((shape[0], 2, *shape[1:]), dtype=np.empty(0, dtype).real.dtype)
    for y0 in range(0, shape[-3], chunk):
        k = np.load(path / f"k_{y0:05d}.npy")
        out[:, 0, y0 : y0 + chunk] = k.real
        out[:, 1, y0 : y0 + chunk] = k.imag
    return out


def remove_kspace(path):
    import shutil

    shutil.rmtree(path, ignore_errors=True)
