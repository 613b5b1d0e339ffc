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
a checkpoint holds before anything is loaded; ``load_kspace_pair(path,
rows=(y0, y1))`` reads only a rank's rows.

Over a mesh of ranks (``parallel/``) there are two more:

* ``--sharded --part 1`` without ``--distributed`` gathers the grid into
  the one-device chunk directory above (``save_kspace_gathered``: rank 0
  receives the y-slabs in rank order), as the JAX CLI saves a gathered
  grid there; ``--part 2`` reads each rank's rows of it, so one-device and
  ``--sharded`` checkpoints resume each other;
* ``--distributed --part 1`` writes each rank's y-slab of k space
  ``(narray, 2, Yl, Z, X)`` as ``shard_r{rank}.npy`` and rank 0 a
  ``meta.json`` with the shape, the dtype, the world size and every rank's
  y range (``save_sharded``, the counterpart of the JAX ``save_sharded``
  :123, which dumps a shard a device); ``load_sharded`` (JAX :156) refuses
  a checkpoint cut for another world size, y split, shape or dtype.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .streamio import gathered_chunks, send_to_rank0, stream_to_host

__all__ = ["save_kspace", "load_kspace", "load_kspace_pair", "kspace_layout",
           "check_kspace", "remove_kspace", "save_kspace_gathered", "save_sharded",
           "load_sharded", "CheckpointMismatch"]


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


def check_kspace(path, narray: int, ppd: int, dtype_name: str):
    """Raise CheckpointMismatch unless the checkpoint at ``path`` holds a
    grid this run takes: the pair layout (narray, 2, Y, Z, X) of
    ``dtype_name``, or the JAX CLI's complex (narray, Y, Z, X) grid of that
    precision."""
    grid = (ppd,) * 3
    takes = {(narray, 2, *grid): dtype_name,
             (narray, *grid): f"complex{16 * np.dtype(dtype_name).itemsize}"}
    shape, held, _ = kspace_layout(path)
    if takes.get(shape) != held.name:
        raise CheckpointMismatch(
            f"checkpoint holds {held.name} {shape} but this run expects "
            + " or ".join(f"{d} {s}" for s, d in takes.items())
            + " (part 1/2 must use the same .par and --dtype)")


def load_kspace_pair(path, rows=None) -> np.ndarray:
    """Load a checkpoint as the pair layout, real (narray, 2, Y, Z, X), or
    its y rows [y0, y1) with ``rows=(y0, y1)``.

    A complex (narray, Y, Z, X) checkpoint is split into its real and
    imaginary parts chunk by chunk, straight into the one real host array,
    so no second whole grid exists; a real checkpoint loads as it is.
    Only the chunks that hold the rows are read.
    """
    path = Path(path)
    shape, dtype, chunk = kspace_layout(path)
    cplx = dtype.kind == "c"
    if not cplx and rows is None:
        return load_kspace(path)
    y0, y1 = (0, shape[-3]) if rows is None else rows
    lead = (shape[0], 2) if cplx else shape[:-3]
    out = np.empty((*lead, y1 - y0, *shape[-2:]), dtype=np.empty(0, dtype).real.dtype)
    for c0 in range(0, shape[-3], chunk):
        a, b = max(c0, y0), min(c0 + chunk, y1)
        if a >= b:
            continue
        k = np.load(path / f"k_{c0:05d}.npy")[..., a - c0:b - c0, :, :]
        if cplx:
            out[:, 0, a - y0:b - y0] = k.real
            out[:, 1, a - y0:b - y0] = k.imag
        else:
            out[..., a - y0:b - y0, :, :] = k
    return out


def remove_kspace(path):
    import shutil

    shutil.rmtree(path, ignore_errors=True)


# -- checkpoints over a mesh of ranks -----------------------------------


class CheckpointMismatch(ValueError):
    """A checkpoint that this run (its ranks, shape or dtype) cannot resume."""


def _dtype_str(t) -> str:
    return np.dtype(str(t.dtype).removeprefix("torch.")).str


def save_kspace_gathered(yslab, path, mesh, target_bytes: int = 1 << 30) -> Path:
    """``save_kspace`` of the grid whose y-slab ``(narray, 2, Yl, Z, X)``
    each rank of ``mesh`` holds: rank 0 receives the slabs in rank order
    (= y order) in chunks of whole y rows and writes the one-device chunk
    directory; the other ranks send theirs.  Every rank returns once it is
    written."""
    path = Path(path)
    yl = yslab.shape[2]
    shape = (*yslab.shape[:2], yl * mesh.world, *yslab.shape[3:])
    chunk = _chunk_y(shape, yslab.element_size(), target_bytes)
    while yl % chunk:
        chunk -= 1
    if mesh.rank != 0:
        send_to_rank0(yslab, 2, chunk, mesh)
    else:
        remove_kspace(path)
        path.mkdir(parents=True, exist_ok=True)
        stream_to_host(gathered_chunks(yslab, 2, chunk, mesh),
                       lambda y0, h: np.save(path / f"k_{y0:05d}.npy", h))
        (path / "meta.json").write_text(json.dumps(
            {"shape": list(shape), "dtype": _dtype_str(yslab), "chunk": chunk}))
    mesh.barrier()
    return path


def _sharded_meta(shape, dtype: str, mesh) -> dict:
    yl = shape[2] // mesh.world
    return {"shape": list(shape), "dtype": dtype, "world": mesh.world,
            "y_ranges": [[r * yl, (r + 1) * yl] for r in range(mesh.world)]}


def save_sharded(yslab, path, mesh) -> Path:
    """Checkpoint the k-space grid whose y-slab ``(narray, 2, Yl, Z, X)``
    each rank holds: every rank saves its own as ``shard_r{rank}.npy``,
    rank 0 ``meta.json`` (written last, the validity marker).  Rank 0 wipes
    a stale checkpoint first, and no rank writes before it has."""
    path = Path(path)
    if mesh.rank == 0:
        remove_kspace(path)
        path.mkdir(parents=True, exist_ok=True)
    mesh.barrier()
    np.save(path / f"shard_r{mesh.rank}.npy", yslab.cpu().numpy())
    mesh.barrier()
    if mesh.rank == 0:
        shape = (*yslab.shape[:2], yslab.shape[2] * mesh.world, *yslab.shape[3:])
        (path / "meta.json").write_text(json.dumps(
            _sharded_meta(shape, _dtype_str(yslab), mesh)))
    mesh.barrier()
    return path


def load_sharded(path, mesh, shape, dtype, device) -> "torch.Tensor":
    """This rank's y-slab of a ``save_sharded`` checkpoint, on ``device``.

    Raises CheckpointMismatch on every rank unless the checkpoint was cut
    for this run: the grid ``shape`` (narray, 2, Y, Z, X) in numpy
    ``dtype``, this mesh's world size and y split; a rank whose shard is
    missing fails them all alike (the ranks agree before any returns)."""
    import torch

    path = Path(path)
    want = _sharded_meta(tuple(shape), np.dtype(dtype).str, mesh)
    err = None
    try:
        got = json.loads((path / "meta.json").read_text())
        if got != want:
            raise CheckpointMismatch(
                f"checkpoint {path} was cut for world {got.get('world')}, y ranges "
                f"{got.get('y_ranges')}, {got.get('dtype')} {got.get('shape')}, but "
                f"this run is world {want['world']}, y ranges {want['y_ranges']}, "
                f"{want['dtype']} {want['shape']} (part 1/2 must use the same .par, "
                "--dtype and number of processes)")
        shard = np.load(path / f"shard_r{mesh.rank}.npy")
    except (OSError, ValueError) as e:
        err = e if isinstance(e, CheckpointMismatch) else CheckpointMismatch(
            f"no sharded checkpoint at {path} for rank {mesh.rank}: {e}")
    if not mesh.agree(err is None):
        raise err or CheckpointMismatch(
            f"checkpoint {path}: another rank cannot resume its shard")
    return torch.from_numpy(shard).to(device)
