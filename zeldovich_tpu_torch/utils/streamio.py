"""Overlapped host <-> device slab streaming for torch tensors.

Port of ``zeldovich_tpu/utils/streamio.py::stream_xspace`` for the pair
layout (narray, 2, Y, Z, X), and of the out-of-core streaming loops
(``models/outofcore.py::_stream_to_host`` and the staged z-slab loads):

* ``stream_to_host(items, sink)``: device results to a host sink one slab
  behind dispatch.  On CUDA each result is copied into one of two pinned
  host buffers on a side stream, so slab i+1's compute and copy are in
  flight while slab i is consumed on the host;
* ``slabs_to_device(keys, view, device)``: host slabs (strided views of a
  staging buffer) to the device.  On CUDA each view is gathered into one
  of two pinned buffers and copied non-blocking, so the host gather of
  slab i+1 overlaps the device's work on slab i;
* ``write_zslabs(items, writer)``: the one loop from device z-chunks to
  the ic_* files: each ``(z0, z-chunk)`` to the host (``stream_to_host``),
  its complex planes to the background ``AsyncSlabWriter`` and
  ``OutputWriter``, copies of the JAX package's (``AsyncSlabWriter`` and
  ``_flush_chunk``, pair layout only), so the ic_* bytes are produced by
  the same code from the same values.  Every run writes through it:
  ``stream_xspace`` (a grid or a rank's z-slab in z-chunks of ~256 MB),
  ``stream_xspace_sharded`` (every rank's z-slab through rank 0's writer
  in z order) and the out-of-core pass 2 (``models/outofcore.py``).

On the CPU both directions are plain host copies.

The host's steps are spans (``utils/timers.py``): ``stage.gather``,
``copy.wait``, ``output.combine``, ``output.submit_wait`` here, and
``output.pack``/``output.write`` on the writer's thread.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .timers import adopt, current, span


class AsyncSlabWriter:
    """Runs ``writer.write_slab`` calls on a background thread.

    Submissions are FIFO (the density file and per-file appends require
    z-order within each ic_* file); all writer-state mutation happens on
    the one worker thread, so OutputWriter needs no locking.  Errors are
    captured and re-raised on the submitting thread at the next submit()
    or at close().  The thread's spans take as parent the span open where
    the writer was made; the submitting thread's waits are spans
    ``output.submit_wait``.
    """

    def __init__(self, writer, depth: int = 4):
        self.writer = writer
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._error: BaseException | None = None
        self._t = threading.Thread(
            target=self._loop, args=(current(),), daemon=True, name="zt-slab-writer"
        )
        self._t.start()

    def _loop(self, parent):
        adopt(parent)
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._error is None:
                try:
                    self.writer.write_slab(*item)
                except BaseException as e:  # noqa: BLE001 - repropagated
                    self._error = e

    def submit(self, z: int, slab: np.ndarray):
        if self._error is not None:
            raise self._error
        with span("output.submit_wait"):
            self._q.put((z, slab))

    def close(self):
        with span("output.submit_wait"):
            self._q.put(None)
            self._t.join()
        try:
            if self._error is not None:
                raise self._error
        finally:
            # close file handles even on a captured worker error (ENOSPC
            # mid-run must not leak the density fp / parallel ic_* fds)
            self.writer.close()


def _flush_chunk(aw: AsyncSlabWriter, z0: int, c):
    h = np.asarray(c)
    with span("output.combine"):
        h = h[:, 0] + 1j * h[:, 1]
    for dz in range(h.shape[2]):
        aw.submit(z0 + dz, h[:, :, dz, :])


def _pinned_like(buf, shape, dtype):
    """buf if it already has shape and dtype, else a new pinned tensor."""
    if buf is not None and tuple(buf.shape) == tuple(shape) and buf.dtype == dtype:
        return buf
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def stream_to_host(items, sink):
    """sink(key, host ndarray) for each (key, tensor) of items, one behind.

    A CPU tensor goes to the sink as it is (a view: the sink copies what it
    keeps).  A CUDA tensor is copied to a pinned buffer on a side stream
    after the work that produced it; the sink sees it once that copy has
    ended, while the next item is already computed and copied.
    """
    bufs, side = [None, None], None
    pending = None  # (key, buffer, event, device tensor kept alive)
    try:
        for i, (key, t) in enumerate(items):
            if t.device.type == "cpu":
                sink(key, t.numpy())
                continue
            b = i % 2  # bufs[b] was last read by the sink of item i - 2
            bufs[b] = _pinned_like(bufs[b], t.shape, t.dtype)
            if side is None:
                side = torch.cuda.Stream(device=t.device)
            side.wait_stream(torch.cuda.current_stream(t.device))
            with torch.cuda.stream(side):
                bufs[b].copy_(t, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            if pending is not None:
                _sink_pending(sink, pending)
            pending = (key, bufs[b], ev, t)
        if pending is not None:
            _sink_pending(sink, pending)
            pending = None
    finally:
        if side is not None:
            side.synchronize()  # no copy may outlive its buffers


def _sink_pending(sink, pending):
    key, buf, ev, _ = pending
    with span("copy.wait"):
        ev.synchronize()
    sink(key, buf.numpy())


def slabs_to_device(keys, view, device):
    """Yield (key, tensor on device) with the contents of view(key).

    view(key) is a host ndarray, typically a strided slab of a staging
    buffer (RAM or np.memmap); it is never written through.  On CUDA the
    slab is gathered into one of two pinned buffers and copied
    non-blocking on the current stream.  The gather is the span
    ``stage.gather``, each wait on a copy ``copy.wait``.
    """
    device = torch.device(device)
    bufs, events = [None, None], [None, None]
    for i, key in enumerate(keys):
        src = view(key)
        if device.type == "cpu":
            with span("stage.gather"):
                host = np.array(src)
            yield key, torch.from_numpy(host)
            continue
        b = i % 2
        if events[b] is not None:
            with span("copy.wait"):
                events[b].synchronize()  # the copy that last read bufs[b]
        dtype = torch.from_numpy(np.empty(0, src.dtype)).dtype
        bufs[b] = _pinned_like(bufs[b], src.shape, dtype)
        with span("stage.gather"):
            np.copyto(bufs[b].numpy(), src)
        dev = torch.empty(src.shape, dtype=dtype, device=device)
        dev.copy_(bufs[b], non_blocking=True)
        events[b] = torch.cuda.Event()
        events[b].record()
        yield key, dev
    pending = [ev for ev in events if ev is not None]
    if pending:
        with span("copy.wait"):
            for ev in pending:
                ev.synchronize()


def _zslab_chunk(x) -> int:
    """z planes a chunk of the z-slab x (narray, 2, Y, Zl, X): the largest
    divisor of Zl within ~256 MB.  A divisor keeps every chunk the same
    shape, and on a whole grid the chunks are the JAX package's
    (``_chunk_planes``)."""
    na, two, ny, zl, nx = x.shape
    chunk = max(1, min(zl, (256 << 20) // (na * two * ny * nx * x.element_size())))
    while zl % chunk:
        chunk -= 1
    return chunk


def write_zslabs(items, writer):
    """Write each (z0, z-chunk (narray, 2, Y, Bz, X) of planes [z0, z0 +
    Bz)) of items through the writer, in order, one behind dispatch
    (``stream_to_host``); closes the writer, also when an item raises."""
    aw = AsyncSlabWriter(writer)
    try:
        stream_to_host(items, lambda z0, h: _flush_chunk(aw, z0, h))
    finally:
        aw.close()
    return writer


def stream_xspace(x, writer, z0: int = 0):
    """Stream an x-space pair grid (narray, 2, Y, Z, X), or the z-slab of
    planes [z0, z0 + Zl) (narray, 2, Y, Zl, X), through the writer in
    z-chunks of ~256 MB, one ahead; closes the writer."""
    chunk = _zslab_chunk(x)
    return write_zslabs(((z0 + dz, x[:, :, :, dz:dz + chunk, :].contiguous())
                         for dz in range(0, x.shape[3], chunk)), writer)


def send_to_rank0(x, axis: int, chunk: int, mesh):
    """Send this rank's slab x to rank 0 in chunks of ``chunk`` entries
    along ``axis`` (``gathered_chunks`` receives them)."""
    import torch.distributed as dist

    for o in range(0, x.shape[axis], chunk):
        dist.send(x.narrow(axis, o, chunk).contiguous(), 0, group=mesh.group)


def gathered_chunks(x, axis: int, chunk: int, mesh):
    """On rank 0: (offset along ``axis`` of the whole grid, chunk) for every
    rank's slab in rank order, its own x first, then each other rank's as
    ``send_to_rank0`` sends it, received into one buffer (chunk divides
    x.shape[axis], the same on every rank)."""
    import torch.distributed as dist

    n = x.shape[axis]
    for o in range(0, n, chunk):
        yield o, x.narrow(axis, o, chunk).contiguous()
    shape = list(x.shape)
    shape[axis] = chunk
    buf = torch.empty(shape, dtype=x.dtype, device=x.device)
    for r in range(1, mesh.world):
        for o in range(0, n, chunk):
            dist.recv(buf, r, group=mesh.group)
            # a copy the stream may keep while buf takes the next chunk
            yield r * n + o, buf.clone()


def stream_xspace_sharded(x, writer, mesh):
    """Write the x space of a sharded step through rank 0's writer.

    x is this rank's z-slab (narray, 2, Y, Zl, X).  Rank 0 writes its own
    slab's chunks, then each other rank's in rank order (= z order), in
    one ``write_zslabs``; the other ranks send theirs in the same chunks.
    ``writer`` is rank 0's (None on the others); closes it."""
    chunk = _zslab_chunk(x)
    if mesh.rank != 0:
        send_to_rank0(x, 3, chunk, mesh)
        return None
    return write_zslabs(gathered_chunks(x, 3, chunk, mesh), writer)
