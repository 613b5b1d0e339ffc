"""Overlapped device->host output streaming for torch tensors.

Port of ``zeldovich_tpu/utils/streamio.py::stream_xspace`` for the pair
layout (narray, 2, Y, Z, X).  On a CUDA tensor, z-chunks are sliced on the
device and copied into pinned host buffers on a side stream, one chunk
ahead of the writer: while chunk i+1 is in flight, chunk i is rebuilt
into complex slabs and handed to the same background ``AsyncSlabWriter``
/ ``OutputWriter`` the JAX package uses, so the ic_* bytes are produced by
the same code from the same float32 values.
"""

from __future__ import annotations

import torch

from zeldovich_tpu.utils.streamio import AsyncSlabWriter, _chunk_planes, _flush_chunk


def stream_xspace(x, writer):
    """Stream an x-space pair grid (narray, 2, Y, Z, X) through the writer
    in z-chunks of ~256 MB; closes the writer."""
    ppd = x.shape[-2]
    chunk = _chunk_planes(x.shape, x.element_size(), ppd, True, 256 << 20)
    starts = list(range(0, ppd, chunk))
    aw = AsyncSlabWriter(writer)
    try:
        if x.device.type == "cpu":
            for z0 in starts:
                _flush_chunk(aw, z0, x[:, :, :, z0:z0 + chunk, :].numpy(), pair=True)
        else:
            _stream_cuda(x, aw, starts, chunk)
    finally:
        aw.close()
    return writer


def _stream_cuda(x, aw, starts, chunk):
    """Double-buffered D2H: device staging -> pinned host on a side stream."""
    shape = (*x.shape[:3], chunk, x.shape[-1])
    dev = [torch.empty(shape, dtype=x.dtype, device=x.device) for _ in range(2)]
    host = [torch.empty(shape, dtype=x.dtype, pin_memory=True) for _ in range(2)]
    side = torch.cuda.Stream(device=x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))  # x is complete

    def start_copy(i):
        b = i % 2
        with torch.cuda.stream(side):
            z0 = starts[i]
            dev[b].copy_(x[:, :, :, z0:z0 + chunk, :])
            host[b].copy_(dev[b], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        return ev

    def flush(j, ev):
        ev.synchronize()
        _flush_chunk(aw, starts[j], host[j % 2].numpy(), pair=True)

    try:
        pending = None  # (index, event)
        for i in range(len(starts)):
            # host[i % 2] was last read by the synchronous flush of chunk i-2
            ev = start_copy(i)
            if pending is not None:
                flush(*pending)
            pending = (i, ev)
        flush(*pending)
    finally:
        side.synchronize()  # no copy may outlive the staging buffers
