"""Particle Linear Theory eigenmodes: table IO + trilinear lookup in torch.

Port of ``zeldovich_tpu/ops/plt.py`` (whose module imports jax): the
reference get_eigenmode/interp_eigmode (src/zeldovich.cpp:149-276) as
vectorized gathers, with the JAX package's order of evaluation so float32
results agree to a few ulp and float64 results to rounding.  Tables come
from the reference's ``eigmodes128`` or from
``ops/lattice.py::generate_eigmodes_table`` at any size.

``TableRead`` reads a table on a worker thread, into pinned memory and on
to the card in one copy, while the thread that made it does other work
(``Zeldovich.__init__`` builds P(k) and the pcg64 tables meanwhile).
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..utils.timers import adopt, current, span


def read_eigmodes(path, pin: bool = False) -> torch.Tensor:
    """Read an eigenmode table -> float64 tensor (ppd_e, ppd_e, ppd_e//2+1, 4)
    on the host (in pinned memory where ``pin``): the ``<i4`` header, then
    the ``<f8`` payload read straight into the tensor's storage."""
    with open(path, "rb", buffering=0) as fp:
        head = fp.read(4)
        size = os.fstat(fp.fileno()).st_size
        ppd_e = int(np.frombuffer(head, dtype="<i4")[0])
        nelem = ppd_e * ppd_e * (ppd_e // 2 + 1) * 4
        expect = 4 + nelem * 8
        if size == expect:
            table = torch.empty((ppd_e, ppd_e, ppd_e // 2 + 1, 4), dtype=torch.float64,
                                pin_memory=pin)
            view = memoryview(table.numpy().reshape(-1).view(np.uint8))
            got = 0
            while got < len(view) and (n := fp.readinto(view[got:])):
                got += n
            size = 4 + got
    if size != expect:
        raise ValueError(
            f"eigenmode file {path}: size {size} != expected {expect} "
            f"for ppd {ppd_e}"
        )
    return table


def load_eigmodes(path) -> np.ndarray:
    """Read an eigenmode table -> float64 array (ppd_e, ppd_e, ppd_e//2+1, 4)."""
    return read_eigmodes(path).numpy()


class TableRead:
    """``read_eigmodes(path)`` on a worker thread, sent on to ``device``.

    On a card the table is read into pinned memory and sent with one
    non-blocking copy on a stream of the worker's, which then waits for
    the copy; elsewhere the host tensor is the table.  The worker's span
    ``setup.eigmodes`` (count ``bytes``, the payload) takes as parent the
    span open where the read was made.  ``join()`` waits for the worker
    in the span ``setup.eig_wait``, makes the caller's current stream wait
    for the copy, returns the table and raises the worker's error
    unchanged; ``close()`` only waits for the worker (for a caller that
    failed before it joined).
    """

    def __init__(self, path, device):
        device = torch.device(device)
        # a new thread's current card is card 0, not this thread's
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self._device = device
        self._table = self._event = self._error = None
        # the stream that will read the table: its memory is allocated for it
        stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        self._thread = threading.Thread(
            target=self._run, args=(path, stream, current()), daemon=True,
            name="zt-eigmodes")
        self._thread.start()

    def _run(self, path, stream, parent):
        adopt(parent)
        try:
            with span("setup.eigmodes") as counts:
                if stream is None:
                    self._table = read_eigmodes(path).to(self._device)
                else:
                    with torch.cuda.device(self._device):
                        self._send(read_eigmodes(path, pin=True), stream)
                counts["bytes"] = self._table.nbytes
        except BaseException as e:  # noqa: BLE001 - re-raised by join()
            self._error = e

    def _send(self, host, stream):
        with torch.cuda.stream(stream):
            table = torch.empty(host.shape, dtype=host.dtype, device=self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(stream)  # after the work that used the block before
        with torch.cuda.stream(side):
            table.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record(side)
        event.synchronize()
        self._table, self._event = table, event

    def join(self) -> torch.Tensor:
        with span("setup.eig_wait"):
            self._thread.join()
        if self._error is not None:
            raise self._error
        if self._event is not None:
            torch.cuda.current_stream(self._device).wait_event(self._event)
        return self._table

    def close(self):
        self._thread.join()


def save_eigmodes(path, table):
    """Write a table (numpy array or tensor) in the reference binary format:
    a ``<i4`` ppd_e, then the ``<f8`` data."""
    if isinstance(table, torch.Tensor):
        table = table.detach().cpu().numpy()
    ppd_e = table.shape[0]
    if table.shape != (ppd_e, ppd_e, ppd_e // 2 + 1, 4):
        raise ValueError(f"eigenmode table of shape {table.shape}")
    with open(path, "wb") as fp:
        np.array([ppd_e], dtype="<i4").tofile(fp)
        np.ascontiguousarray(table, dtype="<f8").tofile(fp)


def _interp_eigmode(ikx, iky, ikz, ppd: int, table, fdt):
    """Trilinear interpolation in k-index space (zeldovich.cpp:154-227).

    ikx, iky in [0, ppd); ikz in [0, ppd/2].  Returns (..., 4) in fdt.
    """
    eig_ppd = table.shape[0]
    halfppd = eig_ppd // 2 + 1
    ppdhalf = eig_ppd // 2

    if eig_ppd % ppd == 0:
        # grid points coincide: direct gather
        step = eig_ppd // ppd
        return table[ikx * step, iky * step, ikz * step].to(fdt)

    npf = np.float32 if fdt == torch.float32 else np.float64
    scale = float(npf(eig_ppd) / npf(ppd))
    fx = scale * ikx.to(fdt)
    fy = scale * iky.to(fdt)
    fz = scale * ikz.to(fdt)

    # don't interpolate across the +Nyquist / -Nyquist discontinuity
    def fix(f):
        return torch.where((f > ppdhalf) & (f < halfppd), torch.floor(f + 1), f)

    fx, fy, fz = fix(fx), fix(fy), fix(fz)

    ixl = fx.to(torch.int64)
    iyl = fy.to(torch.int64)
    izl = fz.to(torch.int64)
    # ik_h == eig_ppd wraps to 0 (interpolate between -1 and 0 frequencies)
    ixh = torch.where(ixl + 1 == eig_ppd, 0, ixl + 1)
    iyh = torch.where(iyl + 1 == eig_ppd, 0, iyl + 1)
    izh = torch.where(izl + 1 == eig_ppd, 0, izl + 1)
    izh = torch.clamp(izh, max=halfppd - 1)

    fx = fx - ixl
    fy = fy - iyl
    fz = fz - izl

    t = table.to(fdt)
    w = lambda a: a[..., None]
    return (
        w((1 - fx) * (1 - fy) * (1 - fz)) * t[ixl, iyl, izl]
        + w((1 - fx) * (1 - fy) * fz) * t[ixl, iyl, izh]
        + w((1 - fx) * fy * (1 - fz)) * t[ixl, iyh, izl]
        + w((1 - fx) * fy * fz) * t[ixl, iyh, izh]
        + w(fx * (1 - fy) * (1 - fz)) * t[ixh, iyl, izl]
        + w(fx * (1 - fy) * fz) * t[ixh, iyl, izh]
        + w(fx * fy * (1 - fz)) * t[ixh, iyh, izl]
        + w(fx * fy * fz) * t[ixh, iyh, izh]
    )


def eigenmode_lookup(kx, ky, kz, ppd: int, table, dtype=torch.float64):
    """get_eigenmode (zeldovich.cpp:229-276), vectorized.

    kx, ky, kz: broadcastable integer wavenumber tensors (wrapped to
    [-ppd/2, ppd/2]).  Returns ((ex, ey, ez), eigenvalue), the vector
    carrying the ``k^2 / (k . e_hat)`` up-weighting (zero where
    ill-defined).
    """
    fdt = dtype
    kx, ky, kz = torch.broadcast_tensors(kx, ky, kz)
    ikx = torch.where(kx < 0, ppd + kx, kx)
    iky = torch.where(ky < 0, ppd + ky, ky)
    ikz = torch.where(kz < 0, ppd + kz, kz)
    # rfft convention: use the +kz half-space index
    ikz = torch.where(ikz > ppd // 2, ppd - ikz, ikz)

    e = _interp_eigmode(ikx, iky, ikz, ppd, table, fdt)
    ex, ey, ez, ev = e[..., 0], e[..., 1], e[..., 2], e[..., 3]
    # the real FFT only stores the +kz half-space: flip the z component
    ez = ez * torch.where(kz < 0, -1.0, 1.0).to(fdt)

    mag = torch.sqrt(ex * ex + ey * ey + ez * ez)
    mag = torch.where(mag == 0, 1.0, mag)
    ex, ey, ez = ex / mag, ey / mag, ez / mag

    k2 = (kx * kx + ky * ky + kz * kz).to(fdt)
    dot = kx.to(fdt) * ex + ky.to(fdt) * ey + kz.to(fdt) * ez
    norm = k2 / torch.where(dot == 0, 1.0, dot)
    norm = torch.where((k2 == 0) | (dot == 0) | ~torch.isfinite(norm), 0.0, norm)
    return (norm * ex, norm * ey, norm * ez), ev
