"""3-D DFTs of real pairs: the port of ``ops/mmfft.py``.

The pair layout is ``(..., 2, Y, Z, X)`` (re/im on axis -4), so a batch of
packed arrays ``(narray, 2, Y, Z, X)`` transforms as it is.  Every
transform is unnormalized in the FFTW sign convention (sign +1 the
inverse, no 1/N).  Two routes, chosen by the transform length n alone
(``fft_kernels_take``, the size term of the JAX package's kernel gates),
before anything is launched:

* n a power of two in [16, 2048]: the hand-written kernels.  A full grid
  (``ifft3_pair``, ``fft3_pair``) is ``y_dft`` (B8) then ``zx_dft``
  (B6/B7); a packed half spectrum (``ifft3_half_pair``) is ``zx_dft`` then
  ``c2r_y`` (B2).
* every other even n (576, 1152, 1728, 4096, ...): the matrix-product
  DFTs that the JAX package runs at those sizes outside any Pallas kernel
  (its ``cfft_axis``/``cfft_last`` and ``c2r_y_pair``), each product one
  ``torch.matmul`` on the tensor's device.  A length n up to
  ``DENSE_MAX`` of the element type (float32 384, float64 1152, measured on
  the card) is one dense n x n product; a longer one the four-step split
  n = n1 n2 of ``_factor``: two products and a twiddle.  The c2r is the dense
  (n, 2 (h+1)) product, or above ``DENSE_MAX`` the assembled full y
  spectrum and one DFT.  The matrices are built in float64 on the host
  and rounded once to the run's type; float32 products run at PyTorch's
  default float32 matmul precision (never TF32).  Each pass walks its
  operand in chunks of about ``_CHUNK`` elements and writes the chunk's
  result into the output (which may be the input), so its temporaries are
  a few chunks, not a few grids.

``plain=True`` runs the plain versions (``torch.fft``) on any device at
any n: the reference both routes are held against.  ``zx_dft``, ``y_dft``
and ``c2r_y`` themselves still raise for lengths the kernels do not take.

Each matrix-product pass is a span (``utils/timers.py``): ``mmfft.zx``
(``zx_mm``), ``mmfft.y`` (``y_mm``) and ``mmfft.c2r`` (``c2r_y_pair``),
named after this module and not after the products, with the counts ``n``
(the transform length), ``elems`` (the complex elements of the operand:
half its real numbers) and ``chunks`` (its chunk loop's passes).  While a
profiler runs on a CUDA device a span syncs the device when it opens and
at its close, so it holds its pass's device work alone; with none running
nothing waits.
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache

import numpy as np
import torch

from ..utils.timers import span, tracing
from .c2r import c2r_y, c2r_y_plain
from .fft import y_dft, y_dft_plain, zx_dft, zx_dft_plain
from .synth import fft_kernels_take

#: Above this length (by element type) a DFT takes the four-step split
#: instead of one dense n x n product, and the c2r the assembled form.
#: Measured on an NVIDIA H100 80GB HBM3 at 700 W with
#: scripts/torch_mmfft_crossover.py (PERF.md section 6): float32's dense
#: products run at ~40 TFLOP/s of the float32 pipes and lose the z/x/y
#: passes to the four-step from 576 on (the half step ties at 576);
#: float64's run on the FP64 tensor cores at ~45-50 TFLOP/s and win the
#: half step up to 1152, the four-step from 1536.  The JAX package's 1024
#: is its TPU's figure.
DENSE_MAX = {torch.float32: 384, torch.float64: 1152}

#: elements of a chunk's operand in the matrix-product passes
_CHUNK = 1 << 25


def _factor(n: int) -> tuple[int, int]:
    """Balanced factorization n = n1 * n2 with n1 <= n2."""
    n1 = math.isqrt(n)
    while n % n1:
        n1 -= 1
    return n1, n // n1


def _on(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A float64 host array rounded once to dtype on device."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


@lru_cache(maxsize=64)
def _dft_mats(n: int, sign: int, dtype, device):
    """(Wr, Wi - Wr, Wr + Wi) of the length-n DFT W[k, j] =
    exp(sign 2 pi i jk / n), the phase reduced mod n in integers: the
    three matrices of ``_cmatmul``."""
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign}")
    j = np.arange(n)
    ang = (sign * 2.0 * np.pi / n) * (np.outer(j, j) % n)
    wr, wi = np.cos(ang), np.sin(ang)
    return tuple(_on(m, dtype, device) for m in (wr, wi - wr, wr + wi))


@lru_cache(maxsize=64)
def _twiddle(n1: int, n2: int, sign: int, dtype, device):
    """T[k1, j2] = exp(sign 2 pi i k1 j2 / (n1 n2)) as (n1, n2, 1) cos, sin."""
    ang = (sign * 2.0 * np.pi / (n1 * n2)) * np.outer(np.arange(n1), np.arange(n2))
    return tuple(_on(m[:, :, None], dtype, device) for m in (np.cos(ang), np.sin(ang)))


@lru_cache(maxsize=64)
def _c2r_mats(n: int, dtype, device):
    """[C | S], (n, 2 (h+1)): for a Hermitian length-n spectrum g,
    x = C (2 Re g) + S (2 Im g) (the 1/2 of the doubled +/- packing folded
    in: C's edge columns halved, S's zero), t = 2 pi k y / n."""
    h = n // 2
    y, k = np.arange(n)[:, None], np.arange(h + 1)[None, :]
    t = (2.0 * np.pi / n) * ((y * k) % n)
    C, S = np.cos(t), -np.sin(t)
    C[:, [0, h]] *= 0.5
    S[:, [0, h]] = 0.0
    return _on(np.concatenate([C, S], axis=1), dtype, device)


def _apply(w, x):
    """w (m, n) along the middle axis of x (P, n, Q): (P, m, Q), one
    product (batched over P when both P and Q exceed 1)."""
    P, n, Q = x.shape
    if Q == 1:
        return torch.matmul(x.reshape(P, n), w.T).unsqueeze(-1)
    if P == 1:
        return torch.matmul(w, x[0]).unsqueeze(0)
    return torch.matmul(w, x)


def _cmatmul(ar, ai, mats):
    """W (ar + i ai) along the middle axis of (P, n, Q) operands with three
    real products (Gauss; the JAX package's ``_cmatmul`` /
    ``_cmatmul_axis``), both matrix-side combines made on the host:
    re = Wr ar - Wi ai = k1 - k3, im = Wr ai + Wi ar = k1 + k2."""
    wr, wd, ws = mats
    k1 = _apply(wr, ar + ai)
    im = _apply(wd, ar).add_(k1)
    return k1.sub_(_apply(ws, ai)), im


def _dense(re, im, sign: int):
    """One dense DFT product along the middle axis of (P, n, Q) pairs."""
    return _cmatmul(re, im, _dft_mats(re.shape[1], sign, re.dtype, re.device))


def _four_step(re, im, sign: int):
    """The four-step DFT along the middle axis of (P, n, Q) pairs, n = n1 n2
    from ``_factor``: x[j1 n2 + j2] as A[j1][j2], the n1-point DFT over j1,
    the twiddle T[k1, j2], the n2-point DFT over j2, X[k1 + n1 k2] =
    E[k1][k2] (JAX ``cfft_last``)."""
    P, n, Q = re.shape
    n1, n2 = _factor(n)
    dt, dev = re.dtype, re.device
    cr, ci = _cmatmul(re.reshape(P, n1, n2 * Q), im.reshape(P, n1, n2 * Q),
                      _dft_mats(n1, sign, dt, dev))
    tr, ti = _twiddle(n1, n2, sign, dt, dev)
    cr, ci = cr.view(P, n1, n2, Q), ci.view(P, n1, n2, Q)
    dr = cr * tr - ci * ti
    di = cr * ti + ci * tr
    del cr, ci
    er, ei = _cmatmul(dr.view(P * n1, n2, Q), di.view(P * n1, n2, Q),
                      _dft_mats(n2, sign, dt, dev))
    del dr, di
    return tuple(e.view(P, n1, n2, Q).transpose(1, 2).reshape(P, n, Q) for e in (er, ei))


def _dense_takes(n: int, dtype) -> bool:
    """Whether length n takes the dense product (and the dense c2r)."""
    return n <= DENSE_MAX[dtype]


def _dft_mid(re, im, sign: int):
    """DFT along the middle axis of (P, n, Q) pairs: dense up to DENSE_MAX
    (and for a length _factor cannot split), four-step above."""
    n = re.shape[1]
    if _dense_takes(n, re.dtype) or _factor(n)[0] == 1:
        return _dense(re, im, sign)
    return _four_step(re, im, sign)


def cfft_axis(re, im, axis: int, sign: int):
    """Complex DFT along ``axis`` of the real arrays (re, im), unnormalized:
    returns (re, im) transformed (JAX ``mmfft.cfft_axis``, and along the
    last axis its ``cfft_last``)."""
    shape = re.shape
    ax = axis % re.dim()
    P, n, Q = math.prod(shape[:ax]), shape[ax], math.prod(shape[ax + 1:])
    r, i = _dft_mid(re.reshape(P, n, Q), im.reshape(P, n, Q), sign)
    return r.reshape(shape), i.reshape(shape)


@contextlib.contextmanager
def _pass_span(name: str, device, **counts):
    """The span ``name`` of one matrix-product pass, the device synced at
    its open and close while a profiler runs (the module's docstring)."""
    sync = tracing() and device.type == "cuda"
    if sync:
        torch.cuda.synchronize(device)
    with span(name, **counts):
        yield
        if sync:
            torch.cuda.synchronize(device)


def _blocks(pair, out, what: str):
    """(pair, dst) as (batch, 2, A, B, C) views; dst is out (which may be
    pair) or a new tensor."""
    if pair.dim() < 4 or pair.shape[-4] != 2:
        raise ValueError(f"{what}: want (..., 2, A, B, C) pairs, got {tuple(pair.shape)}")
    if out is None:
        out = torch.empty_like(pair, memory_format=torch.contiguous_format)
    elif out.shape != pair.shape or out.dtype != pair.dtype or not out.is_contiguous():
        raise ValueError(f"{what}: want out contiguous {pair.dtype} {tuple(pair.shape)}")
    shape = (-1, *pair.shape[-4:])
    return pair.reshape(shape), out.view(shape), out


def zx_mm(pair, sign: int, out=None):
    """The matrix-product DFT over (z, x) of (..., 2, K, Z, X) pairs, a few
    K planes at a time; ``out`` may be pair (in place)."""
    src, dst, out = _blocks(pair, out, "zx_mm")
    nb, _, K, Z, X = src.shape
    kc = max(1, _CHUNK // (Z * X))
    with _pass_span("mmfft.zx", src.device, n=X, elems=src.numel() // 2,
                    chunks=nb * -(-K // kc)):
        for b in range(nb):
            for k0 in range(0, K, kc):
                ks = slice(k0, k0 + kc)
                re, im = _dft_mid(src[b, 0, ks], src[b, 1, ks], sign)  # z
                nk = re.shape[0]
                re, im = _dft_mid(re.reshape(nk * Z, X, 1), im.reshape(nk * Z, X, 1),
                                  sign)  # x
                dst[b, 0, ks] = re.view(nk, Z, X)
                dst[b, 1, ks] = im.view(nk, Z, X)
    return out


def y_mm(pair, sign: int, out=None):
    """The matrix-product DFT along axis -3 of (..., 2, Y, Bz, X) pairs, a
    full grid or a z-slab, a few z rows at a time; ``out`` may be pair."""
    src, dst, out = _blocks(pair, out, "y_mm")
    nb, _, Y, B, X = src.shape
    bc = max(1, _CHUNK // (Y * X))
    with _pass_span("mmfft.y", src.device, n=Y, elems=src.numel() // 2,
                    chunks=nb * -(-B // bc)):
        for b in range(nb):
            for z0 in range(0, B, bc):
                zs = slice(z0, z0 + bc)
                re, im = (src[b, c, :, zs].reshape(1, Y, -1) for c in (0, 1))
                re, im = _dft_mid(re, im, sign)
                dst[b, 0, :, zs] = re.view(Y, -1, X)
                dst[b, 1, :, zs] = im.view(Y, -1, X)
    return out


def c2r_y_pair(spm, out=None):
    """Half-spectrum inverse DFT along ky (unnormalized, sign +1), the
    matrix-product route (JAX ``mmfft.c2r_y_pair``).

    spm: (..., 2, 2, h+1, Z, X) = (+/- packing, re/im, ky, z, x), z and x
    already transformed, where S+- = D~ +- i F~ for two real fields; the
    length n = 2 h comes from the ky axis, so z-sliced blocks work.
    Returns (..., 2, n, Z, X) with re = D and im = F, written into ``out``
    (a new tensor when None) z rows at a time.  For n <= DENSE_MAX one
    product [C | S] [2 Re; 2 Im] a field; above, the full y spectrum of
    D + iF (rows k <= h are S+, rows k > h conj(S-[n - k])) and one DFT.
    """
    K, Z, X = spm.shape[-3:]
    n = 2 * (K - 1)
    if spm.dim() < 5 or spm.shape[-5:-3] != (2, 2) or n < 2:
        raise ValueError(f"c2r_y_pair: want (..., 2, 2, h+1, Z, X), got {tuple(spm.shape)}")
    shape = (*spm.shape[:-5], 2, n, Z, X)
    if out is None:
        out = torch.empty(shape, dtype=spm.dtype, device=spm.device)
    elif tuple(out.shape) != shape or out.dtype != spm.dtype or not out.is_contiguous():
        raise ValueError(f"c2r_y_pair: want out contiguous {spm.dtype} {shape}")
    s = spm.reshape(-1, 2, 2, K, Z * X)
    o = out.view(-1, 2, n, Z * X)
    rows = max(1, _CHUNK // (n * X))
    cs = _c2r_mats(n, spm.dtype, spm.device) if _dense_takes(n, spm.dtype) else None
    with _pass_span("mmfft.c2r", spm.device, n=n, elems=spm.numel() // 2,
                    chunks=s.shape[0] * -(-Z // rows)):
        for a in range(s.shape[0]):
            for z0 in range(0, Z, rows):
                c = slice(z0 * X, min(Z, z0 + rows) * X)
                (spr, spi), (smr, smi) = [[s[a, pm, r, :, c] for r in (0, 1)]
                                          for pm in (0, 1)]
                if cs is None:
                    re = torch.cat([spr, smr[1:-1].flip(0)]).unsqueeze(0)
                    im = torch.cat([spi, smi[1:-1].flip(0).neg()]).unsqueeze(0)
                    re, im = _dft_mid(re, im, +1)
                    o[a, 0, :, c], o[a, 1, :, c] = re[0], im[0]
                    continue
                two = torch.empty((2 * K, spr.shape[1]), dtype=spm.dtype,
                                  device=spm.device)
                torch.add(spr, smr, out=two[:K])  # 2 Re D~
                torch.add(spi, smi, out=two[K:])  # 2 Im D~
                o[a, 0, :, c] = torch.matmul(cs, two)
                torch.sub(spi, smi, out=two[:K])  # 2 Re F~
                torch.sub(smr, spr, out=two[K:])  # 2 Im F~
                o[a, 1, :, c] = torch.matmul(cs, two)
    return out


def dft_zx(pair, sign: int, out=None):
    """The routed DFT over (z, x) of (..., 2, K, n, n) pairs: ``zx_dft``
    where the kernels take n, else ``zx_mm``."""
    return (zx_dft if fft_kernels_take(pair.shape[-1]) else zx_mm)(pair, sign, out)


def dft_y(pair, sign: int, out=None):
    """The routed DFT along axis -3 of (..., 2, n, Bz, X) pairs: ``y_dft``
    where the kernels take n, else ``y_mm``."""
    return (y_dft if fft_kernels_take(pair.shape[-3]) else y_mm)(pair, sign, out)


def _dft3(pair, sign: int, out, plain: bool):
    y, zx = (y_dft_plain, zx_dft_plain) if plain else (dft_y, dft_zx)
    x = y(pair, sign, out)
    return zx(x, sign, x)


def ifft3_pair(pair, out=None, plain: bool = False):
    """Unnormalized inverse (sign +1) over (y, z, x), the reference
    convention; ``out`` may be pair (in place)."""
    return _dft3(pair, +1, out, plain)


def fft3_pair(pair, out=None, plain: bool = False):
    """Forward (sign -1), unnormalized."""
    return _dft3(pair, -1, out, plain)


def ifft3_half_pair(spm, plain: bool = False, overwrite: bool = False):
    """Unnormalized inverse 3-D transform of a packed half spectrum.

    spm: (narray, 2, 2, ky, Z, X) (array, +/- packing, re/im, ky, z, x)
    with ky = n/2 + 1, from ``halfspace_pack`` + ``fix_ky0_packed``: the DFT
    over (z, x) (sign +1, re/im at -4 with K = ky), then the c2r along y
    with n = 2 (ky - 1); returns (narray, 2, n, Z, X), the layout
    ``ifft3_pair`` gives for the full grid.  Where the kernels take n that
    is zx_dft then c2r_y (B2, which takes the Nyquist row), else zx_mm and
    c2r_y_pair.  ``overwrite=True`` lets the (z, x) pass run in place on
    spm, so the step holds the spectrum and the output and no third grid.
    The port of the JAX package's ``mmfft.ifft3_half_pair``.
    """
    n = 2 * (spm.shape[-3] - 1)
    if plain:
        return c2r_y_plain(zx_dft_plain(spm, +1), n)
    g = dft_zx(spm, +1, spm if overwrite else None)
    return c2r_y(g, n) if fft_kernels_take(n) else c2r_y_pair(g)
