"""The matrix-product DFTs and the size routing of ``ops/mmfft.py``, and
the size rule of the draw and pack kernels, against the JAX package.

The port's ``cfft_axis`` (dense and four-step) and ``c2r_y_pair`` (dense
and assembled) are held against the JAX package's ``mmfft.cfft_axis`` and
``mmfft.c2r_y_pair`` on the same inputs, made from a seed with numpy, and
against ``torch.fft`` in complex128: float64 within 1e-12 of the largest
value, float32 within 1e-5 of it (of JAX's float64 result).  The lengths
are the JAX package's own test sizes and multiples of 3 and 5 (12, 24, 40,
48, 96), each in both forms, and 1152 and 1728 on thin batches (the
four-step split and the assembled c2r, as the JAX package runs them above
its DENSE_MAX).  The routing: ``fft_kernels_take`` at both sides of the
kernels' range, the kernel wrappers raising at 576 while the routed
transforms, on ``meta`` tensors, run without them.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeldovich_tpu.ops import mmfft as jmm
from zeldovich_tpu_torch.ops import mmfft
from zeldovich_tpu_torch.ops.boxmuller import boxmuller, halfspace_boxmuller
from zeldovich_tpu_torch.ops.c2r import c2r_y, c2r_y_plain
from zeldovich_tpu_torch.ops.fft import y_dft, y_dft_plain, zx_dft, zx_dft_plain
from zeldovich_tpu_torch.ops.synth import (
    DRAW_PPD_MAX, check_draw_size, check_kernel_size, fft_kernels_take,
    halfspace_pack_zx,
)

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "float64": 1e-12}
SMALL_N = (12, 24, 40, 48, 96)


def _close(got, want, dtype):
    got = np.asarray(got, np.float64)
    scale = np.abs(want).max()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


def _jax_dft(a, axis, sign):
    re, im = jmm.cfft_axis(jnp.asarray(a[0]), jnp.asarray(a[1]), axis, sign)
    return np.stack([np.asarray(re), np.asarray(im)])


def _fft128(a, axis, sign):
    c = torch.complex(torch.from_numpy(a[0]), torch.from_numpy(a[1]))
    c = (torch.fft.ifft(c, dim=axis, norm="forward") if sign > 0
         else torch.fft.fft(c, dim=axis))
    return np.stack([c.real.numpy(), c.imag.numpy()])


def _port(form, a, axis, sign, dtype):
    re, im = (torch.from_numpy(a[i]).to(getattr(torch, dtype)) for i in (0, 1))
    if form == "routed":
        r, i = mmfft.cfft_axis(re, im, axis, sign)
    else:  # one form along the axis, through the (P, n, Q) view
        shape = re.shape
        ax = axis % re.dim()
        P, n = int(np.prod(shape[:ax])), shape[ax]
        f = mmfft._dense if form == "dense" else mmfft._four_step
        r, i = f(re.reshape(P, n, -1), im.reshape(P, n, -1), sign)
        r, i = r.reshape(shape), i.reshape(shape)
    return np.stack([r.numpy(), i.numpy()])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", SMALL_N)
def test_cfft_axis_matches_jax_and_torch_fft(n, dtype):
    """Dense, four-step and the routed cfft_axis, along every axis of a
    (3, n, 5) batch (the last axis: cfft_last), both signs."""
    rng = np.random.default_rng(n)
    for axis, shape in ((-1, (3, 5, n)), (-2, (3, n, 5)), (-3, (n, 3, 5))):
        a = rng.standard_normal((2, *shape))
        for sign in (1, -1):
            want = _jax_dft(a, axis, sign)
            _close(_fft128(a, axis, sign), want, "float64")
            for form in ("dense", "four_step", "routed"):
                _close(_port(form, a, axis, sign, dtype), want, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [1152, 1728])
def test_four_step_at_the_long_lengths(n, dtype):
    """The four-step split on a thin batch (3 skewers), both signs, against
    the JAX package's four-step (its DENSE_MAX is 1024) and torch.fft."""
    a = np.random.default_rng(n).standard_normal((2, 3, n))
    assert mmfft._factor(n) == jmm._factor(n)
    for sign in (1, -1):
        want = _jax_dft(a, -1, sign)
        _close(_fft128(a, -1, sign), want, "float64")
        _close(_port("four_step", a, -1, sign, dtype), want, dtype)
        _close(_port("routed", a, -1, sign, dtype), want, dtype)


def _hermitian_spm(n, Z, X, rng, narray=2):
    """A packed (narray, 2, 2, n/2 + 1, Z, X) spectrum of two real fields D,
    F (their y spectra; z, x in configuration space), and n (D, F)."""
    D, F = rng.standard_normal((2, narray, n, Z, X))
    Dk, Fk = (np.fft.fft(f, axis=1)[:, : n // 2 + 1] for f in (D, F))
    sp, sm = Dk + 1j * Fk, Dk - 1j * Fk
    spm = np.stack([np.stack([s.real, s.imag], 1) for s in (sp, sm)], 1)
    return spm, n * np.stack([D, F], 1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [*SMALL_N, 1152, 1728])
def test_c2r_y_pair_matches_jax(n, dtype, monkeypatch):
    """Both forms of the c2r at every n (the dense [C | S] product and the
    assembled spectrum with one DFT, by DENSE_MAX), on (2, 2, 2, h+1, Z, X)
    and a z-sliced block, against JAX c2r_y_pair and complex128 irfft."""
    rng = np.random.default_rng(n + 1)
    Z, X = (3, 5) if n < 1000 else (1, 2)
    spm, fields = _hermitian_spm(n, Z, X, rng)
    want = np.asarray(jmm.c2r_y_pair(jnp.asarray(spm)))
    _close(want, fields, "float64")
    _close(c2r_y_plain(torch.from_numpy(spm), n).numpy(), want, "float64")
    t = torch.from_numpy(spm).to(getattr(torch, dtype))
    for dense_max in (n, n - 1):
        monkeypatch.setitem(mmfft.DENSE_MAX, t.dtype, dense_max)
        _close(mmfft.c2r_y_pair(t).numpy(), want, dtype)
        out = torch.full((2, 2, n, Z, X), np.nan, dtype=t.dtype)
        assert mmfft.c2r_y_pair(t, out) is out
        _close(out.numpy(), want, dtype)
        _close(mmfft.c2r_y_pair(t[..., :1, :]).numpy(), want[..., :1, :], dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pair_passes_in_place_and_in_chunks(dtype, monkeypatch):
    """zx_mm and y_mm on (..., 2, A, B, C) pairs, out of place and in place,
    with chunks of a few planes or rows (a ragged last chunk), against
    torch.fft; ifft3_pair / fft3_pair on the matrix products round-trip."""
    monkeypatch.setattr(mmfft, "_CHUNK", 24 * 24 * 5)
    rng = np.random.default_rng(7)
    pair = torch.from_numpy(rng.standard_normal((2, 2, 24, 24, 24))).to(getattr(torch, dtype))
    p64 = pair.double()
    for sign in (1, -1):
        _close(mmfft.zx_mm(pair, sign).numpy(), zx_dft_plain(p64, sign).numpy(), dtype)
        _close(mmfft.y_mm(pair, sign).numpy(), y_dft_plain(p64, sign).numpy(), dtype)
        for f, plain in ((mmfft.zx_mm, zx_dft_plain), (mmfft.y_mm, y_dft_plain)):
            x = pair.clone()
            assert f(x, sign, out=x) is x
            _close(x.numpy(), plain(p64, sign).numpy(), dtype)
    x = mmfft.fft3_pair(mmfft.ifft3_pair(pair.clone(), out=None), out=None) / 24**3
    _close(x.numpy(), p64.numpy(), dtype)


@pytest.mark.parametrize("n,takes", [(8, False), (16, True), (24, False), (512, True),
                                     (576, False), (1024, True), (1152, False),
                                     (2048, True), (4096, False)])
def test_fft_kernels_take(n, takes):
    assert fft_kernels_take(n) is takes
    if takes:
        check_kernel_size(n)
    else:
        with pytest.raises(ValueError, match="power-of-two"):
            check_kernel_size(n)


def test_kernel_wrappers_raise_at_576_and_the_route_does_not_call_them(monkeypatch):
    """On meta tensors (shapes, no data) at ppd 576: zx_dft, y_dft and
    c2r_y refuse the length, halfspace_pack_zx has no kernel there; the
    routed ifft3_half_pair and ifft3_pair take the matrix products and
    never call a kernel wrapper."""
    n, h = 576, 288
    spm = torch.empty((2, 2, 2, h + 1, n, n), device="meta")
    pair = torch.empty((2, 2, n, n, n), device="meta")
    with pytest.raises(ValueError, match="power-of-two"):
        zx_dft(spm[:, :, :, :h], +1)
    with pytest.raises(ValueError, match="power-of-two"):
        y_dft(pair, +1)
    with pytest.raises(ValueError, match="power-of-two"):
        c2r_y(spm, n)
    with pytest.raises(ValueError):
        halfspace_pack_zx(SimpleNamespace(ppd=n), None, torch.empty((h, n, n), device="meta"))

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called at ppd 576")

    for name in ("zx_dft", "y_dft", "c2r_y"):
        monkeypatch.setattr(mmfft, name, refuse)
    x = mmfft.ifft3_half_pair(spm)
    assert x.shape == (2, 2, n, n, n) and x.device.type == "meta"
    assert mmfft.ifft3_half_pair(spm, overwrite=True).shape == (2, 2, n, n, n)
    assert mmfft.ifft3_pair(pair, out=pair) is pair
    assert mmfft.fft3_pair(pair).shape == pair.shape


def test_the_route_keeps_the_kernels_at_a_power_of_two(monkeypatch):
    """At ppd 16 the routed transforms call zx_dft, y_dft and c2r_y (here
    their plain versions, the tensors being on the CPU) and never a matrix
    product."""
    calls = []

    def spy(f):
        def g(*a, **k):
            calls.append(f.__name__)
            return f(*a, **k)
        return g

    def refuse(*a, **k):
        raise AssertionError("a matrix product at ppd 16")

    for name in ("zx_dft", "y_dft", "c2r_y"):
        monkeypatch.setattr(mmfft, name, spy(getattr(mmfft, name)))
    for name in ("zx_mm", "y_mm", "c2r_y_pair"):
        monkeypatch.setattr(mmfft, name, refuse)
    spm = torch.zeros((2, 2, 2, 9, 16, 16))
    assert mmfft.ifft3_half_pair(spm).shape == (2, 2, 16, 16, 16)
    mmfft.ifft3_pair(torch.zeros((2, 2, 16, 16, 16)))
    assert calls == ["zx_dft", "c2r_y", "y_dft", "zx_dft"]


@pytest.mark.parametrize("n,ok", [(0, False), (1, False), (2, True), (3, False),
                                  (12, True), (14, True), (15, False), (16, True),
                                  (18, True), (576, True), (1728, True), (4096, True),
                                  (6912, True), (DRAW_PPD_MAX - 1, False),
                                  (DRAW_PPD_MAX, True), (DRAW_PPD_MAX + 2, False)])
def test_draw_and_pack_kernels_size_rule(n, ok):
    """B3, B4 and B5 take every even ppd in [2, DRAW_PPD_MAX]: the rule
    alone, and B4 and B5 on meta tensors (a size they take reaches the
    device check, one they do not raises first)."""
    pk = torch.empty((n // 2, n, n), device="meta")
    tables = SimpleNamespace(mzx64=torch.empty((2, n, n), device="meta"),
                             planes64=torch.empty((n // 2, 2), device="meta"))
    idx = torch.empty((4,), dtype=torch.int32, device="meta")
    small = torch.empty((4,), device="meta")
    calls = (lambda: halfspace_boxmuller(tables, pk, False),
             lambda: boxmuller(tables, idx, idx, idx, small, small, False))
    if ok:
        check_draw_size(n)
        for call in calls:
            with pytest.raises(ValueError, match="no kernel"):
                call()
    else:
        with pytest.raises(ValueError, match="draw and pack"):
            check_draw_size(n)
        for call in calls:
            with pytest.raises(ValueError, match="draw and pack"):
                call()
