"""A plain torch model of the CUDA kernels' FFT schedule, for the tests.

``stockham(x, sign, layout)`` transforms the last axis of a complex64
tensor exactly as csrc/fft_reg.cuh and csrc/fft_pass.cuh do, thread by
thread: the radix plan of each n (``PLAN``), the Stockham index maps,
the twiddle-table lookups and the padded shared-memory exchanges of the
column ("cols") and row ("rows") layouts.  tests/test_torch_fft.py holds
it against torch.fft and the Pallas kernels (zx, y);
tests/test_torch_c2r.py and tests/test_torch_synth.py feed it B2's
column loader and B1's packed rows.  Nothing in the package calls it.
"""

from pathlib import Path

import numpy as np
import torch

from zeldovich_tpu_torch.ops.synth import twiddles

PLAN = {16: (16,), 32: (8, 4), 64: (8, 8), 128: (16, 8), 256: (16, 16),
        512: (8, 8, 8), 1024: (16, 8, 8), 2048: (16, 16, 8)}
CSRC = Path(__file__).parent.parent / "zeldovich_tpu_torch" / "csrc"


def _shift(layout, n, p):
    """fft_pass.cuh's padding shifts: cols_shift and rows_shift."""
    if layout == "cols":
        return PLAN[n][p].bit_length() - 1
    return 2 if p > 0 else 5 if n >= 512 else PLAN[n][0].bit_length() - 1


def _brev(v, bits):
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def _dft_regs(v, sign):
    """The in-register radix-R DFT: radix-2 decimation in frequency with
    the float32 constants cos(2 pi m / 16), output read in bit-reversed
    order.  v: (..., R) complex64."""
    R = v.shape[-1]
    v = v.clone()
    cos16 = [np.float32(np.cos(2 * np.pi * m / 16)) for m in range(16)]

    def stage(lo, L):
        if L == 1:
            return
        h = L // 2
        for i in range(h):
            a, b = v[..., lo + i].clone(), v[..., lo + i + h].clone()
            v[..., lo + i] = a + b
            d, m = a - b, i * 16 // L
            if m == 4:
                d = torch.complex(-sign * d.imag, sign * d.real)
            elif m:
                w = torch.complex(torch.tensor(cos16[m]),
                                  torch.tensor(sign * cos16[(m + 12) % 16]))
                d = d * w
            v[..., lo + i + h] = d
        stage(lo, h)
        stage(lo + h, h)

    stage(0, R)
    return v[..., [_brev(r, R.bit_length() - 1) for r in range(R)]]


def stockham(x, sign, layout):
    """The kernels' DFT of the last axis of x (complex64), thread by
    thread: T = n / E threads of E elements, pass p of radix R reads
    j + r n/R, multiplies by w^(r (j mod Ns) n/(Ns R)) from the half table,
    writes (j / Ns) Ns R + j mod Ns + r Ns through the padded exchange."""
    n = x.shape[-1]
    plan, lead = PLAN[n], x.shape[:-1]
    E = plan[0]
    T = n // E
    table = twiddles(n, torch.device("cpu"), sign)
    w = torch.complex(table[:, 0], table[:, 1])
    t = torch.arange(T)
    v = x[..., (t[:, None] + torch.arange(E) * T).flatten()]  # pass 0 loads
    ns = 1
    for p, R in enumerate(plan):
        nb = E // R
        v = v.reshape(*lead, T, nb, R)
        j = t[:, None] + torch.arange(nb) * T  # the thread's butterflies
        if ns > 1:
            k = torch.arange(R) * ((j % ns) * (n // (ns * R)))[..., None]
            tw = w[k % (n // 2)]
            v = v * torch.where(k >= n // 2, -tw, tw)
        v = _dft_regs(v, sign)
        if p + 1 == len(plan):  # the stores: j + r n/R
            idx = j[..., None] + torch.arange(R) * (n // R)
            out = torch.empty_like(x)
            out[..., idx.flatten()] = v.reshape(*lead, n)
            return out
        s = _shift(layout, n, p)
        d = (j // ns) * ns * R + j % ns
        a = d[..., None] + torch.arange(R) * ns
        a = (a + (a >> s)).flatten()
        assert len(set(a.tolist())) == n and int(a.max()) < n + (n >> s)
        buf = torch.full((*lead, n + (n >> s)), complex("nan"), dtype=x.dtype)
        buf[..., a] = v.reshape(*lead, n)
        R2 = plan[p + 1]
        j2 = t[:, None] + torch.arange(E // R2) * T
        a2 = j2[..., None] + torch.arange(R2) * (n // R2)
        v = buf[..., (a2 + (a2 >> s)).flatten()]
        assert not torch.isnan(v.real).any()  # read only what was written
        ns *= R
