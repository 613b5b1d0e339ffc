"""A plain torch model of the CUDA kernels' FFT schedule, for the tests.

``stockham(x, sign, layout)`` transforms the last axis of a complex64 or
complex128 tensor (the float and the double instances) exactly as
csrc/fft_reg.cuh and csrc/fft_pass.cuh do, thread by thread: the radix
plan of each n (``PLAN``), the Stockham index maps, the twiddle-table lookups and the padded shared-memory exchanges of the
column ("cols") and row ("rows") layouts.  tests/test_torch_fft.py holds
it against torch.fft and the Pallas kernels (zx, y);
tests/test_torch_c2r.py and tests/test_torch_synth.py feed it B2's
column loader and B1's packed rows.  ``Tiles(n, itemsize)`` repeats the
headers' tile arithmetic (columns of a tile, threads, blocks a SM, shared
memory, the registers a thread may take) for either element type, and
``exchange_wavefronts`` counts the shared-memory wavefronts of the padded
exchanges.  Nothing in the package calls it.
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
    the constants cos(2 pi m / 16) rounded to the element type, output read
    in bit-reversed order.  v: (..., R) complex64 or complex128."""
    R = v.shape[-1]
    v = v.clone()
    real = np.float32 if v.dtype == torch.complex64 else np.float64
    cos16 = [real(np.cos(2 * np.pi * m / 16)) for m in range(16)]

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
                                  torch.tensor(real(sign) * cos16[(m + 12) % 16]))
                d = d * w
            v[..., lo + i + h] = d
        stage(lo, h)
        stage(lo + h, h)

    stage(0, R)
    return v[..., [_brev(r, R.bit_length() - 1) for r in range(R)]]


def stockham(x, sign, layout):
    """The kernels' DFT of the last axis of x (complex64: the float
    instances, complex128: the double ones), thread by
    thread: T = n / E threads of E elements, pass p of radix R reads
    j + r n/R, multiplies by w^(r (j mod Ns) n/(Ns R)) from the half table,
    writes (j / Ns) Ns R + j mod Ns + r Ns through the padded exchange."""
    n = x.shape[-1]
    plan, lead = PLAN[n], x.shape[:-1]
    E = plan[0]
    T = n // E
    table = twiddles(n, torch.device("cpu"), sign,
                     torch.float32 if x.dtype == torch.complex64 else torch.float64)
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


def _extent(layout, n):
    """fft_pass.cuh's extent<COLS>: the largest padded extent over a
    kernel's exchanges (0: no exchange)."""
    return max((n + (n >> _shift(layout, n, p)) for p in range(len(PLAN[n]) - 1)),
               default=0)


class Tiles:
    """The tile arithmetic of fft_pass.cuh, fft_axis.cu and synth.cu for
    length n and an element of `itemsize` bytes (4: float, 8: double)."""

    REGISTERS, SMEM = 65536, 227 * 1024  # of one SM

    def __init__(self, n, itemsize):
        self.n, self.itemsize = n, itemsize
        self.E = PLAN[n][0]
        self.T = n // self.E
        double = itemsize == 8
        # block_threads: 512 where a thread's 16 double elements are 64
        # registers of data, else 1024
        self.block_threads = 512 if double and self.E == 16 else 1024
        # cols_c, cols_tx, cols_threads, cols_min_blocks
        self.cols_c = 2 if not double and n >= 64 and self.E == 8 else 1
        lo, hi = 32 // itemsize, 128 // itemsize
        tx = min(max(self.block_threads * self.cols_c // self.T, lo), hi)
        while tx > lo and 2 * _extent("cols", n) * tx * itemsize > self.SMEM:
            tx //= 2
        self.cols_tx = tx
        self.cols_threads = tx // self.cols_c * self.T
        self.cols_min_blocks = (self._min_blocks(self.cols_threads)
                                if self.cols_c == 1 else 1)
        self.cols_smem = 2 * _extent("cols", n) * tx * itemsize
        # rows_per_block, launch_rows
        self.rows = min(4096 // n, n)
        self.rows_threads = self.rows * self.T
        self.rows_min_blocks = self._min_blocks(self.rows_threads)
        self.rows_smem = 2 * _extent("rows", n) * self.rows * itemsize
        # b1_threads, b1_min_blocks, b1_rows, pack_rows_smem
        if double:
            self.b1_threads, self.b1_min_blocks = (128 if self.E == 16 else 256), 2
        else:
            self.b1_threads = 128 if n == 2048 else 256
            self.b1_min_blocks = 3 if n == 2048 or self.E == 8 else 2
        self.b1_rows = min(self.b1_threads // self.T, n)
        self.b1_smem = (2 * _extent("rows", n) * self.b1_rows
                        + 3 * self.b1_rows * n) * itemsize

    def _min_blocks(self, threads):
        """min_blocks<F>: a double block below a warp counts as a warp."""
        return self.block_threads // (32 if self.itemsize == 8 and threads < 32
                                      else threads)

    def registers(self, threads, min_blocks):
        """Registers a thread may take under __launch_bounds__(threads,
        min_blocks): the file over the warps' lanes, at most 255."""
        lanes = -(-threads // 32) * 32
        return min(255, self.REGISTERS // (lanes * min(min_blocks, 32)))

    def data_registers(self, c=1):
        """32-bit registers that hold a thread's c sequences of E complex
        elements."""
        return c * self.E * 2 * self.itemsize // 4


def _wavefronts(addrs, width):
    """Shared-memory wavefronts of one warp instruction whose threads access
    `width` bytes (4, 8 or 16) at the byte addresses addrs: 32 banks of 4
    bytes; 128 bytes' worth of threads are served together (a warp of
    4-byte accesses, a half-warp of 8-byte ones), each group in as many
    wavefronts as the most distinct words that fall on one bank."""
    per, total = 128 // width, 0
    for g in range(0, len(addrs), per):
        banks = {}
        for a in addrs[g:g + per]:
            for word in range(a // 4, (a + width) // 4):
                banks.setdefault(word % 32, set()).add(word)
        total += max(len(words) for words in banks.values())
    return total


def exchange_wavefronts(n, itemsize, layout):
    """The worst ratio, over every warp and every store and load of the
    padded exchanges of length n (reg::exchange with smem_at's padding),
    of the wavefronts an instruction takes to the least it could take:
    1.0 is free of bank conflicts.  layout "cols": the column kernel's
    block (cols_tx columns, cols_c a thread); "rows": the row kernel's
    (rows_per_block rows, one after another in shared memory)."""
    tiles = Tiles(n, itemsize)
    plan, E, T = PLAN[n], tiles.E, tiles.T
    if layout == "cols":
        C, per_row, threads, stride = (tiles.cols_c, tiles.cols_tx // tiles.cols_c,
                                       tiles.cols_threads, tiles.cols_tx)
        place = lambda tid: (tid % per_row * C, tid // per_row)  # (lane, t)
    else:
        C, threads, stride, row = 1, tiles.rows_threads, 1, _extent("rows", n)
        place = lambda tid: (tid // T * row, tid % T)
    width, worst, ns = C * itemsize, 1.0, 1
    for p, R in enumerate(plan[:-1]):
        s, R2 = _shift(layout, n, p), plan[p + 1]
        index = [lambda t, b=b, r=r, ns=ns, R=R: ((t + b * T) // ns) * ns * R
                 + (t + b * T) % ns + r * ns
                 for b in range(E // R) for r in range(R)]             # the stores
        index += [lambda t, b=b, r=r, R2=R2: t + b * T + r * (n // R2)
                  for b in range(E // R2) for r in range(R2)]          # the loads
        for w0 in range(0, threads, 32):
            where = [place(tid) for tid in range(w0, min(w0 + 32, threads))]
            for f in index:
                addrs = [(lane + (f(t) + (f(t) >> s)) * stride) * itemsize
                         for lane, t in where]
                least = max(1, len(addrs) * width // 128)
                worst = max(worst, _wavefronts(addrs, width) / least)
        ns *= R
    return worst
