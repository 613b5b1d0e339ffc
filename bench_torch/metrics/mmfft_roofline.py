"""The matrix-product DFTs of the separate half route against the
roofline of the transforms they compute: the least time of the work of
the window's ``mmfft.zx`` and ``mmfft.c2r`` spans (ops/mmfft.py) over the
card's busy time inside those spans' ranges in the trace, %.

The work is that of the DFTs, not of the products that compute them, so
that any implementation of the same transforms reads against the same
bound: 5 n log2 n operations a length-n complex DFT (``kernelwork.fft_ops``),
two of them an element for the (z, x) pass and one for the c2r along y,
and the operand's bytes read once and written once (4 ``elems`` numbers of
the element's size), each span's bound the larger of the two
(``kernelwork.bound_s``), from its counts ``n`` and ``elems``.  Nothing
where the program keeps no such span records or the trace shows the card
busy in none of their ranges."""

from kernelwork import bound_s, fft_ops
from zeldovich_tpu_torch.utils import timers

#: DFTs an element of each span's operand: the (z, x) pass two, the c2r one
PASSES = {"mmfft.zx": 2, "mmfft.c2r": 1}


def span_bound_s(name: str, n: int, elems: int, itemsize: int) -> float:
    """Seconds at the bound of one span's transforms."""
    return bound_s(4 * elems * itemsize, PASSES[name] * fft_ops(elems, n), itemsize)


def read(run):
    if not hasattr(timers, "records"):
        return None
    s = 8 if run.config["dtype"] == "float64" else 4
    least = sum(span_bound_s(r["name"], r["counts"]["n"], r["counts"]["elems"], s)
                for q in run.requests for r in timers.records(q["t0"], q["t1"])
                if r["name"] in PASSES)
    busy = sum(sum(run.busy_in(name)) for name in PASSES)
    if not least or not busy:
        return None
    return 100.0 * least / busy
