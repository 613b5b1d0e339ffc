"""The program's hand-written kernels against their roofline: the least
time of the work their launches did (kernelwork.py, from the cell's
shapes and the launch counters) over their device time in the trace, %.
cuFFT, cuBLAS and torch's own kernels are not in it."""

from kernelwork import window_bound_s


def read(run):
    bound = window_bound_s(run.launches, run.model)
    spent = run.port_kernel_s()
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
