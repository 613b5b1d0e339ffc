"""The program's hand-written kernels on the in-core full-grid route
against their roofline: the least time of their work, reckoned here from
the configuration's shapes with ``kernelwork``'s peaks and counts, over
their device time in the trace, %.

A realization of that route (f_NL: models/pipeline.py ``phi_pass``, then
``xspace_pair``) launches B4 once (the draw of phi over the half space:
the pcg64 tables and P(k) read, D's two parts written), the PLT planes
once where PLT is on (``kernelwork.per_launch``'s reckoning), and three
3-D transforms, each one ``y_dft`` and one ``zx_dft`` launch that read
and write their grid: phi's inverse and forward over one array, the
output's inverse over all of them.  Nothing where a counter outside those
moved or the counts are not those of whole realizations: the route is
then another one, and this model does not hold."""

from pathlib import Path

from kernelwork import _tables, bound_s, fft_ops

ROOT = Path(__file__).resolve().parents[2]
ROUTE = {"halfspace_boxmuller", "zx_dft", "y_dft", "plt_coefs"}


def realization_s(config) -> float:
    """Seconds at the bound of one realization's launches."""
    par = config["par"]
    n = round(int(par["NP"]) ** (1 / 3))
    half, s = n // 2, (8 if config["dtype"] == "float64" else 4)
    plt = bool(int(par.get("ZD_qPLT", 0)))
    modes = half * n * n
    # B4: P(k) read, the tables, D's real and imaginary parts written
    total = bound_s(modes * s + _tables(n, half) + 2 * modes * s, 0.0, s, draws=modes)
    for arrays in (1, 1, 4 if plt else 2):
        grid = arrays * n ** 3  # complex elements
        total += bound_s(2 * 2 * grid * s, fft_ops(grid, n), s)  # y pass
        total += bound_s(2 * 2 * grid * s, 2 * fft_ops(grid, n), s)  # zx pass
    if plt:
        table = (ROOT / par["ZD_PLT_filename"]).stat().st_size - 4
        total += bound_s(4 * modes * s + table, 0.0, s)
    return total


def read(run):
    got = {k: v for k, v in run.launches.items() if v}
    real = got.get("halfspace_boxmuller", 0)
    plt = bool(int(run.config["par"].get("ZD_qPLT", 0)))
    want = {"halfspace_boxmuller": real, "zx_dft": 3 * real, "y_dft": 3 * real}
    if plt:
        want["plt_coefs"] = real
    spent = run.port_kernel_s()
    if not real or set(got) - ROUTE or got != want or not spent:
        return None
    return 100.0 * real * realization_s(run.config) / spent
