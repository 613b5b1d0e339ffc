"""Power spectrum: file/power-law input, normalization, mode-amplitude tables.

Host-side reimplementation of the reference PowerSpectrum
(src/power_spectrum.cpp) with the same numerics:

* natural cubic spline of ``log P(log k)`` built with the Numerical-Recipes
  recurrence (include/spline_function.h:105-163), evaluated with the same
  cubic formula;
* tophat sigma(R) normalization via Romberg integration with the reference's
  integrand, bounds [0, 10], and relative-convergence test
  (power_spectrum.cpp:50-128), or the analytic power-law solution;
* box-volume normalization for the unnormalized (FFTW-convention) inverse
  FFT, Gaussian smoothing ``exp(-k^2 s^2)`` of the power;
* primordial power ``k^n_s`` and inferred transfer function for f_NL.

Because every mode's |k|^2 is an integer multiple of the fundamental^2, the
device kernels never evaluate the spline: ``mode_amplitude_tables`` bakes
P(k) (and the f_NL M(k) factor) into flat float64 tables indexed by the
integer ``n2 = j^2 + l^2 + m^2`` -- one gather per mode on device.  The
spline runs once over the n2 table (``power_table``); ``M_table`` derives
M from that same P(k) array.  The model's table evaluates only the n2 a
mode can read (``n2_read``): past the k_cutoff sphere the zero rules
zero every mode, so those entries are 0 without a spline evaluation.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np

from .params import Parameters


class SplineFunction:
    """Natural cubic spline (NR-style) with the reference's exact recurrence.

    ``points`` counts the values that went through ``val_vec``."""

    def __init__(self):
        self.x: list[float] = []
        self.y: list[float] = []
        self.y2: list[float] = []
        self.points = 0

    def load(self, xval: float, yval: float):
        self.x.append(xval)
        self.y.append(yval)

    def spline(self):
        # sort by x (reference shell-sorts; ordering result is identical)
        order = sorted(range(len(self.x)), key=lambda i: self.x[i])
        self.x = [self.x[i] for i in order]
        self.y = [self.y[i] for i in order]
        x, y = self.x, self.y
        n = len(x)
        y2 = [0.0] * n
        u = [0.0] * n
        # natural boundary conditions (yp1, ypn > 0.99e30 branch)
        y2[0] = u[0] = 0.0
        for i in range(1, n - 1):
            sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
            p = sig * y2[i - 1] + 2.0
            y2[i] = (sig - 1.0) / p
            ui = (y[i + 1] - y[i]) / (x[i + 1] - x[i]) - (y[i] - y[i - 1]) / (
                x[i] - x[i - 1]
            )
            u[i] = (6.0 * ui / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
        y2[n - 1] = 0.0
        for k in range(n - 2, -1, -1):
            y2[k] = y2[k] * y2[k + 1] + u[k]
        self.y2 = y2

    def val(self, v: float) -> float:
        x, y, y2 = self.x, self.y, self.y2
        klo, khi = 0, len(x) - 1
        while khi - klo > 1:
            k = (khi + klo) >> 1
            if x[k] > v:
                khi = k
            else:
                klo = k
        h = x[khi] - x[klo]
        a = (x[khi] - v) / h
        b = (v - x[klo]) / h
        return (
            a * y[klo]
            + b * y[khi]
            + ((a**3 - a) * y2[klo] + (b**3 - b) * y2[khi]) * (h * h) / 6.0
        )

    def val_vec(self, v: np.ndarray) -> np.ndarray:
        """Vectorized evaluation (numpy), same formula as ``val``."""
        self.points += np.size(v)
        x = np.asarray(self.x)
        y = np.asarray(self.y)
        y2 = np.asarray(self.y2)
        khi = np.clip(np.searchsorted(x, v, side="right"), 1, len(x) - 1)
        # reference binary search picks khi = first knot with x[khi] > v;
        # for v exactly equal to a knot it lands on the right interval too.
        klo = khi - 1
        h = x[khi] - x[klo]
        a = (x[khi] - v) / h
        b = (v - x[klo]) / h
        return (
            a * y[klo]
            + b * y[khi]
            + ((a**3 - a) * y2[klo] + (b**3 - b) * y2[khi]) * (h * h) / 6.0
        )


_MAXITER = 32


def romberg(func, a: float, b: float, prec: float):
    """Romberg integration, reference algorithm (power_spectrum.cpp:94-128).

    Returns (value, obtained_precision).
    """
    h = 0.5 * (b - a)
    T = [[0.0] * (_MAXITER + 2) for _ in range(_MAXITER + 2)]
    T[0][1] = h * (func(a) + func(b))
    jj = 0
    while True:
        jj += 1
        s = 0.0
        for k in range(1, (1 << (jj - 1)) + 1):
            s += func(a + (2 * k - 1) * h)
        T[jj][1] = 0.5 * T[jj - 1][1] + h * s
        fourtokm1 = 1.0
        for k in range(2, jj + 1):
            fourtokm1 *= 4
            T[jj][k] = T[jj][k - 1] + (T[jj][k - 1] - T[jj - 1][k - 1]) / (
                fourtokm1 - 1
            )
        h *= 0.5
        if jj > 1 and abs(T[jj][jj] - T[jj - 1][jj - 1]) < prec * abs(T[jj][jj]):
            break
        if jj >= _MAXITER:
            break
    obtprec = (T[jj][jj] - T[jj - 1][jj - 1]) / T[jj][jj]
    return T[jj][jj], obtprec


class PowerSpectrum:
    """P(k) with normalization and the mode-generation conventions.

    ``sigma_integrals`` counts the Romberg integrals of sigma(R)."""

    def __init__(self, param: Parameters):
        self.param = param
        self.spline = SplineFunction()
        self.is_powerlaw = False
        self.powerlaw_index = 1000.0
        self.normalization = 1.0
        self.Pk_smooth2 = 0.0
        self.kmin = float("inf")
        self.kmax = -float("inf")
        self.fixed_power = False
        self.primordial_norm = 1.0
        self.n_s = param.n_s
        self._warned_extrapolation = False
        self.sigma_integrals = 0

        if param.Pk_filename:
            self.init_from_file(param.resolve_path(param.Pk_filename))
        else:
            self.init_from_powerlaw(param.Pk_powerlaw_index)

    # -- input -------------------------------------------------------------
    def init_from_file(self, filename: Path):
        param = self.param
        print(f'Loading power spectrum from file "{filename}"', file=sys.stderr)
        with open(filename) as fp:
            for line in fp:
                if line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) < 2:
                    continue
                try:
                    k, P = float(parts[0]), float(parts[1])
                except ValueError:
                    continue
                if k < 0.0 or P < 0.0:
                    continue
                k *= param.Pk_scale
                # C's log(0) is -inf (the reference loads such rows,
                # power_spectrum.cpp:158); python math.log(0) raises
                logP = math.log(P) if P > 0.0 else float("-inf")
                if k > 0.0:
                    self.spline.load(math.log(k), logP)
                    self.kmin = min(k, self.kmin)
                else:
                    self.spline.load(-1e3, logP)
                self.kmax = max(k, self.kmax)
        self.spline.spline()
        self.normalize()

    def init_from_powerlaw(self, index: float):
        assert index != 1000
        self.powerlaw_index = index
        self.is_powerlaw = True
        print(
            f"Initializing power spectrum with power law index {index:g}",
            file=sys.stderr,
        )
        self.kmin = 1e-4  # arbitrary; used by f_NL
        self.normalize()

    # -- normalization -----------------------------------------------------
    def sigmaR_integrand(self, k: float) -> float:
        x = k * self._Rnorm
        if x <= 1e-3:
            w = 1 - x * x / 10.0
        else:
            w = 3.0 * (math.sin(x) - x * math.cos(x)) / x / x / x
        return 0.5 / math.pi / math.pi * k * k * w * w * self.power(k)

    def sigmaR(self, R: float) -> float:
        if not self.is_powerlaw:
            target_prec = 1e-6
            self._Rnorm = R
            self.sigma_integrals += 1
            val, obtained = romberg(self.sigmaR_integrand, 0.0, 10.0, target_prec)
            if obtained > target_prec:
                raise RuntimeError(
                    f"Romberg precision {obtained:g} worse than target "
                    f"{target_prec:g}"
                )
            return math.sqrt(val)
        n = self.powerlaw_index
        retval = (
            9
            * R ** (-n - 3)
            / (2 * math.pi * math.sqrt(math.pi))
            * math.gamma((3 + n) / 2.0)
            / (math.gamma((2 - n) / 2.0) * (n - 3) * (n - 1))
        )
        return math.sqrt(retval * self.normalization)

    def normalize(self):
        param = self.param
        self.Pk_smooth2 = 0.0
        self.normalization = 1.0

        if param.Pk_norm > 0.0:
            sigma_in = self.sigmaR(param.Pk_norm)
            print(f"Input sigma({param.Pk_norm:f}) = {sigma_in:.6g}", file=sys.stderr)
            if param.Pk_sigma > 0:
                self.normalization = (param.Pk_sigma / sigma_in) ** 2
            elif param.Pk_sigma_ratio > 0:
                self.normalization = param.Pk_sigma_ratio**2
            else:  # pragma: no cover - excluded by Parameters validation
                raise AssertionError("need Pk_sigma or Pk_sigma_ratio")
            print(
                f"Final sigma({param.Pk_norm:f}) = {self.sigmaR(param.Pk_norm):.6g}",
                file=sys.stderr,
            )
        # Box-volume normalization for the FFTW-convention (unnormalized)
        # inverse FFT (power_spectrum.cpp:211-215)
        self.normalization /= param.boxsize**3
        self.Pk_smooth2 = param.Pk_smooth**2

        self.fixed_power = bool(param.qPk_fix_to_mean)
        if self.fixed_power:
            print("Fixing density mode amplitudes to sqrt(P(k))", file=sys.stderr)

        self.primordial_norm = 1.0
        self.primordial_norm = self.power(self.kmin) / self.primordial_power(
            self.kmin
        )

    # -- evaluation --------------------------------------------------------
    def power(self, wavenumber: float) -> float:
        if wavenumber <= 0.0:
            return 0.0
        if self.is_powerlaw:
            return (
                wavenumber**self.powerlaw_index
                * math.exp(-wavenumber * wavenumber * self.Pk_smooth2)
                * self.normalization
            )
        if wavenumber > self.kmax and not self._warned_extrapolation:
            print(
                f"*** WARNING: P(k) spline extrapolation past kmax={self.kmax:f}",
                file=sys.stderr,
            )
            self._warned_extrapolation = True
        return (
            math.exp(
                self.spline.val(math.log(wavenumber))
                - wavenumber * wavenumber * self.Pk_smooth2
            )
            * self.normalization
        )

    def power_vec(self, wavenumber: np.ndarray) -> np.ndarray:
        """Vectorized ``power`` (numpy float64), for table building."""
        wavenumber = np.asarray(wavenumber, dtype=np.float64)
        out = np.zeros_like(wavenumber)
        pos = wavenumber > 0.0
        kpos = wavenumber[pos]
        if self.is_powerlaw:
            vals = (
                kpos**self.powerlaw_index
                * np.exp(-kpos * kpos * self.Pk_smooth2)
                * self.normalization
            )
        else:
            vals = (
                np.exp(self.spline.val_vec(np.log(kpos)) - kpos * kpos * self.Pk_smooth2)
                * self.normalization
            )
        out[pos] = vals
        return out

    def primordial_power(self, wavenumber) -> float:
        if np.isscalar(wavenumber):
            if wavenumber <= 0.0:
                return 0.0
            return self.primordial_norm * math.exp(
                math.log(wavenumber) * self.n_s
            )
        w = np.asarray(wavenumber, dtype=np.float64)
        out = np.zeros_like(w)
        pos = w > 0
        out[pos] = self.primordial_norm * np.exp(np.log(w[pos]) * self.n_s)
        return out


def _n2_kmag(param: Parameters):
    """The integer n2 = 0 .. 3*(ppd/2)^2 and |k| = sqrt(n2) * fundamental."""
    half = param.ppd // 2
    n2 = np.arange(3 * half * half + 1, dtype=np.float64)
    return n2, np.sqrt(n2) * param.fundamental


def n2_cutoff(param: Parameters) -> int:
    """The k_cutoff sphere in integer n2: the smallest n2 with
    ``n2 * fundamental^2 >= (nyquist / k_cutoff)^2`` in float64, so that
    the zero rules' cutoff decision is exact in every compute dtype."""
    k2_cutoff = param.nyquist * param.nyquist / (param.k_cutoff * param.k_cutoff)
    fund2 = np.float64(param.fundamental) * np.float64(param.fundamental)
    n2 = int(np.ceil(k2_cutoff / float(fund2)))
    while n2 > 0 and np.float64(n2 - 1) * fund2 >= k2_cutoff:
        n2 -= 1
    while np.float64(n2) * fund2 < k2_cutoff:
        n2 += 1
    return n2


def n2_read(param: Parameters) -> int:
    """How many n2, from 0, a mode's amplitude can read.

    Every n2 (3*(ppd/2)^2 + 1) under CornerModes, where the sphere rule is
    off, and under f_NL, whose M(k) and full-grid phi pass read past the
    sphere; else ``n2_cutoff`` (about (ppd/2)^2 / k_cutoff^2, k_cutoff >=
    1): the zero rules zero every mode with ``n2 >= n2_cutoff``
    (zeldovich.cpp:349-358).
    """
    if param.CornerModes or param.f_NL != 0:
        return 3 * (param.ppd // 2) ** 2 + 1
    return n2_cutoff(param)


def power_table(Pk: PowerSpectrum, param: Parameters,
                n2_end: int | None = None) -> np.ndarray:
    """P(k) by integer n2: one spline pass over the table.

    Every grid mode has ``|k|^2 = n2 * fundamental^2`` with integer
    ``n2 <= 3*(ppd/2)^2``, so device kernels do one table gather instead of
    a spline search per mode.  A float64 array of length 3*(ppd/2)^2 + 1.
    With ``n2_end`` (``n2_read``) the pass covers n2 < n2_end alone, each
    value the whole pass's to the bit, and the entries from n2_end on are 0.
    """
    kmag = _n2_kmag(param)[1]
    out = np.zeros_like(kmag)
    out[:n2_end] = Pk.power_vec(kmag[:n2_end])
    return out


def M_table(Pk: PowerSpectrum, param: Parameters, pk: np.ndarray) -> np.ndarray:
    """The f_NL M(k,a) factor by integer n2, from ``pk = power_table(Pk,
    param)``: the Bardeen-potential conversion of 1108.5512 eq. 50
    (zeldovich.cpp:377-383).  T(k) = sqrt(P(k) / primordial P(k)), 1 at
    k = 0 (inferred assuming T = 1 on large scales), is taken from the given
    P(k), so the spline is not run again.
    """
    n2, kmag = _n2_kmag(param)
    Tk = np.ones_like(kmag)
    pos = kmag > 0
    Tk[pos] = np.sqrt(pk[pos] / Pk.primordial_power(kmag[pos]))

    H0 = 100.0  # km/s/(Mpc/h)
    c = 299792.458  # km/s
    growth = 1.0 / (1 + param.z_initial)  # EdS, normalized to D=a at high z
    k2 = n2 * param.fundamental**2
    return 2.0 * growth * c * c * Tk * k2 / (3.0 * param.Omega_M * H0 * H0)


def mode_amplitude_tables(Pk: PowerSpectrum, param: Parameters):
    """(Pk_by_n2, M_by_n2): ``power_table`` and the ``M_table`` built from
    it, float64 arrays of length 3*(ppd/2)^2 + 1.  M is read only when
    f_NL != 0; ``models/pipeline.py`` builds it only then."""
    pk = power_table(Pk, param)
    return pk, M_table(Pk, param, pk)
