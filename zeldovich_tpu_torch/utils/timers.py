"""Per-phase wall-clock timing, in the spirit of the reference STimer.

Accumulating stopwatches with a per-phase report printed to stderr
(src/STimer.cc, include/STimer.h).  Each phase is also a
``torch.profiler.record_function`` range of its name: the CLI's
``--profile DIR`` trace (``torch.profiler``, the card's kernels with
``--device cuda``) marks the phases by the names the report prints.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager


class STimer:
    """Accumulating stopwatch (Start/Stop/Elapsed like the reference)."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.elapsed += time.perf_counter() - self._t0
            self._t0 = None
        return self.elapsed

    def increment(self, dt: float):
        self.elapsed += dt

    @contextmanager
    def timing(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()


class PhaseTimers:
    """Named accumulating timers with a final report."""

    def __init__(self):
        self._timers: dict[str, STimer] = {}

    def __getitem__(self, name: str) -> STimer:
        if name not in self._timers:
            self._timers[name] = STimer()
        return self._timers[name]

    @contextmanager
    def phase(self, name: str):
        from torch.profiler import record_function

        with self[name].timing(), record_function(name):
            yield

    def report(self, file=sys.stderr):
        for name, t in self._timers.items():
            print(f"{name} took {t.elapsed:f} seconds", file=file)
