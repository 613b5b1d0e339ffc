"""Spans and per-phase wall-clock timing, in the spirit of the reference STimer.

``span(name, timer=None, **counts)`` is the one way the port marks a
piece of its work (src/STimer.cc, include/STimer.h for the timers):

* with no torch profiler running it costs one check; given a ``timer``
  (an ``STimer``) it adds its seconds there, which feeds the phase
  report of ``PhaseTimers`` and the WriteParticlesSlab line;
* while a profiler runs it also opens a ``torch.profiler.record_function``
  range of its name, so the trace (the CLI's ``--profile DIR``) shows it
  on the card's clock, and keeps a record (``records()``): its name, its
  thread's name, ``t0``/``t1`` on ``time.perf_counter``, the index of its
  parent and its counts (keywords such as ``bytes=``; the ``with`` block
  gets the counts dict and may fill it in, as ``output.write`` does).  The parent is the span open on
  the same thread; a worker thread takes the span that ``adopt`` names
  (``utils/streamio.py::AsyncSlabWriter`` passes the span open where the
  writer was made).

The check is torch's own global flag of a running profiler:
``torch._C._autograd._profiler_enabled()`` is per thread, false on a
worker thread and, under ``profile_all_threads``, on every thread.
"""

from __future__ import annotations

import itertools
import math
import sys
import threading
import time
from collections import deque

from torch.autograd import profiler as _profiler

#: records kept, the oldest dropped first (a 512^3 out-of-core job makes
#: ~2,000 spans)
MAX_RECORDS = 1 << 16

_records: deque = deque(maxlen=MAX_RECORDS)
_index = itertools.count()
_local = threading.local()


def tracing() -> bool:
    """Whether a torch profiler is running (on any thread)."""
    return _profiler._is_profiler_enabled


def records(since: float | None = None, until: float | None = None) -> list[dict]:
    """The spans closed while a profiler ran, in the order they closed
    (those that lie inside [since, until] on ``time.perf_counter``, where
    given): dicts of ``index``, ``name``, ``thread``, ``t0``, ``t1``,
    ``parent`` (an ``index``, or None) and ``counts``."""
    lo = -math.inf if since is None else since
    hi = math.inf if until is None else until
    return [r for r in list(_records) if lo <= r["t0"] and r["t1"] <= hi]


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current() -> int | None:
    """The index of the innermost recorded span open on this thread."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def adopt(parent: int | None):
    """Make ``parent`` (``current()`` on another thread) the parent of
    this thread's outermost spans."""
    _local.stack = [] if parent is None else [parent]


class STimer:
    """Accumulating stopwatch (the reference's Elapsed): every span given
    it as its ``timer`` adds its seconds."""

    __slots__ = ("elapsed",)

    def __init__(self):
        self.elapsed = 0.0


class span:
    """A named piece of work; see the module's docstring."""

    __slots__ = ("name", "timer", "counts", "_t0", "_rec", "_range")

    def __init__(self, name: str, timer: STimer | None = None, **counts):
        self.name, self.timer, self.counts = name, timer, counts
        self._rec = None

    def __enter__(self) -> dict:
        if _profiler._is_profiler_enabled:
            stack = _stack()
            self._rec = {"index": next(_index), "name": self.name,
                         "thread": threading.current_thread().name,
                         "parent": stack[-1] if stack else None, "counts": self.counts}
            stack.append(self._rec["index"])
            self._t0 = time.perf_counter()  # the record holds its range
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        elif self.timer is not None:
            self._t0 = time.perf_counter()
        return self.counts

    def __exit__(self, *exc):
        rec = self._rec
        if rec is None and self.timer is None:
            return False
        if rec is not None:
            self._range.__exit__(*exc)
            _local.stack.pop()
        t1 = time.perf_counter()
        if self.timer is not None:
            self.timer.elapsed += t1 - self._t0
        if rec is not None:
            rec["t0"], rec["t1"] = self._t0, t1
            _records.append(rec)
        return False


class PhaseTimers:
    """Named accumulating timers with a final report; each phase a span."""

    def __init__(self):
        self._timers: dict[str, STimer] = {}

    def __getitem__(self, name: str) -> STimer:
        if name not in self._timers:
            self._timers[name] = STimer()
        return self._timers[name]

    def phase(self, name: str) -> span:
        return span(name, timer=self[name])

    def report(self, file=sys.stderr):
        for name, t in self._timers.items():
            print(f"{name} took {t.elapsed:f} seconds", file=file)
