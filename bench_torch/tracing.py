"""The traced run: one torch.profiler (CPU + CUDA) around the window, read
back from its Chrome trace, and what the per-layer metric readers see.

The profiler's first start in a process costs seconds (torch imports
``torch._inductor`` on it), so ``warm_profiler`` starts and stops an
empty one during set-up.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import time
from pathlib import Path

#: trace categories of the card's own activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: a host range of the harness or the program (record_function)
HOST_RANGE_CATS = ("user_annotation",)


def warm_profiler(device: str):
    """Start and stop one empty profiler: its first start's cost goes to
    set-up, not to the window."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts):
        pass


@contextlib.contextmanager
def profiled(device: str):
    """The body inside one profiler, which it yields; the caller writes
    its Chrome trace (``export_chrome_trace``) when it has the time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    if device == "cuda":
        time.sleep(0.1)  # CUPTI misses a kernel that follows its start at once
    try:
        yield prof
    finally:
        prof.stop()


def kernel_names(package_dir: Path) -> set[str]:
    """The names of the program's hand-written kernels (``__global__``
    functions of its CUDA sources)."""
    names = set()
    for src in sorted((package_dir / "csrc").glob("*.cu*")):
        text = src.read_text()
        for m in re.finditer(r"__global__\s+void\s+", text):
            rest = text[m.end():]
            if rest.startswith("__launch_bounds__"):
                depth, i = 0, len("__launch_bounds__")
                for i in range(i, len(rest)):
                    depth += rest[i] == "("
                    depth -= rest[i] == ")"
                    if depth == 0 and rest[i] == ")":
                        break
                rest = rest[i + 1:]
            name = re.match(r"\s*(\w+)", rest)
            if name:
                names.add(name.group(1))
    return names


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Run:
    """What a per-layer metric reader gets: the cell, the window's
    requests and harness spans, the launch counters, and with a trace
    its events (times in seconds from the window's start)."""

    def __init__(self, cell, config, traffic, requests, launches, model,
                 trace_path, port_kernels):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.requests, self.launches, self.model = requests, launches, model
        self.port_kernels = set(port_kernels)
        self.events, self.window = [], None
        self._load(trace_path)

    def _load(self, path):
        data = json.loads(Path(path).read_text())
        evs = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
        win = [e for e in evs if e.get("name") == "bench.window"
               and e.get("cat") in HOST_RANGE_CATS]
        if not win:
            raise RuntimeError("the trace holds no bench.window range")
        w0 = float(win[0]["ts"])
        self.window = (0.0, float(win[0]["dur"]) * 1e-6)
        for e in evs:
            t0 = (float(e["ts"]) - w0) * 1e-6
            t1 = t0 + float(e.get("dur", 0)) * 1e-6
            if t1 < 0 or t0 > self.window[1]:
                continue
            self.events.append({"name": e.get("name", ""), "cat": e.get("cat", ""),
                                "t0": max(t0, 0.0), "t1": min(t1, self.window[1]),
                                "args": e.get("args", {})})

    # -- what readers ask ------------------------------------------------
    def device_events(self):
        return [e for e in self.events if e["cat"] in DEVICE_CATS]

    def busy_s(self) -> float:
        return _union((e["t0"], e["t1"]) for e in self.device_events())

    def ranges(self, name: str):
        return [e for e in self.events if e["cat"] in HOST_RANGE_CATS and e["name"] == name]

    def busy_in(self, name: str) -> list[float]:
        """The card's busy seconds inside each host range ``name``."""
        dev = self.device_events()
        return [_union((max(e["t0"], h["t0"]), min(e["t1"], h["t1"])) for e in dev
                       if e["t1"] > h["t0"] and e["t0"] < h["t1"])
                for h in self.ranges(name)]

    def port_kernel_s(self) -> float:
        return sum(e["t1"] - e["t0"] for e in self.events if e["cat"] == "kernel"
                   and _base_name(e["name"]) in self.port_kernels)

    def span_median_ms(self, name: str):
        vals = [r["spans"][name] for r in self.requests if name in r.get("spans", {})]
        return 1e3 * statistics.median(vals) if vals else None

    def request_wall_s(self) -> float:
        return sum(r["t1"] - r["t0"] for r in self.requests)

    def breakdown(self, top: int = 10) -> dict:
        """The card's top operations by time, and the longest idle gaps
        labelled with the innermost host range open at their middle."""
        by = {}
        for e in self.device_events():
            by[e["name"]] = by.get(e["name"], 0.0) + e["t1"] - e["t0"]
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        ops = [(k if len(k) <= 160 else k[:157] + "...", v) for k, v in ops]
        busy = sorted((e["t0"], e["t1"]) for e in self.device_events())
        gaps, end = [], 0.0
        for a, b in busy:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.window and self.window[1] > end:
            gaps.append((end, self.window[1]))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        hosts = [e for e in self.events if e["cat"] in HOST_RANGE_CATS]
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            open_ = [h for h in hosts if h["t0"] <= mid <= h["t1"]]
            label = min(open_, key=lambda h: h["t1"] - h["t0"])["name"] if open_ else "none"
            out.append([label, b - a])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": out}


def _base_name(name: str) -> str:
    """A kernel event's function name: 'void f<...>(...)' -> 'f'."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip().split("::")[-1]
