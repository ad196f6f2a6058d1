"""The device trace of a traced window, reduced to what the metric readers
need.

``torch.profiler`` records the card's activity alone (CUDA kernels,
copies and sets, and the runtime calls that launched them: CUPTI), which
costs the host far less than recording every operator. The trace is
written as a Chrome trace into a temporary directory, read back here and
deleted. Its clock is tied to the host's ``time.perf_counter`` by a marker:
right after a synchronisation, with the card idle, the benchmark notes the
host time and launches ``torch.cuda._sleep`` (ATen's ``spin_kernel``); the
launch call's start, or the kernel's where the runtime call is missing, is
taken to be that host time.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


@dataclass
class DeviceTrace:
    """Device events of one traced window, in host seconds
    (``time.perf_counter``): ``events`` (name, start, duration, category)
    sorted by start, the window's host bounds, and whether the marker was
    found (``aligned``)."""
    t0: float
    t1: float
    events: List[Tuple[str, float, float, str]]
    aligned: bool
    notes: List[str] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events, clipped to the window."""
        ivs = sorted((max(s, self.t0), min(s + d, self.t1)) for _, s, d, _ in self.events)
        out: List[list] = []
        for a, b in ivs:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """Intervals of the window in which nothing ran on the device."""
        gaps, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def kernels(self, name_part: str) -> List[Tuple[str, float, float, str]]:
        return [e for e in self.events if e[3] == "kernel" and name_part in e[0]]

    def n_kernels(self) -> int:
        return sum(1 for e in self.events if e[3] == "kernel")

    def top_ops(self, n: int = 10) -> List[list]:
        agg: Dict[str, float] = defaultdict(float)
        for name, _, d, _ in self.events:
            agg[short_name(name)] += d
        return [[k, v] for k, v in sorted(agg.items(), key=lambda kv: -kv[1])[:n]]


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its template arguments past ``limit``."""
    return name if len(name) <= limit else name[:limit - 3] + "..."


class TraceRecorder:
    """Start and stop the profiler around a window, from the thread that
    launches the window's work; ``result()`` reads the trace."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="bench_trace_")
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        import torch

        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        torch.cuda._sleep(1000)

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def result(self) -> DeviceTrace:
        path = os.path.join(self.dir, "trace.json")
        try:
            self.prof.export_chrome_trace(path)
            self.prof = None
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)
        return reduce_events(events, self.t0, self.t1)


def reduce_events(events: list, t0: float, t1: float) -> DeviceTrace:
    """Device events of a Chrome trace in host seconds, the marker's start
    taken as ``t0``; events before the marker are dropped."""
    launch_ts: Dict[int, float] = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(ev["ts"])
    dev = [ev for ev in events
           if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES]
    marker = next((ev for ev in dev if MARKER in ev.get("name", "")), None)
    notes = []
    if marker is None:
        notes.append("marker not found: the first device event taken as the window's start")
        origin = min((float(ev["ts"]) for ev in dev), default=0.0)
        aligned = False
    else:
        corr = (marker.get("args") or {}).get("correlation")
        origin = launch_ts.get(corr, float(marker["ts"]))
        aligned = True
    out = []
    for ev in dev:
        if ev is marker:
            continue
        start = t0 + (float(ev["ts"]) - origin) * 1e-6
        if start < t0 or start > t1:
            continue
        out.append((ev.get("name", ""), start, float(ev.get("dur", 0.0)) * 1e-6, ev["cat"]))
    out.sort(key=lambda e: e[1])
    return DeviceTrace(t0, t1, out, aligned, notes)


def label_gaps(trace: DeviceTrace, spans: List[Tuple[str, float, float]],
               n: int = 10) -> List[list]:
    """The ``n`` longest idle gaps of the device, each named by the host
    span (name, start, end) that covers most of it ("host: between spans"
    where none does)."""
    out = []
    for a, b in trace.idle_gaps():
        best, cover = "host: between spans", 0.0
        for name, s, e in spans:
            c = min(b, e) - max(a, s)
            if c > cover:
                best, cover = name, c
        out.append([best, b - a])
    out.sort(key=lambda g: -g[1])
    return out[:n]
