"""The port's span recorder and its device traces (counterpart of
``seamless_communication_tpu/utils/profiling.py``, whose ``device_trace``
wraps ``jax.profiler`` and whose ``aggregate_xplane`` reads TPU traces).

``StageTimer`` is the one recorder of host spans, and ``TRACER`` its
process-wide instance, off by default (``enable()``, ``disable()``; ``on``
says which). While on it keeps, in memory, spans (``Span``: a name, its
start and end, its id, the id of the span that caused it and a request id
where a request exists) and integer counters under names. Start and end are
``time.perf_counter`` seconds: the host clock to which a device trace's
clock can be tied (a marker kernel launched right after a synchronisation),
so the spans lie on the device trace's time line. ``take()`` returns the
spans, in the order they ended (a child before its parent), and the
counters' totals, and clears both; ``chrome_trace`` writes them as a Chrome
trace that Perfetto shows beside a ``torch.profiler`` trace.

A call site reads ``TRACER.on`` and does nothing else while it is off:
nothing is allocated, timed or synchronised. ``begin`` opens a span whose
parent is the span open on the same thread; ``end`` closes it; ``record``
notes a span whose bounds the caller took (a request's wait in a queue);
``count`` adds to a counter. These only append, so threads write at once
without a lock. ``stage_end`` is the pipelines' stage timer: it
synchronises the card, notes the stage's wall seconds in a ``last_timings``
dict under its name and, while the recorder is on, closes the stage's span.
``stage`` times a block for ``summary()`` (any instance, on or off).

``device_trace`` runs ``torch.profiler`` over a block (the CPU, and the card
where there is one) and writes a Chrome trace (``trace.json``) that
``aggregate_trace`` reads back. ``aggregate_trace`` takes the place of the
JAX package's ``aggregate_xplane``, which parses the TPU's xplane protobuf:
it sums the events of a Chrome trace by name for the given categories
(``kernel``, ``gpu_memcpy`` and ``gpu_memset`` by default: the card's time),
and returns [(total_ms, count, name)] by time, largest first.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """What ``device_trace`` captured: the profiler (``profile``) and, once
    the block has ended, the Chrome trace's ``path``."""

    def __init__(self, profile):
        self.profile = profile
        self.path: Optional[str] = None

    def aggregate(self, **kw) -> list:
        """``aggregate_trace`` of this trace."""
        if self.path is None:
            raise RuntimeError("the trace is written when its block ends")
        return aggregate_trace(self.path, **kw)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None,
                 annotate: Optional[str] = None) -> Iterator[Trace]:
    """Profile everything inside the block with ``torch.profiler`` (CPU
    activity, and CUDA activity where a card is present) and write it to
    ``log_dir/trace.json`` (a temporary directory's ``seamless_trace`` by
    default); view it in Perfetto or chrome://tracing. ``annotate`` names
    the block in the trace. Yields a ``Trace``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "seamless_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        trace = Trace(prof)
        if annotate:
            with _range(annotate):
                yield trace
        else:
            yield trace
    trace.path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(trace.path)
    logger.info("trace written to %s", trace.path)


@contextlib.contextmanager
def _range(name: str) -> Iterator[None]:
    """``record_function(name)``, inside an NVTX range of the same name
    where a card is present."""
    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(torch.profiler.record_function(name))
        yield


def _first_tensor(value) -> Optional[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


class Span(NamedTuple):
    """A closed span: ``t0`` and ``t1`` in ``time.perf_counter`` seconds;
    ``parent`` the id of the span that caused it, ``request`` the request it
    served (None where there is none), ``thread`` the thread that closed it."""
    name: str
    t0: float
    t1: float
    id: int
    parent: Optional[int]
    request: Optional[int]
    thread: int


class OpenSpan(NamedTuple):
    """What ``begin`` hands back for ``end``."""
    name: str
    id: int
    parent: Optional[int]
    t0: float


class StageTimer:
    """The span recorder (see the module), and the host wall time of stages
    (the GGML_PERF counterpart). A stage given a ``sync_value`` (a tensor,
    or a tree of them) ends with a ``torch.cuda.synchronize`` of the card
    that its first tensor lies on, so that the device's work is inside the
    stage."""

    def __init__(self):
        self.on = False
        self.times: Dict[str, list] = defaultdict(list)
        self._spans: List[Span] = []
        self._counts: List[Tuple[str, int]] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        """Stop recording; spans begun while on are still recorded when
        they end."""
        self.on = False

    def begin(self, name: str) -> OpenSpan:
        """Open a span, the child of the span open on this thread. Call
        sites call it only while ``on``."""
        loc = self._local
        parent = getattr(loc, "open", None)
        sid = next(self._ids)
        loc.open = sid
        return OpenSpan(name, sid, parent, time.perf_counter())

    def end(self, span: OpenSpan, t1: Optional[float] = None) -> None:
        """Close ``span`` at ``t1`` (now by default)."""
        self._local.open = span.parent
        self._spans.append(Span(span.name, span.t0,
                                time.perf_counter() if t1 is None else t1, span.id,
                                span.parent, None, threading.get_ident()))

    def record(self, name: str, t0: float, t1: float, *, parent: Optional[int] = None,
               request: Optional[int] = None) -> None:
        """Note a span whose bounds the caller took (a request's wait)."""
        self._spans.append(Span(name, t0, t1, next(self._ids), parent, request,
                                threading.get_ident()))

    def count(self, name: str, n: int = 1) -> None:
        self._counts.append((name, n))

    def take(self) -> Tuple[List[Span], Dict[str, int]]:
        """The spans in the order they ended and the counters' totals since
        the last ``take``; both are cleared. Take them once the recorder is
        off and the spans begun while it was on have ended."""
        spans, self._spans = self._spans, []
        counts, self._counts = self._counts, []
        totals: Dict[str, int] = {}
        for name, n in counts:
            totals[name] = totals.get(name, 0) + n
        return spans, totals

    def stage_end(self, timings: Optional[dict], name: str, t0: float,
                  device: torch.device, span: Optional[OpenSpan] = None) -> float:
        """Note under ``timings[name]`` the wall seconds since ``t0``, after
        the card has finished the stage's work; returns the time now. The
        stage's span is ``span`` where the caller opened one, else, while
        the recorder is on, one named ``name`` from ``t0``. Where
        ``timings`` is None nothing is timed and ``t0`` is returned."""
        if timings is None:
            if span is not None:
                self.end(span)
            return t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        timings[name] = now - t0
        if span is not None:
            self.end(span, now)
        elif self.on:
            self.record(name, t0, now)
        return now

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None) -> Iterator[None]:
        span = self.begin(name) if self.on else None
        t0 = time.perf_counter() if span is None else span.t0
        try:
            yield
        finally:
            leaf = _first_tensor(sync_value)
            if leaf is not None and leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            t1 = time.perf_counter()
            self.times[name].append(t1 - t0)
            if span is not None:
                self.end(span, t1)

    def summary(self) -> dict:
        return {k: {"p50_ms": float(np.median(v) * 1000),
                    "mean_ms": float(np.mean(v) * 1000),
                    "n": len(v)}
                for k, v in self.times.items()}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


TRACER = StageTimer()


def chrome_trace(spans: Sequence[Span], counters: Optional[Dict[str, int]] = None,
                 path: Optional[str] = None) -> dict:
    """``spans`` and ``counters`` (``take()``'s) as a Chrome trace: a
    complete event a span, its time stamps the ``perf_counter`` clock in
    microseconds, a track a thread, and one a request for the spans that
    carry one (their waits overlap); the counters' totals under
    ``otherData``. Written to ``path`` where given."""
    pid = os.getpid()
    events = [{"name": s.name, "ph": "X", "ts": s.t0 * 1e6, "dur": (s.t1 - s.t0) * 1e6,
               "pid": pid, "tid": (f"request {s.request}" if s.request is not None
                                   else s.thread),
               "args": {"id": s.id, "parent": s.parent, "request": s.request}}
              for s in spans]
    out = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"counters": dict(counters or {})}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f)
    return out


def aggregate_trace(path: str, *, categories: Sequence[str] = DEVICE_CATEGORIES,
                    top: int = 30) -> list:
    """Time per event name in a Chrome trace written by ``device_trace``
    (``torch.profiler``'s ``export_chrome_trace``): the complete events
    (``"ph": "X"``) whose category is in ``categories``, their durations
    (microseconds in the file) summed by name. Returns [(total_ms, count,
    name)] sorted by time, largest first (ties by name), the first ``top``
    of them (all where ``top`` is 0). On a CPU-only trace pass
    ``categories=("cpu_op",)`` for the operators, or ``("user_annotation",)``
    for the ranges ``device_trace`` names."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    agg: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in categories:
            continue
        a = agg[ev.get("name", "")]
        a[0] += float(ev.get("dur", 0.0))
        a[1] += 1
    out = sorted(((us / 1e3, n, name) for name, (us, n) in agg.items()),
                 key=lambda r: (-r[0], r[2]))
    return out[:top] if top else out
