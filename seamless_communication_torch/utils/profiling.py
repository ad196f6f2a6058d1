"""Tracing and profiling helpers (counterpart of
``seamless_communication_tpu/utils/profiling.py``, whose ``device_trace``
wraps ``jax.profiler`` and whose ``aggregate_xplane`` reads TPU traces).

- ``device_trace``: ``torch.profiler`` over a block (the CPU, and the card
  where there is one), written as a Chrome trace (``trace.json``) that
  ``aggregate_trace`` reads back;
- ``annotate``: a decorator that names a function's work in traces
  (``torch.profiler.record_function``, and an NVTX range on the card);
- ``StageTimer``: host wall time of pipeline stages, each ending in a
  synchronisation of the device its value lies on.

``aggregate_trace`` takes the place of the JAX package's
``aggregate_xplane``, which parses the TPU's xplane protobuf: it sums the
events of a Chrome trace by name for the given categories (``kernel``,
``gpu_memcpy`` and ``gpu_memset`` by default: the card's time), and returns
[(total_ms, count, name)] by time, largest first.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional, Sequence

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


def annotate(name: str):
    """Decorator: name a function's work in traces."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with _range(name):
                return fn(*a, **k)
        return wrapped
    return deco


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


class StageTimer:
    """Host wall time of stages (the GGML_PERF counterpart). A stage given
    a ``sync_value`` (a tensor, or a tree of them) ends with a
    ``torch.cuda.synchronize`` of the card that its first tensor lies on, so
    that the device's work is inside the stage."""

    def __init__(self):
        self.times: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            leaf = _first_tensor(sync_value)
            if leaf is not None and leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        return {k: {"p50_ms": float(np.median(v) * 1000),
                    "mean_ms": float(np.mean(v) * 1000),
                    "n": len(v)}
                for k, v in self.times.items()}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


def aggregate_trace(path: str, *, categories: Sequence[str] = DEVICE_CATEGORIES,
                    top: int = 30) -> list:
    """Time per event name in a Chrome trace written by ``device_trace``
    (``torch.profiler``'s ``export_chrome_trace``): the complete events
    (``"ph": "X"``) whose category is in ``categories``, their durations
    (microseconds in the file) summed by name. Returns [(total_ms, count,
    name)] sorted by time, largest first (ties by name), the first ``top``
    of them (all where ``top`` is 0). On a CPU-only trace pass
    ``categories=("cpu_op",)`` for the operators, or ``("user_annotation",)``
    for ``annotate``'s ranges."""
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
