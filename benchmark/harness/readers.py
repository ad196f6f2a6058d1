"""Arithmetic the metric readers share: latency quantiles over a run's
requests, the device's idle share, and the model-FLOP share of the peak."""

from __future__ import annotations

from typing import Optional

from harness.common import quantile


def latency_ms(rec: dict, q: float) -> Optional[float]:
    """The q-quantile (ms) of the host-clock latency of every request the
    window served."""
    lat = [(r["t1"] - r["t0"]) * 1e3 for r in rec["data"]["requests"] if not r["error"]]
    return quantile(lat, q)


def idle_percent(rec: dict) -> Optional[float]:
    """The share (%) of the traced window in which no kernel, copy or set
    ran on the card."""
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def events_in(trace, name_part: str, t0: float, t1: float) -> list:
    """The kernels of ``trace`` whose name holds ``name_part`` and that
    start in [t0, t1) (host seconds)."""
    return [e for e in trace.kernels(name_part) if t0 <= e[1] < t1]
