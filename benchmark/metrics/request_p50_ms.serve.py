"""Median latency (ms) of the served requests, the benchmark's host clock
around each ``DynamicBatcher.submit``, over every request of the window."""

from harness.readers import latency_ms


def read(rec):
    return latency_ms(rec, 0.5)
