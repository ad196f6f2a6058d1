"""95th-percentile wall ms of a pool step, the benchmark's host clock
around each ``BatchedStreamingPool.step()`` (ended by a synchronisation of
the card), over every step of the window."""

from harness.common import quantile


def read(rec):
    return quantile([(s["t1"] - s["t0"]) * 1e3 for s in rec["data"]["steps"]], 0.95)
