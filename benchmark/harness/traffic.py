"""The one traffic generator: it reads a mix's parameters (a file in
``traffic/``) and makes the requests of a run from ``--seed``.

Every seed gets the same set of sizes in another order: a length parameter
``{"min": a, "max": b, "count": n}`` is the grid of ``n`` values spread
evenly over [a, b] (cell centres), shuffled by the seed, and again by the
seed and the round for each further round through the grid. A request's
audio is seeded noise drawn from the seed and the request's index, so the
same seed gives the same requests in the same order.
"""

from __future__ import annotations

import itertools
import threading
from typing import Iterator

import numpy as np

from harness.common import rng


def grid(spec: dict) -> np.ndarray:
    a, b, n = float(spec["min"]), float(spec["max"]), int(spec["count"])
    return a + (b - a) * (np.arange(n) + 0.5) / n


def lengths(spec: dict, seed: int, tag: str) -> Iterator[float]:
    """The seed's endless sequence of lengths from ``spec``'s grid."""
    values = grid(spec)
    for r in itertools.count():
        yield from values[rng(seed, tag, r).permutation(len(values))].tolist()


def noise(seed: int, tag: str, index: int, n_samples: int, std: float) -> np.ndarray:
    """Request ``index``'s seeded noise, fp32."""
    x = rng(seed, tag, index).standard_normal(n_samples) * std
    return x.astype(np.float32)


class RequestSource:
    """The run's requests in order, handed out one at a time to whichever
    client asks (thread-safe): ``next()`` -> (index, seconds)."""

    def __init__(self, spec: dict, seed: int, tag: str, quantum_s: float = 0.01):
        self._it = lengths(spec, seed, tag)
        self._i = 0
        self._lock = threading.Lock()
        self.quantum_s = quantum_s

    def next(self) -> tuple[int, float]:
        with self._lock:
            i, self._i = self._i, self._i + 1
            s = next(self._it)
        return i, round(s / self.quantum_s) * self.quantum_s
