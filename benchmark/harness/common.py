"""Seeds, quantiles and the files a cell is made of, found by name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of draws (weights, traffic, a request)
    derived from the run's ``--seed`` and ``tags`` (strings or ints)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for t in tags:
        if isinstance(t, str):
            words += list(t.encode())
        else:
            words += [int(t) & 0xFFFFFFFF, (int(t) >> 32) & 0xFFFFFFFF]
    lo, hi = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(hi) << 32 | int(lo)) & ((1 << 63) - 1)


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *tags))


def quantile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-quantile (0 < q < 1) by linear interpolation between order
    statistics (numpy's default); None for no values."""
    if not values:
        return None
    return float(np.quantile(np.asarray(values, np.float64), q))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}; known: "
                     f"{[w['name'] for w in spec['workloads']]}")


def config_file(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"unknown config {name!r}")


def traffic_file(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits_file(workload_name: str) -> dict:
    return load_json(BENCH_DIR / "limits" / f"{workload_name}.json")


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (metric readers and
    drivers are named from metric and driver names, dots included)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
