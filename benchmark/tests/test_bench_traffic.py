"""The traffic generator: the same requests for a seed, others for another,
and every seed the same set of sizes."""

import numpy as np

import tiny  # noqa: F401  (paths)
from harness import traffic as tg
from harness.common import sub_seed

SPEC = {"min": 4.0, "max": 20.0, "count": 160}
BIG = 2 ** 33 + 12345


def _take(seed, n=400):
    src = tg.RequestSource(SPEC, seed, "serve")
    return [src.next() for _ in range(n)]


def test_same_seed_same_requests():
    assert _take(BIG) == _take(BIG)
    a = tg.noise(BIG, "serve", 7, 16000, 0.1)
    assert np.array_equal(a, tg.noise(BIG, "serve", 7, 16000, 0.1))


def test_other_seed_other_order_same_sizes():
    a, b = _take(BIG), _take(BIG + 1)
    assert a != b
    # each round through the grid holds every size once, whatever the seed
    assert sorted(s for _, s in a[:160]) == sorted(s for _, s in b[:160])
    assert not np.array_equal(tg.noise(BIG, "serve", 7, 1000, 0.1),
                              tg.noise(BIG + 1, "serve", 7, 1000, 0.1))


def test_grid_and_seeds():
    g = tg.grid(SPEC)
    assert len(g) == 160 and g.min() > 4.0 and g.max() < 20.0
    assert 4.0 < np.mean(g) < 20.0 and abs(np.mean(g) - 12.0) < 1e-9
    assert sub_seed(BIG, "weights") != sub_seed(BIG + 1, "weights")
    assert 0 <= sub_seed(2 ** 40, "x") < 2 ** 63


def test_session_chunks_are_whole():
    src = tg.RequestSource({"min": 32, "max": 62, "count": 31}, BIG, "stream", quantum_s=1.0)
    sizes = [src.next()[1] for _ in range(62)]
    assert all(float(s).is_integer() and 32 <= s <= 62 for s in sizes)
