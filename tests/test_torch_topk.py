"""The port's stable top-k (``ops/topk.py``) against ``jax.lax.top_k``, on
rows with many equal values: values and indices exactly equal, so ties rank
the lower index first in both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_torch.ops.topk import top_k


@pytest.mark.parametrize("k", [1, 7, 40])
def test_top_k_matches_jax_on_ties(k):
    x = np.random.default_rng(0).integers(-3, 4, (6, 40)).astype(np.float32)
    vals, idx = top_k(torch.from_numpy(x), k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
