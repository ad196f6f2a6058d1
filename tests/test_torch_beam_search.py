"""The port's beam search against the JAX one on a fixed table of logits:
``step_fn`` returns row ``step`` of a seeded (T, B*K, V) table whatever the
cache, so both searches see the same scores. Tokens and lengths exactly
equal, scores within 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.ops.beam_search import (
    BeamSearchOptions as JOptions, beam_search as j_beam_search,
)
from seamless_communication_torch.ops.beam_search import (
    BeamSearchOptions, beam_search,
)

V, EOS = 12, 3


def _table(seed, B, K, T, *, eos_shift=0.0, unk_boost=0.0):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((T, B * K, V)).astype(np.float32) * 2.0
    t[:, :, EOS] += eos_shift
    t[:, :, 1] += unk_boost
    return t


def _run_both(table, prefix, prefix_len, **opt):
    B, K = prefix.shape[0], opt["beam_size"]

    def jstep(tok, cache, step, beam_src):
        return jnp.asarray(table)[step], cache

    jres = jax.jit(lambda: j_beam_search(
        jstep, jnp.zeros((B * K,)), jnp.asarray(prefix), jnp.asarray(prefix_len),
        JOptions(**opt), V, src_to_step=True))()

    calls = []

    def tstep(tok, cache, step, beam_src):
        calls.append(beam_src.clone())
        return torch.from_numpy(table[step]), cache

    tres = beam_search(tstep, None, torch.from_numpy(prefix),
                       torch.from_numpy(prefix_len), BeamSearchOptions(**opt), V)
    return jres, tres, calls


CASES = {
    # name: (table kwargs, options, prefix, prefix_len)
    "plain": (dict(seed=0), dict(beam_size=3, max_len=10), [[3, 7]], [2]),
    "min_len_and_penalties": (dict(seed=1, eos_shift=2.0, unk_boost=1.0),
                              dict(beam_size=3, max_len=12, min_len=4,
                                   len_penalty=0.7, unk_penalty=0.5),
                              [[3, 7], [3, 8]], [2, 2]),
    "hard_max_forces_eos": (dict(seed=2, eos_shift=-30.0),
                            dict(beam_size=2, max_len=6), [[3, 9]], [2]),
    "eos_outside_top_k": (dict(seed=3, eos_shift=1.5),
                          dict(beam_size=4, max_len=14), [[3, 5], [3, 6]], [2, 2]),
    "ragged_prefix": (dict(seed=4, eos_shift=0.5),
                      dict(beam_size=2, max_len=9), [[3, 7, 8], [3, 6, 0]], [3, 2]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_beam_search(case):
    tkw, opt, prefix, plen = CASES[case]
    prefix = np.array(prefix, np.int32)
    plen = np.array(plen, np.int32)
    table = _table(B=prefix.shape[0], K=opt["beam_size"], T=opt["max_len"], **tkw)
    jres, tres, _ = _run_both(table, prefix, plen, **opt)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.lengths.numpy(), np.asarray(jres.lengths))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores),
                               rtol=1e-5, atol=1e-5)
    assert tres.steps == int(jres.steps)
    # every hypothesis starts with its forced prefix
    for b in range(prefix.shape[0]):
        assert (tres.tokens[b, :, :plen[b]].numpy() == prefix[b, :plen[b]]).all()


def test_hard_max_ends_every_hypothesis_in_eos():
    tkw, opt, prefix, plen = CASES["hard_max_forces_eos"]
    table = _table(B=1, K=opt["beam_size"], T=opt["max_len"], **tkw)
    _, tres, _ = _run_both(table, np.array(prefix, np.int32),
                           np.array(plen, np.int32), **opt)
    for k in range(opt["beam_size"]):
        n = int(tres.lengths[0, k])
        assert n == opt["max_len"] and int(tres.tokens[0, k, n - 1]) == EOS


def test_beam_src_is_the_previous_selection():
    """``beam_src`` of the first step is the identity and stays a
    permutation-with-repeats of each batch row's own beams."""
    tkw, opt, prefix, plen = CASES["eos_outside_top_k"]
    table = _table(B=2, K=opt["beam_size"], T=opt["max_len"], **tkw)
    _, _, calls = _run_both(table, np.array(prefix, np.int32),
                            np.array(plen, np.int32), **opt)
    K = opt["beam_size"]
    assert torch.equal(calls[0], torch.arange(2 * K, dtype=torch.int32))
    for src in calls:
        assert src.dtype == torch.int32
        assert ((src // K) == torch.arange(2).repeat_interleave(K)).all()
