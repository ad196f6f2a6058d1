"""The port's beam search in candidate mode against the JAX package, on the
setting of tests/unit/test_beam_search.py ``test_candidate_mode_matches_full_
vocab``: ``tiny_v2`` decoder steps over a seeded encoder output, beam 3,
max_len 14, min_len 3 (so EOS is suppressed among the candidates), prefixes
[2, 5] and [2, 6], the same parameters carried across by
``checkpoint/from_jax.py``; with the fp tied embedding (the plain top-k) and
with the int8 one (``int8_vocab_topk_v2``). Tokens and lengths exactly equal,
scores within rtol 1e-5, atol 1e-6; and the port's candidate mode against
its own full-vocabulary mode, likewise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.ops import quantization as jq
from seamless_communication_tpu.ops.beam_search import (
    BeamSearchOptions as JOptions, beam_search as j_beam_search,
)

from seamless_communication_torch.checkpoint.from_jax import unity_params_from_jax
from seamless_communication_torch.models.unity import model as tunity
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.ops.beam_search import (
    BeamSearchOptions, beam_search,
)

K, MAX_LEN = 3, 14
OPTS = dict(beam_size=K, max_len=MAX_LEN, min_len=3, pad_idx=0, unk_idx=1, eos_idx=3)
PREFIX = np.array([[2, 5], [2, 6]], np.int32)
CASES = {"fp_embed_int8_kv": (False, True), "int8_embed_int8_kv": (True, True),
         "int8_embed_fp_kv": (True, False)}


@pytest.fixture(scope="module")
def setup():
    cfg = jget_arch("tiny_v2")
    jparams = junity.unity_init(jax.random.PRNGKey(0), cfg)
    enc = np.random.default_rng(0).standard_normal((2 * K, 9, cfg.nllb.dim)
                                                   ).astype(np.float32)
    return jparams, enc


def _jax_candidates(jparams, enc, kv_int8):
    cfg = jget_arch("tiny_v2")
    jenc = junity.EncoderOutput(jnp.asarray(enc), jnp.full((2 * K,), 9, jnp.int32))
    step_fn, cache_fn = junity.make_text_decode_step(jparams, cfg, jenc,
                                                     candidates=2 * K + 1)
    return j_beam_search(step_fn, cache_fn(MAX_LEN, kv_int8), jnp.asarray(PREFIX),
                         jnp.array([2, 2], jnp.int32), JOptions(**OPTS),
                         cfg.nllb.vocab_size, src_to_step=True, candidate_mode=True)


def _port(tparams, enc, kv_int8, candidates):
    cfg = get_arch("tiny_v2")
    tenc = tunity.EncoderOutput(torch.from_numpy(enc),
                                torch.full((2 * K,), 9, dtype=torch.int32))
    step_fn, cache_fn = tunity.make_text_decode_step(tparams, cfg, tenc,
                                                     candidates=candidates)
    return beam_search(step_fn, cache_fn(MAX_LEN, kv_int8), torch.from_numpy(PREFIX),
                       torch.tensor([2, 2], dtype=torch.int32), BeamSearchOptions(**OPTS),
                       cfg.nllb.vocab_size, candidate_mode=candidates is not None)


def _assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got.tokens), np.asarray(want.tokens))
    np.testing.assert_array_equal(np.asarray(got.lengths), np.asarray(want.lengths))
    np.testing.assert_allclose(np.asarray(got.scores), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-6)
    assert int(got.steps) == int(want.steps)


@pytest.mark.parametrize("case", sorted(CASES))
@torch.inference_mode()
def test_candidate_mode_matches_jax_and_full_vocab(setup, case):
    quantized, kv_int8 = CASES[case]
    jparams, enc = setup
    if quantized:
        jparams = jq.quantize_params(jparams, min_size=1)
    tparams = unity_params_from_jax(jax.tree.map(np.asarray, jparams))
    assert ("embedding_i8" in tparams["text_decoder"]["embed"]) == quantized
    cand = _port(tparams, enc, kv_int8, 2 * K + 1)
    _assert_same(cand, _jax_candidates(jparams, enc, kv_int8))
    _assert_same(cand, _port(tparams, enc, kv_int8, None))
    # every hypothesis starts with its prefix and has at least min_len tokens
    assert (cand.tokens[:, :, :2].numpy() == PREFIX[:, None, :]).all()
    assert bool((cand.lengths >= 2 + 3 + 1).all())


def test_candidate_mode_refuses_an_unk_penalty():
    opts = BeamSearchOptions(**OPTS, unk_penalty=0.5)
    with pytest.raises(ValueError, match="unk_penalty"):
        beam_search(None, None, torch.from_numpy(PREFIX), torch.tensor([2, 2]), opts,
                    256, candidate_mode=True)
