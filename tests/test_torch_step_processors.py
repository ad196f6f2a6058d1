"""The port's beam-search step processors against the JAX package:
``make_ngram_repeat_block`` (n = 1, 2, 3) and
``make_banned_sequence_processor`` (1-token and multi-token bans, rows
right-aligned with -1 as MinTox writes them, and rows of full length) give
exactly JAX's lprobs on seeded token histories over a small alphabet (so
that n-grams repeat). Then ``Translator.predict(text, "t2tt", ...)`` on
``tiny_v2`` with ``no_repeat_ngram_size`` and with ``banned_sequences``
gives the JAX Translator's texts and best tokens (beam 2, max 16, the
parameters carried across by ``checkpoint/from_jax.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.inference.generator import (
    SequenceGeneratorOptions as JOptions,
)
from seamless_communication_tpu.inference.translator import Translator as JTranslator
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.ops import beam_search as jbs
from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

from seamless_communication_torch.checkpoint.from_jax import unity_params_from_jax
from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
from seamless_communication_torch.inference.translator import Translator
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.ops import beam_search as tbs
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import SentencePieceModel

from tests.test_torch_translator_s2st import LANGS, TEXT_SPM

V = 9
B, K, T = 2, 3, 12


def _history(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, 8, (B, K, T)).astype(np.int32)   # a small alphabet
    lprobs = rng.standard_normal((B, K, V)).astype(np.float32)
    return tokens, lprobs


def _apply(jproc, tproc, tokens, lprobs, step):
    want = np.asarray(jproc(jnp.asarray(tokens), jnp.int32(step), jnp.asarray(lprobs)))
    got = tproc(torch.from_numpy(tokens).long(), step, torch.from_numpy(lprobs)).numpy()
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_repeat_block_matches_jax(n):
    jproc, tproc = jbs.make_ngram_repeat_block(n, V), tbs.make_ngram_repeat_block(n, V)
    banned_any = 0
    for seed in range(3):
        tokens, lprobs = _history(seed)
        for step in range(T - 1):
            got = _apply(jproc, tproc, tokens, lprobs, step)
            banned_any += int((got == tbs.NEG_INF).sum())
    assert (banned_any > 0) == (n > 1)


BANS = {
    # name: (rows, lengths)
    "one_token": ([[6]], [1]),
    "bigram": ([[5, 6]], [2]),
    "full_length_rows": ([[4, 5, 6], [7, 7, 5]], [3, 3]),
    "right_aligned_mixed": ([[-1, -1, 6], [-1, 5, 4], [4, 5, 7]], [1, 2, 3]),
    "none": (np.zeros((0, 1), np.int32), [0] * 0),
}


@pytest.mark.parametrize("ban", sorted(BANS))
def test_banned_sequence_processor_matches_jax(ban):
    rows, lens = BANS[ban]
    rows = np.asarray(rows, np.int32)
    lens = np.asarray(lens, np.int32)
    jproc = jbs.make_banned_sequence_processor(jnp.asarray(rows), jnp.asarray(lens), V)
    tproc = tbs.make_banned_sequence_processor(torch.from_numpy(rows),
                                               torch.from_numpy(lens), V)
    banned_any = 0
    for seed in range(3):
        tokens, lprobs = _history(seed + 10)
        for step in range(T - 1):
            got = _apply(jproc, tproc, tokens, lprobs, step)
            banned_any += int((got == tbs.NEG_INF).sum())
    assert (banned_any > 0) == (ban != "none")


@pytest.mark.parametrize("mode", ["processors", "cache_reorder"])
def test_candidate_mode_refuses_processors(mode):
    opts = tbs.BeamSearchOptions(beam_size=2, max_len=6)
    kw = (dict(processors=[tbs.make_ngram_repeat_block(2, V)]) if mode == "processors"
          else dict(cache_reorder=lambda cache, src: cache))
    with pytest.raises(ValueError, match="no cache_reorder and no step processors"):
        tbs.beam_search(None, None, torch.tensor([[3, 5]]), torch.tensor([2]), opts, V,
                        candidate_mode=True, **kw)


@pytest.fixture(scope="module")
def translators():
    jparams = junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))
    jt = JTranslator(jparams, jget_arch("tiny_v2"),
                     JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS))
    tt = Translator(unity_params_from_jax(jax.tree.map(np.asarray, jparams)),
                    get_arch("tiny_v2"),
                    NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS),
                    device="cpu")
    return jt, tt


TEXT = "the cat sat on the mat"
OPTS = dict(beam_size=2, soft_max_seq_len=(0, 16), hard_max_seq_len=16,
            kv_cache_int8=True)


def _jax_best(jt, opts, banned=None):
    ids = jt.text_tokenizer.encode_source(TEXT, "eng")
    arr = np.zeros((1, 16), np.int32)
    arr[0, :len(ids)] = ids
    jenc = jt.generator._encode_text_fn()(jt.params, jnp.asarray(arr),
                                          jnp.asarray([len(ids)], np.int32))
    tok, lens, _ = jt.generator.generate_text(jenc, "fra", banned=banned,
                                              opts_override=opts)
    return tok[0, :lens[0]]


@pytest.mark.parametrize("proc", ["ngram", "banned"])
def test_translator_with_processor_matches_jax(translators, monkeypatch, proc):
    """The best hypothesis of the plain beam repeats itself, so each
    processor changes it; the port gives the JAX Translator's texts and
    tokens. The candidate beam stays off with a processor."""
    jt, tt = translators
    monkeypatch.setenv("SEAMLESS_CANDIDATE_BEAM", "1")
    plain = _jax_best(jt, JOptions(**OPTS))
    kw, jkw, banned = {}, {}, None
    if proc == "ngram":
        opts = dict(OPTS, no_repeat_ngram_size=2)
    else:
        opts = dict(OPTS)
        # ban the plain hypothesis's first generated bigram, and one token
        banned = (np.array([[-1, int(plain[3])], [int(plain[2]), int(plain[3])]],
                           np.int32), np.array([1, 2], np.int32))
        kw = jkw = dict(banned_sequences=banned)
    jtexts, _ = jt.predict(TEXT, "t2tt", "fra", src_lang="eng",
                           text_generation_opts=JOptions(**opts), **jkw)
    ttexts, _ = tt.predict(TEXT, "t2tt", "fra", src_lang="eng",
                           text_generation_opts=SequenceGeneratorOptions(**opts), **kw)
    assert ttexts == jtexts
    res = tt.generator.last_result
    want = _jax_best(jt, JOptions(**opts), banned)
    got = res.tokens[0, 0, :int(res.lengths[0, 0])].numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, plain)
    gen = [int(t) for t in got[2:-1]]
    if proc == "ngram":
        assert len(set(zip(gen, gen[1:]))) == len(gen) - 1      # no bigram twice
    else:
        assert (int(plain[2]), int(plain[3])) not in set(zip(gen, gen[1:]))
