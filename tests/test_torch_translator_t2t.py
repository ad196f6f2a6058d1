"""The port's ``Translator.predict(text, "t2tt" | "t2st", ...)`` against the
JAX ``Translator`` on ``tiny_v2``, with the toy tokenizers and the tiny unit
HiFi-GAN of tests/test_torch_translator_s2st.py: the UnitY tree through the
JAX package's ``quantize_params(min_size=1)`` (so the tied embedding is int8
and the candidate step takes ``int8_vocab_topk_v2``), carried across by
``checkpoint/from_jax.py``; beam 2, max 16; the int8 KV cache and the fp
one; ``SEAMLESS_CANDIDATE_BEAM`` on and off. The JAX package reads the
switch when it first builds its jitted beam, and its jit cache key leaves it
out, so each setting gets a Translator of its own. Texts, text tokens and
units identical; waveforms within 1e-5 absolute (fp32 convolutions of two
libraries summed in different orders, then a tanh)."""

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
from seamless_communication_tpu.models.unity.unit_tokenizer import (
    UnitTokenizer as JUnitTokenizer,
)
from seamless_communication_tpu.models.vocoder.codehifigan import (
    CodeHifiGanConfig as JCodeHifiGanConfig, code_hifigan_init as j_code_hifigan_init,
)
from seamless_communication_tpu.models.vocoder.hifigan import (
    HifiGanConfig as JHifiGanConfig,
)
from seamless_communication_tpu.ops.quantization import quantize_params as j_quantize_params
from seamless_communication_tpu.text.char_tokenizer import CharTokenizer as JCharTokenizer
from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

from seamless_communication_torch.checkpoint.from_jax import (
    to_torch, unity_params_from_jax,
)
from seamless_communication_torch.inference.generator import (
    SequenceGeneratorOptions, _bucket,
)
from seamless_communication_torch.inference.translator import Translator
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.models.vocoder.codehifigan import CodeHifiGanConfig
from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig
from seamless_communication_torch.ops.kernels import launch_counts
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import SentencePieceModel

from tests.test_torch_translator_s2st import (
    CHAR_SPM, HIFIGAN, LANG_SPKR, LANGS, TEXT_SPM, VOCODER,
)

KV = {"int8": dict(kv_cache_int8=True), "fp": dict(kv_cache_int8=False)}
# no "." or ",": the toy vocabulary holds them twice, and the JAX package's
# native SentencePiece encoder picks the first entry where the port's (its
# Python path) picks the last (tests/test_torch_translator_s2tt.py)
TEXTS = ["the cat sat on the mat", "hello world a dog sat on a cat"]


@pytest.fixture(scope="module")
def models():
    jparams = j_quantize_params(junity.unity_init(jax.random.PRNGKey(0),
                                                  jget_arch("tiny_v2")), min_size=1)
    jvcfg = JCodeHifiGanConfig(**VOCODER, hifigan=JHifiGanConfig(**HIFIGAN))
    jvoc = j_code_hifigan_init(jax.random.PRNGKey(1), jvcfg)
    tt = Translator(unity_params_from_jax(jax.tree.map(np.asarray, jparams)),
                    get_arch("tiny_v2"),
                    NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS),
                    UnitTokenizer(100, ["eng", "fra"], "base_v2"),
                    CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM)),
                    vocoder_params=to_torch(jax.tree.map(np.asarray, jvoc)),
                    vocoder_cfg=CodeHifiGanConfig(**VOCODER,
                                                  hifigan=HifiGanConfig(**HIFIGAN)),
                    lang_spkr_idx_map=LANG_SPKR, device="cpu")
    assert "embedding_i8" in tt.params["text_decoder"]["embed"]
    jts = {}

    def jax_translator(candidate: bool) -> JTranslator:
        if candidate not in jts:
            jts[candidate] = JTranslator(
                jparams, jget_arch("tiny_v2"),
                JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS),
                JUnitTokenizer(100, ["eng", "fra"], "base_v2"),
                JCharTokenizer(JSpm.from_bytes(CHAR_SPM)), vocoder_params=jvoc,
                vocoder_cfg=jvcfg, lang_spkr_idx_map=LANG_SPKR)
        return jts[candidate]

    return jax_translator, tt


def _set_candidate(monkeypatch, candidate: bool):
    if candidate:
        monkeypatch.setenv("SEAMLESS_CANDIDATE_BEAM", "1")
    else:
        monkeypatch.delenv("SEAMLESS_CANDIDATE_BEAM", raising=False)


def _jax_best_tokens(jt, texts, opts):
    """The JAX generator's best hypothesis for the padded source rows."""
    ids = [jt.text_tokenizer.encode_source(t, "eng") for t in texts]
    lens = np.array([len(i) for i in ids], np.int32)
    arr = np.zeros((len(ids), _bucket(int(lens.max()), 16)), np.int32)
    for i, row in enumerate(ids):
        arr[i, :len(row)] = row
    jenc = jt.generator._encode_text_fn()(jt.params, jnp.asarray(arr), jnp.asarray(lens))
    tok, tlens, _ = jt.generator.generate_text(jenc, "fra", opts_override=opts)
    return tok, tlens


def _assert_speech_same(tspeech, jspeech):
    assert tspeech.units == jspeech.units
    assert all(len(u) > 0 for u in tspeech.units)
    assert len(tspeech.audio_wavs) == len(jspeech.audio_wavs)
    for got, want in zip(tspeech.audio_wavs, jspeech.audio_wavs):
        assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=1e-5)


@pytest.mark.parametrize("candidate", [True, False], ids=["candidate", "full_vocab"])
@pytest.mark.parametrize("kv", list(KV))
def test_t2tt_and_t2st_match_jax(models, monkeypatch, kv, candidate):
    jax_translator, tt = models
    _set_candidate(monkeypatch, candidate)
    jt = jax_translator(candidate)
    opts = dict(beam_size=2, soft_max_seq_len=(0, 16), hard_max_seq_len=16, **KV[kv])
    jo, to = JOptions(**opts), SequenceGeneratorOptions(**opts)
    before = dict(launch_counts)

    jtexts, _ = jt.predict(TEXTS[0], "t2tt", "fra", src_lang="eng",
                           text_generation_opts=jo)
    ttexts, speech = tt.predict(TEXTS[0], "t2tt", "fra", src_lang="eng",
                                text_generation_opts=to)
    assert speech is None and ttexts == jtexts
    assert set(tt.last_timings) == {"encoder", "text_decode"}
    jtok, jlens = _jax_best_tokens(jt, TEXTS[:1], jo)
    res = tt.generator.last_result
    np.testing.assert_array_equal(res.lengths[:, 0].numpy(), jlens)
    np.testing.assert_array_equal(res.tokens[:, 0].numpy(), jtok)

    jtexts, jspeech = jt.predict(TEXTS[0], "t2st", "fra", src_lang="eng",
                                 text_generation_opts=jo)
    ttexts, tspeech = tt.predict(TEXTS[0], "t2st", "fra", src_lang="eng",
                                 text_generation_opts=to)
    assert ttexts == jtexts
    _assert_speech_same(tspeech, jspeech)
    assert set(tt.last_timings) == {"encoder", "text_decode", "redecode", "t2u",
                                    "vocoder"}
    assert launch_counts == before          # CPU tensors launch no kernel


def test_t2st_batch_of_two_with_candidates(models, monkeypatch):
    """Two source texts of different lengths (padded rows) in one request,
    candidate beam on, int8 KV."""
    jax_translator, tt = models
    _set_candidate(monkeypatch, True)
    jt = jax_translator(True)
    opts = dict(beam_size=2, soft_max_seq_len=(0, 16), hard_max_seq_len=16,
                kv_cache_int8=True)
    jtexts, jspeech = jt.predict(TEXTS, "t2st", "fra", src_lang="eng",
                                 text_generation_opts=JOptions(**opts))
    ttexts, tspeech = tt.predict(TEXTS, "t2st", "fra", src_lang="eng",
                                 text_generation_opts=SequenceGeneratorOptions(**opts))
    assert ttexts == jtexts and len(ttexts) == 2
    _assert_speech_same(tspeech, jspeech)
    jtok, _ = _jax_best_tokens(jt, TEXTS, JOptions(**opts))
    np.testing.assert_array_equal(tt.generator.last_result.tokens[:, 0].numpy(), jtok)


def test_text_input_needs_src_lang(models):
    _, tt = models
    for task in ("t2tt", "t2st"):
        with pytest.raises(ValueError, match="src_lang required"):
            tt.predict(TEXTS[0], task, "fra")
