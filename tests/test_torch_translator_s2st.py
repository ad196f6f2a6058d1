"""The port's ``Translator.predict(wav, "s2st", ...)`` against the JAX
``Translator`` on ``tiny_v2`` with the toy tokenizers and the tiny unit
HiFi-GAN of tests/integration/conftest.py: the same parameters (carried
across by ``checkpoint/from_jax.py``), beam 2, max 16, one seeded waveform.
Text tokens, texts and units must be identical, with the int8 KV cache, the
packed-int4 one and the fp one; the waveforms agree within 1e-5 absolute
(fp32 convolutions of two libraries summed in different orders, then a tanh;
the observed difference is below 1e-7)."""

import numpy as np
import pytest

import jax

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
from seamless_communication_tpu.text.char_tokenizer import CharTokenizer as JCharTokenizer
from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

from seamless_communication_torch.checkpoint.from_jax import (
    to_torch, unity_params_from_jax,
)
from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
from seamless_communication_torch.inference.translator import Translator
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.models.vocoder.codehifigan import CodeHifiGanConfig
from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
)

WORDS = ["▁the", "▁cat", "▁sat", "▁on", "▁mat", "▁a", "▁dog", ".", ",",
         "▁he", "llo", "▁wor", "ld"]
CHARS = ["▁"] + list("abcdefghijklmnopqrstuvwxyz.,")
LANGS = ["__eng__", "__fra__"]
BASE = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
        ("</s>", 0.0, TYPE_CONTROL)]
TEXT_SPM = build_spm_model(BASE + [(w, -float(20 - len(w)), TYPE_NORMAL) for w in WORDS]
                           + [(c, -30.0, TYPE_NORMAL) for c in CHARS])
CHAR_SPM = build_spm_model(BASE + [(c, -1.0, TYPE_NORMAL) for c in CHARS])
# the tiny vocoder of tests/integration/conftest.py
VOCODER = dict(num_units=100, unit_embed_dim=32, num_langs=4, lang_embed_dim=8,
               num_spkrs=4, spkr_embed_dim=8, dur_predictor_hidden=16)
HIFIGAN = dict(model_in_dim=48, upsample_initial_channel=64, upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),))
LANG_SPKR = {"multilingual": {"eng": 0, "fra": 1}, "multispkr": {"eng": [0], "fra": [1]}}
KV = {"int8": dict(kv_cache_int8=True, kv_cache_bits=8),
      "int4": dict(kv_cache_int8=True, kv_cache_bits=4),
      "fp": dict(kv_cache_int8=False)}


@pytest.fixture(scope="module")
def translators():
    jparams = junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))
    jvcfg = JCodeHifiGanConfig(**VOCODER, hifigan=JHifiGanConfig(**HIFIGAN))
    jvoc = j_code_hifigan_init(jax.random.PRNGKey(1), jvcfg)
    jt = JTranslator(jparams, jget_arch("tiny_v2"),
                     JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS),
                     JUnitTokenizer(100, ["eng", "fra"], "base_v2"),
                     JCharTokenizer(JSpm.from_bytes(CHAR_SPM)),
                     vocoder_params=jvoc, vocoder_cfg=jvcfg, lang_spkr_idx_map=LANG_SPKR)
    tt = Translator(unity_params_from_jax(jax.tree.map(np.asarray, jparams)),
                    get_arch("tiny_v2"),
                    NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS),
                    UnitTokenizer(100, ["eng", "fra"], "base_v2"),
                    CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM)),
                    vocoder_params=to_torch(jax.tree.map(np.asarray, jvoc)),
                    vocoder_cfg=CodeHifiGanConfig(**VOCODER,
                                                  hifigan=HifiGanConfig(**HIFIGAN)),
                    lang_spkr_idx_map=LANG_SPKR, device="cpu")
    return jt, tt


@pytest.fixture(scope="module")
def wav():
    return (np.random.default_rng(0).standard_normal(16000 * 3) * 0.1).astype(np.float32)


@pytest.mark.parametrize("kv", list(KV))
def test_s2st_matches_jax(translators, wav, kv):
    jt, tt = translators
    opts = dict(beam_size=2, soft_max_seq_len=(0, 16), hard_max_seq_len=16, **KV[kv])
    jtexts, jspeech = jt.predict(wav, "s2st", "fra",
                                 text_generation_opts=JOptions(**opts))
    ttexts, tspeech = tt.predict(wav, "s2st", "fra",
                                 text_generation_opts=SequenceGeneratorOptions(**opts))
    assert ttexts == jtexts
    # the best hypothesis of the same search, token for token
    res = tt.generator.last_result
    jenc = jt.generator._encode_speech_fn()(
        jt.params, *map(np.asarray, tt._audio_to_fbank(wav, 16000)))
    jtok, jlens, _ = jt.generator.generate_text(jenc, "fra",
                                                opts_override=JOptions(**opts))
    np.testing.assert_array_equal(res.lengths[:, 0].numpy(), jlens)
    np.testing.assert_array_equal(res.tokens[:, 0].numpy(), jtok)
    assert tspeech.units == jspeech.units
    assert len(tspeech.units[0]) > 0
    assert len(tspeech.audio_wavs) == len(jspeech.audio_wavs) == 1
    for got, want in zip(tspeech.audio_wavs, jspeech.audio_wavs):
        assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=1e-5)
    assert set(tt.last_timings) == {"encoder", "text_decode", "redecode", "t2u",
                                    "vocoder"}


def test_s2st_batch_of_two(translators, wav):
    """Two waveforms of different lengths in one request: the final-column
    trim applies to the longest hypothesis only, units still identical; with
    a duration factor and the n-gram filter of the units."""
    jt, tt = translators
    opts = dict(beam_size=2, soft_max_seq_len=(0, 16), hard_max_seq_len=16,
                kv_cache_int8=True, kv_cache_bits=4)
    batch = [wav, wav[:20000]]
    kw = dict(duration_factor=1.5, ngram_filtering=True)
    jtexts, jspeech = jt.predict(batch, "s2st", "eng",
                                 text_generation_opts=JOptions(**opts), **kw)
    ttexts, tspeech = tt.predict(batch, "s2st", "eng",
                                 text_generation_opts=SequenceGeneratorOptions(**opts),
                                 **kw)
    assert ttexts == jtexts and tspeech.units == jspeech.units
    for got, want in zip(tspeech.audio_wavs, jspeech.audio_wavs):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=1e-5)
