"""SeamlessM4T v1 through ``Translator.predict``: the port against the JAX
``Translator`` on ``tiny_v1`` (XL conformer, AR T2U) with the same
parameters (carried across by ``checkpoint/from_jax.py``), the toy text
tokenizer, the AR ("base") unit tokenizer and the tiny unit HiFi-GAN of
tests/integration/conftest.py. Text beam 2 (max 16), unit beam 2 (max 32).

T2ST (as tests/integration/test_translator_v1_tiny.py), S2ST of 3 s of audio
with the fused-attention option off and on (3 s give 192 conformer frames
after the fbank's padding, so each XL layer takes the fused path; JAX's
library kernel runs in interpret mode), S2TT and ASR: texts, best text
tokens and units identical, waveforms within 1e-5 absolute (fp32
convolutions of two libraries summed in other orders, then a tanh)."""

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
from seamless_communication_torch.ops import fused_attention as tfa
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
)
from tests.test_torch_flash_attention import pallas_interpret

WORDS = ["▁the", "▁cat", "▁sat", "▁on", "▁mat", "▁a", "▁dog", "▁he", "llo", "▁wor", "ld"]
CHARS = ["▁"] + list("abcdefghijklmnopqrstuvwxyz")
LANGS = ["__eng__", "__fra__"]
BASE = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
        ("</s>", 0.0, TYPE_CONTROL)]
TEXT_SPM = build_spm_model(BASE + [(w, -float(20 - len(w)), TYPE_NORMAL) for w in WORDS]
                           + [(c, -30.0, TYPE_NORMAL) for c in CHARS])
# the tiny vocoder of tests/integration/conftest.py
VOCODER = dict(num_units=100, unit_embed_dim=32, num_langs=4, lang_embed_dim=8,
               num_spkrs=4, spkr_embed_dim=8, dur_predictor_hidden=16)
HIFIGAN = dict(model_in_dim=48, upsample_initial_channel=64, upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),))
LANG_SPKR = {"multilingual": {"eng": 0, "fra": 1}, "multispkr": {"eng": [0], "fra": [1]}}
TEXT = dict(beam_size=2, soft_max_seq_len=(0, 16), hard_max_seq_len=16)
UNIT = dict(beam_size=2)
MAX_UNITS = 32


@pytest.fixture(scope="module")
def jax_parts():
    cfg = jget_arch("tiny_v1")
    jparams = junity.unity_init(jax.random.PRNGKey(0), cfg)
    jvcfg = JCodeHifiGanConfig(**VOCODER, hifigan=JHifiGanConfig(**HIFIGAN))
    jvoc = j_code_hifigan_init(jax.random.PRNGKey(1), jvcfg)
    return jparams, jvoc, jvcfg


def _jax_translator(jax_parts):
    """A fresh JAX Translator: it reads SEAMLESS_FUSED_ATTN when it first
    traces a stage and caches the compiled stage without it."""
    jparams, jvoc, jvcfg = jax_parts
    unit_tok = JUnitTokenizer(100, ["eng", "fra"], "base")
    assert unit_tok.vocab_size <= jget_arch("tiny_v1").ar_t2u.unit_vocab_size
    return JTranslator(jparams, jget_arch("tiny_v1"),
                       JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS), unit_tok,
                       vocoder_params=jvoc, vocoder_cfg=jvcfg, lang_spkr_idx_map=LANG_SPKR,
                       text_opts=JOptions(**TEXT), unit_opts=JOptions(**UNIT))


@pytest.fixture(scope="module")
def translator(jax_parts):
    jparams, jvoc, _ = jax_parts
    return Translator(unity_params_from_jax(jax.tree.map(np.asarray, jparams)),
                      get_arch("tiny_v1"),
                      NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS),
                      UnitTokenizer(100, ["eng", "fra"], "base"),
                      vocoder_params=to_torch(jax.tree.map(np.asarray, jvoc)),
                      vocoder_cfg=CodeHifiGanConfig(**VOCODER,
                                                    hifigan=HifiGanConfig(**HIFIGAN)),
                      lang_spkr_idx_map=LANG_SPKR, text_opts=SequenceGeneratorOptions(**TEXT),
                      unit_opts=SequenceGeneratorOptions(**UNIT), device="cpu")


@pytest.fixture(scope="module")
def wav():
    return (np.random.default_rng(0).standard_normal(16000 * 3) * 0.1).astype(np.float32)


def _same_speech(tspeech, jspeech):
    assert tspeech.units == jspeech.units
    assert all(len(u) > 0 and all(0 <= x < 100 for x in u) for u in tspeech.units)
    assert len(tspeech.audio_wavs) == len(jspeech.audio_wavs) == len(tspeech.units)
    for got, want in zip(tspeech.audio_wavs, jspeech.audio_wavs):
        assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=1e-5)


def test_t2st_matches_jax(jax_parts, translator):
    jt = _jax_translator(jax_parts)
    jtexts, jspeech = jt.predict("the cat sat on a mat", "t2st", "fra", src_lang="eng",
                                 max_unit_len=MAX_UNITS)
    ttexts, tspeech = translator.predict("the cat sat on a mat", "t2st", "fra",
                                         src_lang="eng", max_unit_len=MAX_UNITS)
    assert ttexts == jtexts
    _same_speech(tspeech, jspeech)
    res = translator.generator.last_unit_result
    assert res.tokens[0, 0, :2].tolist() == [2, translator.generator.unit_tokenizer
                                             .lang_to_index("fra")]
    assert set(translator.last_timings) == {"encoder", "text_decode", "redecode", "t2u",
                                            "vocoder"}


@pytest.mark.parametrize("fused", ["0", "1"])
def test_s2st_matches_jax(jax_parts, translator, wav, monkeypatch, fused):
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", fused)
    calls = []
    flash = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a: calls.append(1) or flash(*a))
    jt = _jax_translator(jax_parts)
    with pallas_interpret():
        jtexts, jspeech = jt.predict(wav, "s2st", "fra", max_unit_len=MAX_UNITS)
        jenc = jt.generator._encode_speech_fn()(
            jt.params, *map(np.asarray, translator._audio_to_fbank(wav, 16000)))
        jtok, jlens, _ = jt.generator.generate_text(jenc, "fra")
    ttexts, tspeech = translator.predict(wav, "s2st", "fra", max_unit_len=MAX_UNITS)
    # the two XL conformer layers take the fused path; nothing else is long enough
    assert len(calls) == (2 if fused == "1" else 0)
    assert ttexts == jtexts
    res = translator.generator.last_result
    np.testing.assert_array_equal(res.lengths[:, 0].numpy(), jlens)
    np.testing.assert_array_equal(res.tokens[:, 0].numpy(), jtok)
    _same_speech(tspeech, jspeech)


@pytest.mark.parametrize("task", ["s2tt", "asr"])
def test_text_tasks_match_jax(jax_parts, translator, wav, task):
    jt = _jax_translator(jax_parts)
    batch = [wav, wav[:30000]]
    jtexts, _ = jt.predict(batch, task, "fra", src_lang="eng")
    ttexts, speech = translator.predict(batch, task, "fra", src_lang="eng")
    assert speech is None and ttexts == jtexts and len(ttexts) == 2
