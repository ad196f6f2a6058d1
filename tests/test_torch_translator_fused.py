"""The fused-attention option through ``Translator.predict`` on ``tiny_v2``:
the port with ``SEAMLESS_FUSED_ATTN=1`` (K6's plain version on the CPU)
against the JAX ``Translator`` with the option on (its library kernel in
interpret mode), same parameters, toy tokenizers and tiny unit HiFi-GAN as
``tests/test_torch_translator_s2st.py``.

S2ST of 3 s of audio with ``max_unit_len`` 256: the two Shaw conformer
layers (the fbank padded to 384 frames: 192 conformer frames; relative
logits and padding folded into ``ab``) and the two FFT layers of the NAR
T2U (256 unit positions, key padding as segment ids) take the fused path. T2TT of a 130-token source: the two text-encoder
layers take it. Texts, best text tokens and units identical; waveforms
within 1e-5 absolute."""

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
from seamless_communication_torch.ops import fused_attention as tfa
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
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
CHAR_SPM = build_spm_model(BASE + [(c, -1.0, TYPE_NORMAL) for c in CHARS])
# the tiny vocoder of tests/integration/conftest.py
VOCODER = dict(num_units=100, unit_embed_dim=32, num_langs=4, lang_embed_dim=8,
               num_spkrs=4, spkr_embed_dim=8, dur_predictor_hidden=16)
HIFIGAN = dict(model_in_dim=48, upsample_initial_channel=64, upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),))
LANG_SPKR = {"multilingual": {"eng": 0, "fra": 1}, "multispkr": {"eng": [0], "fra": [1]}}
OPTS = dict(beam_size=2, soft_max_seq_len=(0, 16), hard_max_seq_len=16)


@pytest.fixture(scope="module")
def translators():
    """A JAX Translator built while the option is on (it reads the variable
    when it first traces a stage) and the port's."""
    jparams = junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))
    jvcfg = JCodeHifiGanConfig(**VOCODER, hifigan=JHifiGanConfig(**HIFIGAN))
    jvoc = j_code_hifigan_init(jax.random.PRNGKey(1), jvcfg)
    jt = JTranslator(jparams, jget_arch("tiny_v2"),
                     JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS),
                     JUnitTokenizer(100, ["eng", "fra"], "base_v2"),
                     JCharTokenizer(JSpm.from_bytes(CHAR_SPM)),
                     vocoder_params=jvoc, vocoder_cfg=jvcfg, lang_spkr_idx_map=LANG_SPKR,
                     text_opts=JOptions(**OPTS))
    tt = Translator(unity_params_from_jax(jax.tree.map(np.asarray, jparams)),
                    get_arch("tiny_v2"),
                    NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS),
                    UnitTokenizer(100, ["eng", "fra"], "base_v2"),
                    CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM)),
                    vocoder_params=to_torch(jax.tree.map(np.asarray, jvoc)),
                    vocoder_cfg=CodeHifiGanConfig(**VOCODER,
                                                  hifigan=HifiGanConfig(**HIFIGAN)),
                    lang_spkr_idx_map=LANG_SPKR,
                    text_opts=SequenceGeneratorOptions(**OPTS), device="cpu")
    return jt, tt


@pytest.fixture
def fused_calls(monkeypatch):
    """The option on; returns the list of the port's flash-attention calls."""
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", "1")
    calls = []
    flash = tfa.flash_attention

    def counted(qs, k, v, ab=None, q_seg=None, kv_seg=None):
        calls.append((tuple(qs.shape), ab is not None, q_seg is not None))
        return flash(qs, k, v, ab, q_seg, kv_seg)

    monkeypatch.setattr(tfa, "flash_attention", counted)
    return calls


def test_s2st_fused_matches_jax(translators, fused_calls):
    jt, tt = translators
    wav = (np.random.default_rng(0).standard_normal(16000 * 3) * 0.1).astype(np.float32)
    with pallas_interpret():
        jtexts, jspeech = jt.predict(wav, "s2st", "fra", max_unit_len=256)
        jenc = jt.generator._encode_speech_fn()(
            jt.params, *map(np.asarray, tt._audio_to_fbank(wav, 16000)))
        jtok, jlens, _ = jt.generator.generate_text(jenc, "fra")
    ttexts, tspeech = tt.predict(wav, "s2st", "fra", max_unit_len=256)
    # two conformer layers with ab over the padded frames, two FFT layers with
    # segment ids
    frames = tt._audio_to_fbank(wav, 16000)[0].shape[1] // 2
    assert frames >= 150
    assert fused_calls == [((1, 4, frames, 16), True, False)] * 2 + [
        ((1, 4, 256, 16), False, True)] * 2
    assert ttexts == jtexts
    res = tt.generator.last_result
    np.testing.assert_array_equal(res.lengths[:, 0].numpy(), jlens)
    np.testing.assert_array_equal(res.tokens[:, 0].numpy(), jtok)
    assert tspeech.units == jspeech.units and len(tspeech.units[0]) > 0
    for got, want in zip(tspeech.audio_wavs, jspeech.audio_wavs):
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=1e-5)


def test_t2tt_long_source_fused_matches_jax(translators, fused_calls):
    jt, tt = translators
    words = [w[1:] for w in WORDS if w.startswith("▁")]
    text = " ".join(np.random.default_rng(1).choice(words, 128))
    assert len(tt.text_tokenizer.encode_source(text, "eng")) >= 128
    with pallas_interpret():
        jtexts, _ = jt.predict(text, "t2tt", "fra", src_lang="eng")
    ttexts, _ = tt.predict(text, "t2tt", "fra", src_lang="eng")
    assert [c[1:] for c in fused_calls] == [(False, True)] * 2    # key padding only
    assert ttexts == jtexts
