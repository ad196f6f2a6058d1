"""The port's ``Translator`` options around the text decode against the JAX
``Translator`` on ``tiny_v2``, with the char tokenizer and the tiny unit
HiFi-GAN of tests/test_torch_translator_s2st.py and a text vocabulary of 40
seeded words in six forms each, so that the random model's outputs decode to
words (the same
parameters carried across by ``checkpoint/from_jax.py``; beam 2, max 16,
int8 KV):

- MinTox (``apply_mintox=True``) on T2TT (eng -> eng) and on S2ST (-> eng,
  with the ASR of the speech input in fra as the source text, and a ban of
  the caller's that MinTox merges with its own): the ETOX word
  list names a word of the JAX Translator's first output that its source
  lacks, so both re-run with the same banned rows and leave the word out;
  final texts and units identical, waveforms within 1e-5 absolute (fp32
  convolutions of two libraries, then a tanh);
- ``FbankInput``: precomputed raw log-mels of a batch with a 0-length item,
  under both ``normalize_fbank`` modes: identical texts;
- ``apply_mintox`` without a checker raises."""

import re

import numpy as np
import pytest

import jax

from seamless_communication_tpu.audio.fbank import fbank_numpy as j_fbank_numpy
from seamless_communication_tpu.inference.generator import (
    SequenceGeneratorOptions as JOptions,
)
from seamless_communication_tpu.inference.translator import (
    FbankInput as JFbankInput, Translator as JTranslator,
)
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
from seamless_communication_tpu.toxicity.etox import (
    ETOXBadWordChecker as JETOXBadWordChecker,
)

from seamless_communication_torch.checkpoint.from_jax import (
    to_torch, unity_params_from_jax,
)
from seamless_communication_torch.audio.fbank import fbank_numpy
from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
from seamless_communication_torch.inference.translator import FbankInput, Translator
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.models.vocoder.codehifigan import CodeHifiGanConfig
from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import (
    TYPE_NORMAL, SentencePieceModel, build_spm_model,
)
from seamless_communication_torch.toxicity.etox import ETOXBadWordChecker

from tests.test_torch_translator_s2st import (
    BASE, CHAR_SPM, HIFIGAN, LANG_SPKR, LANGS, VOCODER,
)


def _words_vocabulary(n: int = 40) -> list:
    rng = np.random.default_rng(0)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    return sorted({"".join(rng.choice(letters, rng.integers(3, 7)))
                   for _ in range(n + 10)})[:n]


WORDS = _words_vocabulary()
# each word in the three cases of an ETOX word list's variants, after a word
# boundary and after a "★" (MinTox's mid-word form: "★word" encodes to the
# boundary and that piece, and MinTox drops the first): every piece decodes
# to a word ETOX sees, and every banned row is one token long, so the JAX
# package's processor enforces all of them (it enforces only the rows of the
# longest length, ROADMAP Queue 3)
TEXT_SPM = build_spm_model(
    BASE + [("\u2581", -2.0, TYPE_NORMAL)]
    + [(b + c, -2.0, TYPE_NORMAL) for w in WORDS
       for c in (w, w.upper(), w.capitalize()) for b in ("\u2581", "\u2605")])
OPTS = dict(beam_size=2, soft_max_seq_len=(0, 16), hard_max_seq_len=16,
            kv_cache_int8=True)
TEXT = " ".join(WORDS[:6])


@pytest.fixture(scope="module")
def translators():
    """A pair of Translator factories, JAX and port, over the same weights;
    ``kw`` goes to both constructors (the checkers are built per package)."""
    jparams = junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))
    jvcfg = JCodeHifiGanConfig(**VOCODER, hifigan=JHifiGanConfig(**HIFIGAN))
    jvoc = j_code_hifigan_init(jax.random.PRNGKey(1), jvcfg)
    tparams = unity_params_from_jax(jax.tree.map(np.asarray, jparams))
    tvoc = to_torch(jax.tree.map(np.asarray, jvoc))

    def jax_translator(**kw):
        return JTranslator(jparams, jget_arch("tiny_v2"),
                           JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS),
                           JUnitTokenizer(100, ["eng", "fra"], "base_v2"),
                           JCharTokenizer(JSpm.from_bytes(CHAR_SPM)), vocoder_params=jvoc,
                           vocoder_cfg=jvcfg, lang_spkr_idx_map=LANG_SPKR,
                           text_opts=JOptions(**OPTS), **kw)

    def port_translator(**kw):
        return Translator(tparams, get_arch("tiny_v2"),
                          NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS),
                          UnitTokenizer(100, ["eng", "fra"], "base_v2"),
                          CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM)),
                          vocoder_params=tvoc,
                          vocoder_cfg=CodeHifiGanConfig(**VOCODER,
                                                        hifigan=HifiGanConfig(**HIFIGAN)),
                          lang_spkr_idx_map=LANG_SPKR,
                          text_opts=SequenceGeneratorOptions(**OPTS), device="cpu", **kw)

    return jax_translator, port_translator


def _wav(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


def _words(text):
    return re.sub(r"[\W+]", " ", text.lower()).split()


@pytest.mark.parametrize("task", ["t2tt", "s2st"])
def test_mintox_matches_jax(translators, task):
    jax_translator, port_translator = translators
    plain = jax_translator()
    if task == "t2tt":
        inp, kw = TEXT, dict(src_lang="eng")
        source = TEXT
    else:
        # a caller's 1-token ban, which MinTox merges with its own rows
        ban = np.asarray([plain.text_tokenizer.encode(WORDS[-1])], np.int32)
        inp, kw = _wav(1.5, 5), dict(src_lang="fra",
                                     banned_sequences=(ban, np.array([1], np.int32)))
        source = plain.predict(inp, "asr", "fra", src_lang="fra")[0][0]
    first = plain.predict(inp, task, "eng", **kw)[0][0]
    added = [w for w in _words(first) if w not in _words(source)]
    assert added, (first, source)
    lists = {"eng": [added[0]], "fra": [added[0]]}
    jt = jax_translator(apply_mintox=True,
                        etox_checker=JETOXBadWordChecker.from_word_lists(lists))
    tt = port_translator(apply_mintox=True,
                         etox_checker=ETOXBadWordChecker.from_word_lists(lists))
    bans = {}
    for name, tr in (("jax", jt), ("port", tt)):
        def spy(enc, lang, banned=None, _orig=tr.generator.generate_text, _n=name, **k):
            if banned is not None:
                bans[_n] = banned
            return _orig(enc, lang, banned=banned, **k)
        tr.generator.generate_text = spy
    jtexts, jspeech = jt.predict(inp, task, "eng", **kw)
    ttexts, tspeech = tt.predict(inp, task, "eng", **kw)
    assert ttexts == jtexts and ttexts[0] != first
    assert added[0] not in _words(ttexts[0])
    assert set(tt.last_mintox_timings) == ({"rerun"} if task == "t2tt"
                                           else {"asr", "rerun"})
    for got, want in zip(bans["port"], bans["jax"]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert len(bans["port"][1]) > (1 if task == "s2st" else 0)
    if task == "s2st":
        assert tspeech.units == jspeech.units and len(tspeech.units[0]) > 0
        for got, want in zip(tspeech.audio_wavs, jspeech.audio_wavs):
            assert got.shape == np.asarray(want).shape
            np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                                       atol=1e-5)


def test_fbank_input_matches_jax(translators):
    """Raw log-mels of a 2 s and a 1.2 s waveform and a corrupted (0-length)
    item, under both normalizations; the port's host fbank is the JAX
    package's."""
    jax_translator, port_translator = translators
    jt, tt = jax_translator(), port_translator()
    feats = [fbank_numpy(_wav(2.0, 6)), fbank_numpy(_wav(1.2, 7))]
    np.testing.assert_array_equal(feats[1], j_fbank_numpy(_wav(1.2, 7)))
    fb = np.zeros((3, feats[0].shape[0], 80), np.float32)
    for i, f in enumerate(feats):
        fb[i, :f.shape[0]] = f
    lens = np.array([feats[0].shape[0], feats[1].shape[0], 0], np.int32)
    seen = []
    for mode in ("utterance", "per_mel_bin"):
        jt.normalize_fbank = tt.normalize_fbank = mode
        jtexts, _ = jt.predict(JFbankInput(fb, lens), "s2tt", "eng")
        ttexts, _ = tt.predict(FbankInput(fb, lens), "s2tt", "eng")
        assert ttexts == jtexts and len(ttexts) == 3
        seen.append(ttexts)
    assert seen[0] != seen[1]                # the normalization reaches the model


def test_apply_mintox_needs_a_checker(translators):
    _, port_translator = translators
    with pytest.raises(ValueError, match="etox_checker"):
        port_translator(apply_mintox=True)
