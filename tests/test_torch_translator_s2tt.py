"""The port's ``Translator`` against the JAX ``Translator`` on ``tiny_v2``:
the same parameters (carried across by ``checkpoint/from_jax.py``), the same
toy SentencePiece model as tests/integration/conftest.py, beam 2, max 16, on
one seeded waveform. Tokens and decoded texts must be identical, with the
int8 KV cache and with the fp one."""

import numpy as np
import pytest
import torch

import jax

from seamless_communication_tpu.inference.generator import (
    SequenceGeneratorOptions as JOptions,
)
from seamless_communication_tpu.inference.translator import Translator as JTranslator
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

from seamless_communication_torch.checkpoint.from_jax import unity_params_from_jax
from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
from seamless_communication_torch.inference.translator import Translator
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
)

WORDS = ["▁the", "▁cat", "▁sat", "▁on", "▁mat", "▁a", "▁dog", ".", ",",
         "▁he", "llo", "▁wor", "ld"]
CHARS = ["▁"] + list("abcdefghijklmnopqrstuvwxyz.,")
LANGS = ["__eng__", "__fra__"]


def _spm_bytes():
    base = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
            ("</s>", 0.0, TYPE_CONTROL)]
    return build_spm_model(base + [(w, -float(20 - len(w)), TYPE_NORMAL) for w in WORDS]
                           + [(c, -30.0, TYPE_NORMAL) for c in CHARS])


@pytest.fixture(scope="module")
def models():
    jparams = junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))
    tparams = unity_params_from_jax(jax.tree.map(np.asarray, jparams))
    blob = _spm_bytes()
    return (jparams, JNllbTokenizer(JSpm.from_bytes(blob), langs=LANGS),
            tparams, NllbTokenizer(SentencePieceModel.from_bytes(blob), langs=LANGS))


@pytest.fixture(scope="module")
def wav():
    return (np.random.default_rng(0).standard_normal(16000 * 3) * 0.1).astype(np.float32)


def test_tokenizer_is_a_faithful_copy(models):
    """Against the JAX package's Python Viterbi path, its parity reference.
    (Its native encoder resolves the toy model's duplicate pieces "." and ","
    to the first entry, the Python path to the last.)"""
    _, jtok, _, ttok = models
    for text in ("the cat sat on a mat.", "hello world, dog", "zebra ü"):
        assert ttok.spm.encode(text) == jtok.spm._encode_python(jtok.spm._normalize(text))
        ids = ttok.encode_target(text, "fra")
        assert ttok.decode(ids) == jtok.decode(ids)
    assert ttok.vocab_info.size == jtok.vocab_info.size


@pytest.mark.parametrize("task", ["s2tt", "asr"])
@pytest.mark.parametrize("kv_int8", [True, False])
def test_translator_matches_jax(models, wav, kv_int8, task):
    jparams, jtok, tparams, ttok = models
    kw = dict(beam_size=2, soft_max_seq_len=(0, 16), hard_max_seq_len=16,
              kv_cache_int8=kv_int8)
    jt = JTranslator(jparams, jget_arch("tiny_v2"), jtok, text_opts=JOptions(**kw))
    tt = Translator(tparams, get_arch("tiny_v2"), ttok,
                    text_opts=SequenceGeneratorOptions(**kw), device="cpu")
    jtexts, _ = jt.predict(wav, task, "fra", src_lang="eng")
    ttexts, speech = tt.predict(wav, task, "fra", src_lang="eng")
    assert speech is None and ttexts == jtexts

    # tokens of the same search, via the generators
    fb, fl = tt._audio_to_fbank(wav, 16000)
    from seamless_communication_torch.models.unity import model as tunity
    import jax.numpy as jnp
    jenc = jt.generator._encode_speech_fn()(jparams, jnp.asarray(fb), jnp.asarray(fl))
    tenc = tunity.encode_speech(tt.params, tt.cfg, torch.from_numpy(fb),
                                torch.from_numpy(fl))
    lang = "eng" if task == "asr" else "fra"
    jtok_ids, jlens, _ = jt.generator.generate_text(jenc, lang)
    ttok_ids, tlens, _ = tt.generator.generate_text(tenc, lang)
    np.testing.assert_array_equal(tlens, jlens)
    np.testing.assert_array_equal(ttok_ids, jtok_ids)


def test_other_tasks_name_their_slice(models, wav):
    """The text-input tasks are ported (tests/test_torch_translator_t2t.py)
    and, as in the JAX package, need the source language; an unknown task
    raises."""
    _, _, tparams, ttok = models
    tt = Translator(tparams, get_arch("tiny_v2"), ttok, device="cpu")
    for task in ("t2st", "t2tt"):
        with pytest.raises(ValueError, match="src_lang required"):
            tt.predict("the cat sat", task, "fra")
    with pytest.raises(ValueError, match="unknown task"):
        tt.predict(wav, "s2xx", "fra")
