"""The port's copies of the ETOX checker and of MinTox against the JAX
package: the same bad words found, the same word lists loaded from a
``<lang>_twl.txt`` directory, the same banned sequences built from words,
and the same MinTox outcome (offending items, bans handed to the re-run,
spliced texts and units)."""

import numpy as np
import pytest

from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm
from seamless_communication_tpu.toxicity import etox as jetox
from seamless_communication_tpu.toxicity import mintox as jmintox

from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
)
from seamless_communication_torch.toxicity import etox as tetox
from seamless_communication_torch.toxicity import mintox as tmintox

WORDS = {"eng": ["bad", "awful phrase", "Mean"], "fra": ["mechant"]}
PAIRS = [  # (source, target, source lang, target lang)
    ("hello", "you bad one", "eng", "eng"),
    ("bad src", "you bad", "eng", "eng"),
    ("clean text", "an AWFUL phrase here", "eng", "eng"),
    ("bonjour", "un mechant", "fra", "fra"),
    ("hello", "so mean", "eng", "fra"),
    ("hello", "nothing here", "eng", "eng"),
]
BASE = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL), ("</s>", 0.0, TYPE_CONTROL)]
SPM = build_spm_model(BASE + [(w, -5.0, TYPE_NORMAL) for w in
                              ["▁bad", "▁good", "▁text", "★", "▁", "bad", "▁awful",
                               "▁phrase", "▁BAD"]])


def test_etox_matches_jax():
    jc = jetox.ETOXBadWordChecker.from_word_lists(WORDS)
    tc = tetox.ETOXBadWordChecker.from_word_lists(WORDS)
    assert tc.bad_word_variants == jc.bad_word_variants
    for src, tgt, sl, tl in PAIRS:
        assert tc.extract_bad_words(src, tgt, sl, tl) == jc.extract_bad_words(src, tgt, sl, tl)
    assert tc.extract_bad_words("hello", "you bad one", "eng", "eng")
    with pytest.raises(RuntimeError, match="does not support"):
        tc.get_bad_words("text", "deu")


def test_load_etox_checker_matches_jax(tmp_path):
    (tmp_path / "eng_twl.txt").write_text("badword\nawful phrase\n")
    (tmp_path / "fra_twl.txt").write_text("mauvais\n")
    jc, tc = jetox.load_etox_checker(str(tmp_path)), tetox.load_etox_checker(str(tmp_path))
    assert tc.bad_words == jc.bad_words == {"eng": ["badword", "awful phrase"],
                                            "fra": ["mauvais"]}
    for text in ("a badword here", "an awful phrase", "clean text"):
        assert tc.get_bad_words(text, "eng") == jc.get_bad_words(text, "eng")


def test_mintox_pipeline_matches_jax():
    jtok = JNllbTokenizer(JSpm.from_bytes(SPM), langs=["__eng__"])
    ttok = NllbTokenizer(SentencePieceModel.from_bytes(SPM), langs=["__eng__"])
    words = ["bad", "BAD", "awful phrase"]
    ja, jl = jmintox.banned_sequences_from_words(jtok, words)
    ta, tl = tmintox.banned_sequences_from_words(ttok, words)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tl, jl)
    assert ta.shape[0] >= 3 and (ta[:, 0] == -1).any()       # right-aligned rows

    src = ["good text", "good text", "bad text"]
    tgt = ["good text", "bad text", "bad bad"]
    assert (tmintox.extract_bad_words_with_batch_indices(
        src, tgt, "eng", "eng", tetox.ETOXBadWordChecker.from_word_lists({"eng": ["bad"]}))
        == jmintox.extract_bad_words_with_batch_indices(
        src, tgt, "eng", "eng", jetox.ETOXBadWordChecker.from_word_lists({"eng": ["bad"]})))
    out = {}
    for name, mod, et, tok in (("jax", jmintox, jetox, jtok), ("port", tmintox, tetox, ttok)):
        calls = {}

        def rerun(indices, banned, calls=calls):
            calls["args"] = (list(indices), banned)
            return [f"clean {i}" for i in indices], [[i] for i in indices]

        res = mod.mintox_pipeline(
            checker=et.ETOXBadWordChecker.from_word_lists({"eng": ["bad"]}),
            text_tokenizer=tok, src_texts=src, original_texts=tgt,
            original_units=[[7], [8], [9]], src_lang="eng", tgt_lang="eng",
            rerun_fn=rerun)
        out[name] = (res, calls["args"])
    (jres, (ji, (jb, jbl))), (tres, (ti, (tb, tbl))) = out["jax"], out["port"]
    assert tres == jres == (["good text", "clean 1", "bad bad"], [[7], [1], [9]])
    assert ti == ji == [1]
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tbl, jbl)
