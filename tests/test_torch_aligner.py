"""The UnitY2 forced aligner in the port against the JAX package in fp32 on
the CPU, at a tiny width (embedding 16, unit features 32, 2 + 3 conv
layers): ``alignment_scores`` on a batch of two texts of different lengths,
the host ``monotonic_alignment_search``, ``aligner_forward`` at reduction
factors 1 and 2, the aligner ``.pt`` exporters, and ``AlignmentExtractor``
built from an exported ``.pt``, given units and given audio (through the
tiny XLSR encoder and k-means of ``test_torch_unit_extractor.py``).

Log-probs within 1e-5 (absolute; -inf at the same places), alignment paths
and durations identical. The weights come from the port's inits on seeded
generators; every other random input from numpy's seeded generators."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.checkpoint import fairseq_export as jexport
from seamless_communication_tpu.models.aligner import extractor as jex
from seamless_communication_tpu.models.aligner import model as jm
from seamless_communication_tpu.text.char_tokenizer import CharTokenizer as JCharTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

from seamless_communication_torch.checkpoint import fairseq_export as texport
from seamless_communication_torch.checkpoint.from_jax import to_numpy, to_torch
from seamless_communication_torch.models.aligner import extractor as tex
from seamless_communication_torch.models.aligner import model as tm
from seamless_communication_torch.models.unit_extractor import wav2vec2_raw as tw
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
)

from test_torch_unit_extractor import JCFG as JXLSR, TCFG as TXLSR

TINY = dict(embed_dim=16, feat_dim=32, text_vocab_size=48, unit_vocab_size=48,
            text_layers=2, feat_layers=3)
LPROB_TOL = dict(rtol=0, atol=1e-5)
CHAR_SPM = build_spm_model(
    [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL), ("</s>", 0.0, TYPE_CONTROL)]
    + [(c, -1.0, TYPE_NORMAL) for c in ["▁"] + list("abcdefghijklmnopqrstuvwxyz")])
TEXT = "the cat sat on a mat"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(rf: int = 1):
    return jm.AlignerConfig(**TINY, reduction_factor=rf), tm.AlignerConfig(**TINY,
                                                                          reduction_factor=rf)


@pytest.fixture(scope="module")
def trees():
    """One aligner tree in both packages' layouts, and text and unit ids of
    a batch of two (text lengths 12 and 7 of 12; units 30 and 23 of 30)."""
    np_tree = to_numpy(tm.aligner_init(torch.Generator().manual_seed(3), cfgs()[1]))
    rng = np.random.default_rng(2)
    return dict(np_tree=np_tree, jparams=jax.tree.map(jnp.asarray, np_tree),
                tparams=to_torch(np_tree),
                text=rng.integers(4, 40, (2, 12)), units=rng.integers(4, 44, (2, 30)),
                text_lens=np.array([12, 7]), feat_lens=np.array([30, 23]))


@pytest.mark.parametrize("rf", [1, 2])
def test_alignment_scores_match_jax(trees, rf):
    jcfg, tcfg = cfgs(rf)
    want = np.asarray(jax.jit(jm.alignment_scores, static_argnums=1)(
        trees["jparams"], jcfg, jnp.asarray(trees["text"], jnp.int32),
        jnp.asarray(trees["units"], jnp.int32), jnp.asarray(trees["text_lens"], jnp.int32)))
    got = tm.alignment_scores(trees["tparams"], tcfg, torch.from_numpy(trees["text"]),
                              torch.from_numpy(trees["units"]),
                              torch.from_numpy(trees["text_lens"])).numpy()
    assert got.shape == (2, 30 // rf, 12)
    assert np.isneginf(got[1, :, 7:]).all()
    np.testing.assert_allclose(got, want, **LPROB_TOL)


def test_monotonic_alignment_search_matches_jax():
    """The host dynamic program on random log-probs of several shapes (more
    features than characters, as many, fewer)."""
    rng = np.random.default_rng(4)
    for T_feat, T_text in ((40, 9), (9, 9), (6, 9), (1, 3)):
        lp = np.log(rng.dirichlet(np.ones(T_text), T_feat))
        np.testing.assert_array_equal(tm.monotonic_alignment_search(lp),
                                      jm.monotonic_alignment_search(lp))


@pytest.mark.parametrize("rf", [1, 2])
def test_aligner_forward_matches_jax(trees, rf):
    """Durations identical (each row's summing to its unit count, cut to it
    at rf = 2), log-probs within 1e-5."""
    jcfg, tcfg = cfgs(rf)
    want_lp, want_dur = jm.aligner_forward(
        trees["jparams"], jcfg, jnp.asarray(trees["text"], jnp.int32),
        jnp.asarray(trees["units"], jnp.int32), trees["text_lens"], trees["feat_lens"])
    got_lp, got_dur = tm.aligner_forward(trees["tparams"], tcfg, trees["text"], trees["units"],
                                         trees["text_lens"], trees["feat_lens"])
    np.testing.assert_array_equal(got_dur, want_dur)
    np.testing.assert_allclose(got_lp, want_lp, **LPROB_TOL)
    if rf == 1:
        np.testing.assert_array_equal(got_dur.sum(axis=1), trees["feat_lens"])
    assert (got_dur[1, 7:] == 0).all()


@pytest.mark.parametrize("source", ["units", "audio"])
def test_alignment_extractor_matches_jax(trees, tmp_path, source):
    """``AlignmentExtractor`` of both packages from one exported aligner
    ``.pt`` (the two exporters write the same file), on given units or on
    audio through the tiny XLSR ``.pt`` and a k-means ``.npy``: the same
    durations, log-probs within 1e-5."""
    jsd, tsd = jexport.export_aligner(trees["np_tree"]), texport.export_aligner(
        trees["tparams"])
    for part in jsd:
        assert set(jsd[part]) == set(tsd[part])
        for key in jsd[part]:
            assert torch.equal(jsd[part][key], tsd[part][key]), (part, key)
    aligner_pt = tmp_path / "aligner.pt"
    torch.save(tsd, aligner_pt)
    kw_j = dict(char_tokenizer=JCharTokenizer(JSpm.from_bytes(CHAR_SPM)),
                aligner_cfg=cfgs()[0], xlsr_cfg=JXLSR, output_layer=2)
    kw_t = dict(char_tokenizer=CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM)),
                aligner_cfg=cfgs()[1], xlsr_cfg=TXLSR, output_layer=2, device="cpu")
    rng = np.random.default_rng(6)
    if source == "units":
        audio = rng.integers(0, 40, 37).tolist()
        paths = ()
    else:
        xlsr_pt, km = tmp_path / "xlsr.pt", tmp_path / "kmeans.npy"
        torch.save({"model": texport.export_w2v2_raw(
            tw.wav2vec2_raw_init(torch.Generator().manual_seed(0), TXLSR))}, xlsr_pt)
        np.save(km, rng.standard_normal((24, TXLSR.model_dim)).astype(np.float32))
        audio = (rng.standard_normal(4000) * 0.3).astype(np.float32)
        paths = (str(xlsr_pt), str(km))
    want_dur, want_lp = jex.AlignmentExtractor(str(aligner_pt), *paths, **kw_j
                                               ).extract_alignment(audio, TEXT)
    ex = tex.AlignmentExtractor(str(aligner_pt), *paths, **kw_t)
    got_dur, got_lp = ex.extract_alignment(audio, TEXT)
    np.testing.assert_array_equal(got_dur, want_dur)
    np.testing.assert_allclose(got_lp, want_lp, **LPROB_TOL)
    n_units = 37 if source == "units" else 199
    assert got_dur.dtype == np.int32 and got_dur.sum() == n_units
    assert got_dur.shape == (1, len(ex.tokenize_text(TEXT)))
