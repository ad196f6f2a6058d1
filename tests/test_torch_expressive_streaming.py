"""The port's expressive streaming S2ST against the JAX package's, fp32 on
the CPU: ``build_expressive_s2st_pipeline`` over the tiny streaming models
of tests/test_torch_streaming.py and the tiny PRETSSEL of
tests/test_torch_pretssel.py; ``PretsselVocoderAgent`` alone (its prosody
input: the gcmvn-normalised fbank of the source audio received so far,
padded to 400 samples and bucketed to 128 frames) and
``DualVocoderAgent``'s switch.

Each mode against JAX's pipeline in the same mode on the same models: the
unfused pipeline on ``tiny_v2`` and on the chunk-causal encoder, the fused
re-encode on ``tiny_v2``, the incremental encoder on the chunk-causal one;
the fused and incremental modes also against the port's unfused pipeline
on their encoder, as JAX's own ``test_expressive_fused_matches_unfused``
holds its modes. Tokens, segments, units and ``finished`` flags identical, waveforms within
1e-4 (PRETSSEL's convolutions and LSTM of two libraries); decision
thresholds of 0.001, as the JAX streaming tests use, so that no decision
sits near a flip. The trees are drawn by the port's inits and laid out for
JAX by ``checkpoint/from_jax.py``'s ``*_to_numpy`` (JAX's eager draws would
cost most of this file's time); every random input comes from numpy's
seeded generators."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.models.monotonic.model import (
    MonotonicDecoderConfig as JMonoConfig,
)
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.models.unity.unit_tokenizer import (
    UnitTokenizer as JUnitTokenizer,
)
from seamless_communication_tpu.models.vocoder.codehifigan import (
    CodeHifiGanConfig as JVocConfig,
)
from seamless_communication_tpu.models.vocoder.hifigan import HifiGanConfig as JHifiGan
from seamless_communication_tpu.models.wav2vec2.encoder import (
    SpeechEncoderConfig as JSpeechConfig,
)
from seamless_communication_tpu.ops.conformer import ConformerConfig as JConformer
from seamless_communication_tpu.streaming import pipeline as jpipe
from seamless_communication_tpu.streaming.agents import common as jcommon
from seamless_communication_tpu.streaming.agents import online_vocoder as jonline_voc
from seamless_communication_tpu.streaming.agents import pretssel_vocoder as jagent

from seamless_communication_torch.checkpoint.from_jax import (
    monotonic_params_to_numpy, to_numpy, unity_params_to_numpy,
)
from seamless_communication_torch.models.monotonic.model import (
    MonotonicDecoderConfig, monotonic_decoder_init,
)
from seamless_communication_torch.models.unity import model as tunity
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.models.vocoder.codehifigan import (
    CodeHifiGanConfig, code_hifigan_init,
)
from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig
from seamless_communication_torch.models.wav2vec2.encoder import SpeechEncoderConfig
from seamless_communication_torch.ops.conformer import ConformerConfig
from seamless_communication_torch.streaming import pipeline
from seamless_communication_torch.streaming.agents import common
from seamless_communication_torch.streaming.agents import online_vocoder
from seamless_communication_torch.streaming.agents import pretssel_vocoder as tagent

from test_torch_pretssel import jcfg, make_pretssel, tcfg
from test_torch_streaming import (
    CHAR_SPM, CHUNK_CONF, CHUNK_SPEECH, HIFIGAN, LANG_SPKR, LANGS as TEXT_LANGS, MONO,
    TEXT_SPM, VOCODER, decoder, run,
)

WAV_TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tiny ops on one intra-op thread while the file runs: the
    suite runs six workers at once, and torch's default of a thread a core in
    each of them slows these files several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LANGS = {"eng": 0, "fra": 2}
EXPR_KW = dict(tgt_lang="eng", min_starting_wait_w2vbert=16, decision_threshold=0.001,
               min_unit_chunk_size=5)


@pytest.fixture(scope="module")
def models():
    """tests/test_torch_streaming.py's tiny models (``tiny_v2``, the same
    with the chunk-causal encoder, the monotonic decoder, the tiny unit
    vocoder, the toy tokenizers) for both packages."""
    from seamless_communication_tpu.text.char_tokenizer import (
        CharTokenizer as JCharTokenizer,
    )
    from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
    from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

    from seamless_communication_torch.text.char_tokenizer import CharTokenizer
    from seamless_communication_torch.text.nllb import NllbTokenizer
    from seamless_communication_torch.text.spm import SentencePieceModel

    gen = torch.Generator().manual_seed(12)
    cfg = get_arch("tiny_v2")
    chunk = dataclasses.replace(cfg, speech=SpeechEncoderConfig(
        conformer=ConformerConfig(**CHUNK_CONF), **CHUNK_SPEECH))
    voc_cfg = CodeHifiGanConfig(**VOCODER, hifigan=HifiGanConfig(**HIFIGAN))
    port = dict(cfg=cfg, chunk_cfg=chunk, unity=tunity.unity_init(gen, cfg),
                chunk_unity=tunity.unity_init(gen, chunk),
                mono=monotonic_decoder_init(gen, MonotonicDecoderConfig(**MONO)),
                mono_cfg=MonotonicDecoderConfig(**MONO),
                text=NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), TEXT_LANGS),
                units=UnitTokenizer(100, ["eng", "fra"], "base_v2"),
                chars=CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM)),
                voc=code_hifigan_init(gen, voc_cfg), voc_cfg=voc_cfg)
    jtree = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    jchunk = dataclasses.replace(jget_arch("tiny_v2"), speech=JSpeechConfig(
        conformer=JConformer(**CHUNK_CONF), **CHUNK_SPEECH))
    jax_side = dict(
        cfg=jget_arch("tiny_v2"), chunk_cfg=jchunk,
        unity=jtree(unity_params_to_numpy(port["unity"])),
        chunk_unity=jtree(unity_params_to_numpy(port["chunk_unity"])),
        mono=jtree(monotonic_params_to_numpy(port["mono"])), mono_cfg=JMonoConfig(**MONO),
        text=JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), TEXT_LANGS),
        units=JUnitTokenizer(100, ["eng", "fra"], "base_v2"),
        chars=JCharTokenizer(JSpm.from_bytes(CHAR_SPM)),
        voc=jtree(to_numpy(port["voc"])), voc_cfg=JVocConfig(**VOCODER,
                                                              hifigan=JHifiGan(**HIFIGAN)))
    return jax_side, port


@pytest.fixture(scope="module")
def pretssel():
    p, tp = make_pretssel(8)
    rng = np.random.default_rng(8)
    mean = rng.normal(10.0, 2.0, 80).astype(np.float32)
    std = rng.uniform(3.0, 5.0, 80).astype(np.float32)
    return p, tp, mean, std


def same_speech(got, want):
    """Segments as ``same_segments``, waveforms within 1e-4."""
    assert [(i, k, f) for i, k, _, f in got] == [(i, k, f) for i, k, _, f in want]
    for (_, kind, a, _), (_, _, b, _) in zip(got, want):
        if kind == "SpeechSegment":
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, **WAV_TOL)
        else:
            assert a == b


def _expressive(side: dict, build, p, cfg, mean, std, fused, arch, **kw):
    params = "unity" if arch == "cfg" else "chunk_unity"
    pipe = build(side[params], side[arch], side["mono"], side["mono_cfg"], side["text"],
                 side["units"], side["chars"], p, cfg, LANGS, mean, std, fused=fused,
                 **EXPR_KW, **kw)
    decoder(pipe).max_len_b = 10
    decoder(pipe).max_consecutive_writes = 5
    return pipe


@pytest.fixture(scope="module")
def unfused(models, pretssel):
    """The port's unfused expressive pipeline on each encoder: (pipeline,
    its segments)."""
    _, tm = models
    p, tp, mean, std = pretssel
    out = {}
    for arch in ("cfg", "chunk_cfg"):
        pipe = _expressive(tm, pipeline.build_expressive_s2st_pipeline, tp, tcfg(), mean,
                           std, False, arch, device="cpu")
        out[arch] = (pipe, run(pipe, pipeline.StreamingSession))
    return out


def matches_jax(models, pretssel, pipe, got, fused, arch):
    """JAX's pipeline in mode ``fused`` on encoder ``arch`` writes the
    tokens of ``pipe``, the port's, and emits ``got``, its segments."""
    jm, _ = models
    p, _, mean, std = pretssel
    jp = _expressive(jm, jpipe.build_expressive_s2st_pipeline, p, jcfg(), mean, std,
                     fused, arch)
    same_speech(got, run(jp, jpipe.StreamingSession))
    assert list(decoder(pipe).states.target_indices) == list(
        decoder(jp).states.target_indices)
    assert type(decoder(pipe)).__name__ == type(decoder(jp)).__name__


def test_expressive_pipeline_matches_jax(models, pretssel, unfused):
    """The unfused pipeline on ``tiny_v2``: JAX's segments, tokens, units,
    waveforms."""
    tp_, got = unfused["cfg"]
    matches_jax(models, pretssel, tp_, got, False, "cfg")
    speech = [c for _, k, c, _ in got if k == "SpeechSegment" and c.size]
    assert speech and got[-1][3]
    assert type(tp_.agents[-1]).__name__ == "PretsselVocoderAgent"
    assert set(tp_.agents[-1].last_timings) == {"vocoder"}


def test_expressive_chunk_pipeline_matches_jax(models, pretssel, unfused):
    """The unfused pipeline on the chunk-causal encoder (the incremental
    mode's baseline): JAX's segments, tokens, units, waveforms."""
    tp_, got = unfused["chunk_cfg"]
    matches_jax(models, pretssel, tp_, got, False, "chunk_cfg")
    assert any(k == "SpeechSegment" and c.size for _, k, c, _ in got)


@pytest.mark.parametrize("fused,arch", [(True, "cfg"), ("incremental", "chunk_cfg")])
def test_expressive_modes_match_unfused(models, pretssel, unfused, fused, arch):
    """The fused re-encode on ``tiny_v2`` and the incremental encoder on the
    chunk-causal one write the tokens and emit the segments, units and
    waveforms of JAX's pipeline in the same mode, and of the port's unfused
    pipeline."""
    _, tm = models
    _, tp, mean, std = pretssel
    pipe = _expressive(tm, pipeline.build_expressive_s2st_pipeline, tp, tcfg(), mean, std,
                       fused, arch, device="cpu")
    got = run(pipe, pipeline.StreamingSession)
    matches_jax(models, pretssel, pipe, got, fused, arch)
    base, want = unfused[arch]
    same_speech(got, want)
    assert list(decoder(pipe).states.target_indices) == list(
        decoder(base).states.target_indices)
    assert any(k == "SpeechSegment" and c.size for _, k, c, _ in got)
    assert type(decoder(pipe)).__name__.startswith(
        "IncrementalFused" if fused == "incremental" else "Fused")


def _agent_pair(pretssel, source):
    p, tp, mean, std = pretssel
    j = jagent.PretsselVocoderAgent(p, jcfg(), lang_to_index=LANGS, gcmvn_mean=mean,
                                    gcmvn_std=std, upstream_audio_getter=lambda: source)
    t = tagent.PretsselVocoderAgent(tp, tcfg(), lang_to_index=LANGS, gcmvn_mean=mean,
                                    gcmvn_std=std, upstream_audio_getter=lambda: source,
                                    device="cpu")
    return j, t


@pytest.mark.parametrize("n_source", [150, 9000])
def test_pretssel_agent(pretssel, n_source):
    """A unit chunk with repeats, then an unknown language (an empty
    segment), then the source's end; the source shorter than 400 samples
    (padded) and longer (the frames bucketed to 128). Another source audio
    (the prosody input) changes the waveform in both packages."""
    rng = np.random.default_rng(n_source)
    units = [5, 5, 9, 17, 17, 17, 3, 40, 41, 41]
    outs = []
    for source in ((rng.standard_normal(n_source) * 0.1).astype(np.float32),
                   (rng.standard_normal(n_source) * 0.5).astype(np.float32)):
        j, t = _agent_pair(pretssel, source)
        for lang, fin in (("fra", False), ("deu", False), ("eng", True)):
            for agent, mod in ((j, jcommon), (t, common)):
                agent.states.tgt_lang = None
                agent.push(mod.TextSegment(content=units, tgt_lang=lang, finished=fin))
            want, got = j.pop(), t.pop()
            assert got.finished == want.finished and got.tgt_lang == want.tgt_lang
            assert got.is_empty == want.is_empty
            np.testing.assert_allclose(np.asarray(got.content), np.asarray(want.content),
                                       **WAV_TOL)
            if lang == "fra":
                assert np.asarray(got.content).size > 0
                outs.append((np.asarray(want.content), np.asarray(got.content)))
            if lang == "deu":
                assert np.asarray(got.content).size == 0
    assert np.abs(outs[0][0] - outs[1][0]).max() > 1e-5
    assert np.abs(outs[0][1] - outs[1][1]).max() > 1e-5


def test_dual_vocoder_agent(models, pretssel):
    """The expressive agent for a language it supports, the unit vocoder
    otherwise or with ``expressive=False``; the same choice and output as
    JAX's."""
    jm, tm = models
    source = (np.random.default_rng(3).standard_normal(4000) * 0.1).astype(np.float32)
    j_pre, t_pre = _agent_pair(pretssel, source)
    j_voc = jonline_voc.VocoderAgent(jm["voc"], jm["voc_cfg"], lang_spkr_idx_map=LANG_SPKR)
    t_voc = online_vocoder.VocoderAgent(tm["voc"], tm["voc_cfg"],
                                        lang_spkr_idx_map=LANG_SPKR, device="cpu")
    for expressive, lang, want_cls in ((True, "fra", "PretsselVocoderAgent"),
                                       (True, "cmn", "VocoderAgent"),
                                       (False, "fra", "VocoderAgent")):
        jd = jagent.DualVocoderAgent(j_voc, j_pre, expressive=expressive)
        td = tagent.DualVocoderAgent(t_voc, t_pre, expressive=expressive)
        for d in (jd, td):
            d.reset()
        jd.push(jcommon.TextSegment(content=[7, 7, 8, 30], tgt_lang=lang, finished=True))
        td.push(common.TextSegment(content=[7, 7, 8, 30], tgt_lang=lang, finished=True))
        assert type(td._active(lang)).__name__ == type(jd._active(lang)).__name__ == want_cls
        want, got = jd.pop(), td.pop()
        assert got.finished == want.finished
        np.testing.assert_allclose(np.asarray(got.content, np.float32),
                                   np.asarray(want.content, np.float32), **WAV_TOL)


def test_pretssel_agent_clamps_units_past_the_table(pretssel):
    """Ids whose +4 offset leaves PRETSSEL's table (the language symbols a
    random unit decoder emits) take its last row, as JAX's gather clamps
    them: JAX's waveform, and another than with those ids left out."""
    source = (np.random.default_rng(5).standard_normal(6000) * 0.1).astype(np.float32)
    outs = []
    for units in ([5, 9, 200, 500, 9, 17, 500], [5, 9, 9, 17]):
        j, t = _agent_pair(pretssel, source)
        for agent, mod in ((j, jcommon), (t, common)):
            agent.push(mod.TextSegment(content=units, tgt_lang="fra", finished=True))
        want, got = np.asarray(j.pop().content), np.asarray(t.pop().content)
        assert got.shape == want.shape and got.size > 0
        np.testing.assert_allclose(got, want, **WAV_TOL)
        outs.append(got)
    assert outs[0].shape != outs[1].shape
