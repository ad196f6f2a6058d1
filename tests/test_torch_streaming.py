"""The port's SeamlessStreaming pipelines against the JAX package's, fp32 on
the CPU, with the tiny models of tests/integration/test_streaming_tiny.py
(``tiny_v2`` UnitY, a monotonic decoder of dim 64, 2 layers, 4 heads, vocab
256, the tiny unit vocoder) carried across by ``checkpoint/from_jax.py``, and
its 2 s waveform streamed in 320 ms chunks through ``StreamingSession``.

S2T with ``fused=False``, ``True`` and ``"incremental"`` (the latter on the
JAX test's chunk-causal encoder) must write JAX's tokens exactly, with
decision thresholds of 0.001 as the JAX tests use, and emit the same output
segments in the same order with the same ``finished`` flags. So must S2ST,
linear and tree, re-encoding and unfused, unit for unit, with waveforms
within 1e-5 (convolutions of two libraries summed in different orders); so
must the unfused step-by-step policy (``no_early_stop``, ``block_ngrams``)
and the int8 EMMA decoder."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from seamless_communication_tpu.models.monotonic.model import (
    MonotonicDecoderConfig as JMonoConfig, monotonic_decoder_init as jmono_init,
)
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.models.unity.unit_tokenizer import (
    UnitTokenizer as JUnitTokenizer,
)
from seamless_communication_tpu.models.vocoder.codehifigan import (
    CodeHifiGanConfig as JVocConfig, code_hifigan_init as jvoc_init,
)
from seamless_communication_tpu.models.vocoder.hifigan import HifiGanConfig as JHifiGan
from seamless_communication_tpu.models.wav2vec2.encoder import (
    SpeechEncoderConfig as JSpeechConfig,
)
from seamless_communication_tpu.ops.conformer import ConformerConfig as JConformer
from seamless_communication_tpu.streaming import pipeline as jpipe
from seamless_communication_tpu.streaming.agents import common as jcommon
from seamless_communication_tpu.streaming.agents import detokenizer as jdetok
from seamless_communication_tpu.streaming.agents import (
    offline_w2v_bert_encoder as jencoder_agent,
)
from seamless_communication_tpu.streaming.agents import online_feature_extractor as jfeat
from seamless_communication_tpu.streaming.agents import online_text_decoder as jtext
from seamless_communication_tpu.text.char_tokenizer import CharTokenizer as JCharTokenizer
from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

from seamless_communication_torch.checkpoint.from_jax import (
    monotonic_params_from_jax, to_torch, unity_params_from_jax,
)
from seamless_communication_torch.models.monotonic.model import MonotonicDecoderConfig
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.models.vocoder.codehifigan import CodeHifiGanConfig
from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig
from seamless_communication_torch.models.wav2vec2.encoder import SpeechEncoderConfig
from seamless_communication_torch.ops.conformer import ConformerConfig
from seamless_communication_torch.streaming import pipeline
from seamless_communication_torch.streaming.agents import common, detokenizer
from seamless_communication_torch.streaming.agents import offline_w2v_bert_encoder
from seamless_communication_torch.streaming.agents import online_feature_extractor
from seamless_communication_torch.streaming.agents import online_text_decoder
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
)

BASE = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
        ("</s>", 0.0, TYPE_CONTROL)]
WORDS = ["▁aa", "▁bb", "▁cc", ",", "."]
CHARS = ["▁"] + list("abc.,")
TEXT_SPM = build_spm_model(BASE + [(w, -2.0, TYPE_NORMAL) for w in WORDS]
                           + [(c, -10.0, TYPE_NORMAL) for c in CHARS])
CHAR_SPM = build_spm_model(BASE + [(c, -1.0, TYPE_NORMAL) for c in CHARS])
LANGS = ["__eng__", "__fra__"]
MONO = dict(model_dim=64, num_layers=2, num_heads=4, ffn_inner_dim=128, vocab_size=256,
            num_monotonic_energy_layers=2, pre_decision_ratio=2)
VOCODER = dict(num_units=100, unit_embed_dim=32, num_langs=4, lang_embed_dim=8,
               num_spkrs=4, spkr_embed_dim=8, dur_predictor_hidden=16)
HIFIGAN = dict(model_in_dim=48, upsample_initial_channel=32, upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),))
LANG_SPKR = {"multilingual": {"eng": 0}, "multispkr": {"eng": [0]}}
# the JAX incremental test's chunk-causal encoder
CHUNK_CONF = dict(dim=64, ffn_inner_dim=128, num_heads=4, num_layers=2,
                  depthwise_kernel_size=7, pos_type="shaw", shaw_max_left=8,
                  shaw_max_right=3, causal_depthwise_conv=True)
CHUNK_SPEECH = dict(model_dim=64, feature_dim=160, ffn_inner_dim=128, num_adaptor_heads=4,
                    chunk_size=4, left_chunk_num=-1)
KW = dict(tgt_lang="eng", min_starting_wait_w2vbert=16, decision_threshold=0.001,
          max_len_b=12, max_consecutive_writes=6)
S2ST_KW = dict(KW, min_unit_chunk_size=5, text_bucket=32)
WAV = (0.1 * np.sin(2 * np.pi * 300 * np.arange(32000) / 16000)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg = jget_arch("tiny_v2")
    jchunk = dataclasses.replace(jcfg, speech=JSpeechConfig(
        conformer=JConformer(**CHUNK_CONF), **CHUNK_SPEECH))
    chunk = dataclasses.replace(get_arch("tiny_v2"), speech=SpeechEncoderConfig(
        conformer=ConformerConfig(**CHUNK_CONF), **CHUNK_SPEECH))
    jparams = junity.unity_init(jax.random.PRNGKey(0), jcfg)
    jchunk_params = junity.unity_init(jax.random.PRNGKey(3), jchunk)
    jmono = jmono_init(jax.random.PRNGKey(5), JMonoConfig(**MONO))
    jvcfg = JVocConfig(**VOCODER, hifigan=JHifiGan(**HIFIGAN))
    jvoc = jvoc_init(jax.random.PRNGKey(6), jvcfg)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    jax_side = dict(
        cfg=jcfg, chunk_cfg=jchunk, unity=jparams, chunk_unity=jchunk_params, mono=jmono,
        mono_cfg=JMonoConfig(**MONO), text=JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), LANGS),
        units=JUnitTokenizer(100, ["eng", "fra"], "base_v2"),
        chars=JCharTokenizer(JSpm.from_bytes(CHAR_SPM)), voc=jvoc, voc_cfg=jvcfg)
    port = dict(
        cfg=get_arch("tiny_v2"), chunk_cfg=chunk,
        unity=unity_params_from_jax(np_tree(jparams)),
        chunk_unity=unity_params_from_jax(np_tree(jchunk_params)),
        mono=monotonic_params_from_jax(np_tree(jmono)),
        mono_cfg=MonotonicDecoderConfig(**MONO),
        text=NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), LANGS),
        units=UnitTokenizer(100, ["eng", "fra"], "base_v2"),
        chars=CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM)),
        voc=to_torch(np_tree(jvoc)),
        voc_cfg=CodeHifiGanConfig(**VOCODER, hifigan=HifiGanConfig(**HIFIGAN)))
    return jax_side, port


def run(pipe, session_cls, wav=WAV):
    """The output segments of a session: (chunk, kind, content, finished)."""
    out = []
    for i, seg in session_cls(pipe, segment_size_ms=320, tgt_lang="eng").run(wav):
        kind = type(seg).__name__
        content = seg.content
        if kind == "SpeechSegment":
            content = np.asarray(content, np.float32)
        elif content is not None and not isinstance(content, str):
            content = [str(u) for u in np.asarray(content).reshape(-1)]
        out.append((i, kind, content, bool(seg.finished)))
    return out


def same_segments(got, want):
    assert [(i, k, f) for i, k, _, f in got] == [(i, k, f) for i, k, _, f in want]
    for (_, kind, a, _), (_, _, b, _) in zip(got, want):
        if kind == "SpeechSegment":
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        else:
            assert a == b


def decoder(pipe):
    agents = pipe.agents
    return next(a for a in agents if hasattr(a, "decision_threshold"))


S2T_MODES = [(False, "cfg"), (True, "cfg"), ("incremental", "chunk_cfg"),
             (True, "chunk_cfg")]


@pytest.mark.parametrize("fused,arch", S2T_MODES)
def test_s2t_matches_jax(models, fused, arch):
    """The incremental agent on the chunk-causal encoder against JAX's
    incremental agent; the re-encoding agent on it against JAX's too."""
    jm, tm = models
    params = "unity" if arch == "cfg" else "chunk_unity"
    jp = jpipe.build_s2t_pipeline(jm[params], jm[arch], jm["mono"], jm["mono_cfg"],
                                  jm["text"], fused=fused, **KW)
    tp = pipeline.build_s2t_pipeline(tm[params], tm[arch], tm["mono"], tm["mono_cfg"],
                                     tm["text"], fused=fused, device="cpu", **KW)
    want, got = run(jp, jpipe.StreamingSession), run(tp, pipeline.StreamingSession)
    same_segments(got, want)
    jtoks = list(decoder(jp).states.target_indices)
    assert list(decoder(tp).states.target_indices) == jtoks and len(jtoks) > 0
    assert got[-1][3]
    counts = decoder(tp).policy_counts
    assert counts["write"] > 0 and counts["tokens"] == len(jtoks)
    assert len(decoder(tp).decision_stats) > 0


def test_incremental_equals_reencode(models):
    """On the chunk-causal encoder the port's incremental agent writes the
    port's re-encoding agent's tokens."""
    _, tm = models
    toks = {}
    for fused in (True, "incremental"):
        tp = pipeline.build_s2t_pipeline(tm["chunk_unity"], tm["chunk_cfg"], tm["mono"],
                                         tm["mono_cfg"], tm["text"], fused=fused,
                                         device="cpu", **KW)
        run(tp, pipeline.StreamingSession)
        toks[fused] = list(decoder(tp).states.target_indices)
    assert toks["incremental"] == toks[True] and len(toks[True]) > 0
    assert pipeline._resolve_fused("auto", tm["chunk_cfg"]) == "incremental"
    assert pipeline._resolve_fused("auto", tm["cfg"]) is True


@pytest.mark.parametrize("kind", ["linear", "tree"])
@pytest.mark.parametrize("fused", [False, True])
def test_s2st_matches_jax(models, kind, fused):
    jm, tm = models
    jbuild = {"linear": jpipe.build_s2st_pipeline,
              "tree": jpipe.build_s2st_tree_pipeline}[kind]
    tbuild = {"linear": pipeline.build_s2st_pipeline,
              "tree": pipeline.build_s2st_tree_pipeline}[kind]
    jp = jbuild(jm["unity"], jm["cfg"], jm["mono"], jm["mono_cfg"], jm["text"],
                jm["units"], jm["chars"], jm["voc"], jm["voc_cfg"], LANG_SPKR,
                fused=fused, **S2ST_KW)
    tp = tbuild(tm["unity"], tm["cfg"], tm["mono"], tm["mono_cfg"], tm["text"],
                tm["units"], tm["chars"], tm["voc"], tm["voc_cfg"], LANG_SPKR,
                fused=fused, device="cpu", **S2ST_KW)
    want, got = run(jp, jpipe.StreamingSession), run(tp, pipeline.StreamingSession)
    same_segments(got, want)
    assert sum(c.size for _, k, c, _ in got if k == "SpeechSegment") > 0
    assert tp.finished and jp.finished
    unit_dec = next(a for a in tp.agents if type(a).__name__ == "NARUnitYUnitDecoderAgent")
    junit_dec = next(a for a in jp.agents if type(a).__name__ == "NARUnitYUnitDecoderAgent")
    assert unit_dec.states.source_token_list == junit_dec.states.source_token_list
    assert list(decoder(tp).states.target_indices) == list(
        decoder(jp).states.target_indices)


@pytest.mark.parametrize("option", ["no_early_stop", "block_ngrams"])
def test_step_by_step_policy_matches_jax(models, option):
    """The unfused agents' step-by-step loop (taken for these options)."""
    jm, tm = models

    def agents(mod_feat, mod_enc, mod_text, mod_detok, side, **dev):
        return [mod_feat.OnlineFeatureExtractorAgent(),
                mod_enc.OfflineWav2VecBertEncoderAgent(side["unity"], side["cfg"],
                                                       min_starting_wait=16, **dev),
                mod_text.MMASpeechToTextDecoderAgent(
                    side["mono"], side["mono_cfg"], side["text"], max_len_b=12,
                    max_consecutive_writes=6, decision_threshold=0.001,
                    **{option: True}, **dev),
                mod_detok.DetokenizerAgent()]

    jp = jcommon.AgentPipeline(agents(jfeat, jencoder_agent, jtext, jdetok, jm))
    tp = common.AgentPipeline(agents(online_feature_extractor, offline_w2v_bert_encoder,
                                     online_text_decoder, detokenizer, tm, device="cpu"))
    want, got = run(jp, jpipe.StreamingSession), run(tp, pipeline.StreamingSession)
    same_segments(got, want)
    assert tp.agents[2].states.target_indices == jp.agents[2].states.target_indices
    assert len(tp.agents[2].states.target_indices) > 0


@pytest.mark.parametrize("fused", [True, "incremental"])
def test_int8_mono_matches_jax(models, fused):
    """The EMMA decoder int8 weight-only in both packages (the tiny tables
    quantized with ``min_size=1``; the builders' default keeps tables this
    small fp). The incremental agent's encoder state keeps the UnitY tree's
    float dtype."""
    from seamless_communication_tpu.ops.quantization import quantize_params as jquantize

    from seamless_communication_torch.ops.quantization import quantize_params

    jm, tm = models
    arch, params = ("cfg", "unity") if fused is True else ("chunk_cfg", "chunk_unity")
    kw = dict(KW, decision_threshold=0.4, mono_quantize_int8=False)
    jmono, mono = jquantize(jm["mono"], min_size=1), quantize_params(tm["mono"], min_size=1)
    jp = jpipe.build_s2t_pipeline(jm[params], jm[arch], jmono, jm["mono_cfg"], jm["text"],
                                  fused=fused, **kw)
    tp = pipeline.build_s2t_pipeline(tm[params], tm[arch], mono, tm["mono_cfg"],
                                     tm["text"], fused=fused, device="cpu", **kw)
    assert "weight_i8" in decoder(tp).params["layers"][0]["ffn"]["inner_proj"]
    assert "embedding_i8" in decoder(tp).params["embed"]
    want, got = run(jp, jpipe.StreamingSession), run(tp, pipeline.StreamingSession)
    same_segments(got, want)
    assert list(decoder(tp).states.target_indices) == list(
        decoder(jp).states.target_indices)
    assert got[-1][3]


def test_quantize_auto_and_expressive(models):
    """``mono_quantize_int8=None`` leaves a CPU tree as it is, ``True``
    quantizes it; the expressive pipeline puts the VAD agent first with
    ``use_vad=True`` and only then (the pipelines themselves:
    tests/test_torch_expressive_streaming.py, tests/test_torch_evaluation.py)."""
    _, tm = models
    tp = pipeline.build_s2t_pipeline(tm["unity"], tm["cfg"], tm["mono"], tm["mono_cfg"],
                                     tm["text"], device="cpu", **KW)
    assert "weight" in decoder(tp).params["layers"][0]["ffn"]["inner_proj"]
    for use_vad in (True, False):
        ep = pipeline.build_expressive_s2st_pipeline(
            tm["unity"], tm["cfg"], tm["mono"], tm["mono_cfg"], tm["text"], tm["units"],
            tm["chars"], {}, None, {}, np.zeros(80), np.ones(80), use_vad=use_vad,
            device="cpu")
        names = [type(a).__name__ for a in ep.agents]
        assert names[:1 + use_vad] == ["VADAgent"] * use_vad + ["OnlineFeatureExtractorAgent"]
        assert names.count("VADAgent") == use_vad and names[-1] == "PretsselVocoderAgent"
    assert torch.equal(decoder(tp).params["embed"]["embedding"],
                       tm["mono"]["embed"]["embedding"])
    quantized = pipeline._maybe_quantize_mono(
        {"layers": [{"ffn": {"inner_proj": {"weight": torch.ones(256, 256)}}}]}, None)
    assert "weight" in quantized["layers"][0]["ffn"]["inner_proj"]
    quantized = pipeline._maybe_quantize_mono(
        {"layers": [{"ffn": {"inner_proj": {"weight": torch.ones(256, 256)}}}]}, True)
    assert "weight_i8" in quantized["layers"][0]["ffn"]["inner_proj"]


def test_unit_tokenizer_streaming_arch():
    """The ``streaming`` arch's T2U is v2's NAR one: the port's unit
    tokenizer decodes as JAX's ``base_v2`` one does (JAX's copy would take
    the arch name for an AR arch; its streaming card says base_v2)."""
    units = np.array([[7, 20, 2, 1, 104]])
    got = UnitTokenizer(100, ["eng"], "streaming")
    assert got.is_nar_decoder and not JUnitTokenizer(100, ["eng"], "streaming").is_nar_decoder
    np.testing.assert_array_equal(got.decode(units),
                                  JUnitTokenizer(100, ["eng"], "base_v2").decode(units))
