"""Streaming agent pipelines and the session that drives them (counterpart
of ``seamless_communication_tpu/streaming/pipeline.py``): the feature
extractor, the speech encoder, the EMMA text decoder, then the detokenizer
(S2TT) or the NAR unit decoder and the vocoder (S2ST), or both as a tree;
SeamlessExpressive's S2ST ends in the PRETSSEL vocoder agent instead, whose
prosody input is the source audio received so far.

``fused`` picks the encoder and decoder agents: ``False`` the separate
encoder and decoder agents of the reference (needed for ``no_early_stop`` and
``block_ngrams``), ``True`` the fused agent that re-encodes the fbank prefix
each chunk, ``"incremental"`` the fused agent over the incremental encoder
(exact for a chunk-causal encoder only), ``"auto"`` (the default) the
incremental one where the encoder is chunk-causal, else ``True``.

The builders move the parameters to ``device`` (the CUDA card unless the
caller passes ``device="cpu"``; without a card and without ``"cpu"`` they
raise). ``mono_quantize_int8=None`` makes the monotonic decoder int8
weight-only where its parameters are on a CUDA device, and leaves it as it is
on the CPU (the JAX package's "on for TPU backends").
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.models.monotonic.model import MonotonicDecoderConfig
from seamless_communication_torch.models.pretssel.vocoder import PretsselConfig
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.models.vocoder.codehifigan import CodeHifiGanConfig
from seamless_communication_torch.ops.quantization import quantize_params
from seamless_communication_torch.streaming.agents.common import (
    AgentPipeline, EmptySegment, SpeechSegment, TreeAgentPipeline,
)
from seamless_communication_torch.streaming.agents.detokenizer import (
    DetokenizerAgent, UnitYDetokenizerAgent,
)
from seamless_communication_torch.streaming.agents.offline_w2v_bert_encoder import (
    OfflineWav2VecBertEncoderAgent,
)
from seamless_communication_torch.streaming.agents.online_feature_extractor import (
    OnlineFeatureExtractorAgent,
)
from seamless_communication_torch.streaming.agents.online_text_decoder import (
    MMASpeechToTextDecoderAgent, UnitYMMATextDecoderAgent,
)
from seamless_communication_torch.streaming.agents.online_unit_decoder import (
    NARUnitYUnitDecoderAgent,
)
from seamless_communication_torch.streaming.agents.online_vocoder import VocoderAgent
from seamless_communication_torch.streaming.agents.pretssel_vocoder import (
    PretsselVocoderAgent,
)
from seamless_communication_torch.streaming.agents.vad import VADAgent
from seamless_communication_torch.streaming.fused import (
    FusedMMASpeechToTextDecoderAgent, FusedUnitYMMATextDecoderAgent,
    IncrementalFusedMMASpeechToTextDecoderAgent, IncrementalFusedUnitYMMATextDecoderAgent,
)
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer


def _first_tensor(tree):
    if isinstance(tree, dict):
        tree = next(iter(tree.values()))
    elif isinstance(tree, (list, tuple)):
        tree = tree[0]
    else:
        return tree
    return _first_tensor(tree)


def _maybe_quantize_mono(mono_params: dict, quantize_int8: Optional[bool]) -> dict:
    """The EMMA decoder int8 weight-only (``quantize_params``): where
    ``quantize_int8`` is None, exactly when its parameters are on a CUDA
    device. A write burst's step reads every decoder weight and the tied
    vocabulary table; int8 halves those reads against bf16."""
    if quantize_int8 is None:
        quantize_int8 = _first_tensor(mono_params).is_cuda
    return quantize_params(mono_params) if quantize_int8 else mono_params


def _resolve_fused(fused, unity_cfg: UnitYConfig):
    """``fused="auto"``: the incremental agent where it is exact (a
    chunk-causal encoder: chunk size set, all chunks to the left, causal
    depthwise conv), else the re-encoding fused agent."""
    if fused != "auto":
        return fused
    sp = unity_cfg.speech
    if sp.chunk_size and sp.left_chunk_num == -1 and sp.conformer.causal_depthwise_conv:
        return "incremental"
    return True


def _text_head(unity_params, unity_cfg, mono_params, mono_cfg, text_tokenizer, *,
               fused, unity_out: bool, tgt_lang, min_starting_wait_w2vbert,
               decision_threshold, max_len_b, max_consecutive_writes, min_gen_len,
               device) -> list:
    """The encoder and text decoder agents of a pipeline: one fused agent, or
    the encoder agent and the decoder agent."""
    kw = dict(tgt_lang=tgt_lang, max_len_b=max_len_b,
              max_consecutive_writes=max_consecutive_writes,
              decision_threshold=decision_threshold, device=device)
    if fused:
        if fused == "incremental":
            cls = (IncrementalFusedUnitYMMATextDecoderAgent if unity_out
                   else IncrementalFusedMMASpeechToTextDecoderAgent)
        else:
            cls = FusedUnitYMMATextDecoderAgent if unity_out \
                else FusedMMASpeechToTextDecoderAgent
        return [cls(unity_params, unity_cfg, mono_params, mono_cfg, text_tokenizer,
                    min_starting_wait=min_starting_wait_w2vbert, min_gen_len=min_gen_len,
                    **kw)]
    cls = UnitYMMATextDecoderAgent if unity_out else MMASpeechToTextDecoderAgent
    return [OfflineWav2VecBertEncoderAgent(unity_params, unity_cfg,
                                           min_starting_wait=min_starting_wait_w2vbert,
                                           device=device),
            cls(mono_params, mono_cfg, text_tokenizer, **kw)]


def _prepare(unity_params, mono_params, mono_quantize_int8, device):
    device = resolve_device(device)
    mono = _maybe_quantize_mono(params_to(mono_params, device), mono_quantize_int8)
    return params_to(unity_params, device), mono, device


def build_s2t_pipeline(unity_params: dict, unity_cfg: UnitYConfig, mono_params: dict,
                       mono_cfg: MonotonicDecoderConfig, text_tokenizer: NllbTokenizer, *,
                       tgt_lang: str = "eng", min_starting_wait_w2vbert: int = 192,
                       decision_threshold: float = 0.5, denormalize: bool = False,
                       max_len_b: int = 200, max_consecutive_writes: int = 50,
                       min_gen_len: int = 0, mono_quantize_int8: Optional[bool] = None,
                       fused="auto", device=None) -> AgentPipeline:
    """The SeamlessStreaming S2TT / ASR pipeline: feature extractor, encoder
    and EMMA text decoder (``fused``, see the module), detokenizer."""
    unity_params, mono_params, device = _prepare(unity_params, mono_params,
                                                 mono_quantize_int8, device)
    head = _text_head(unity_params, unity_cfg, mono_params, mono_cfg, text_tokenizer,
                      fused=_resolve_fused(fused, unity_cfg), unity_out=False,
                      tgt_lang=tgt_lang, min_starting_wait_w2vbert=min_starting_wait_w2vbert,
                      decision_threshold=decision_threshold, max_len_b=max_len_b,
                      max_consecutive_writes=max_consecutive_writes,
                      min_gen_len=min_gen_len, device=device)
    return AgentPipeline([OnlineFeatureExtractorAgent(denormalize=denormalize), *head,
                          DetokenizerAgent()])


def _speech_tail(unity_params, unity_cfg, text_tokenizer, unit_tokenizer, char_tokenizer,
                 vocoder_params, vocoder_cfg, lang_spkr_idx_map, *, tgt_lang,
                 min_unit_chunk_size, text_bucket, device):
    return (NARUnitYUnitDecoderAgent(unity_params, unity_cfg, unit_tokenizer,
                                     text_tokenizer, char_tokenizer,
                                     min_unit_chunk_size=min_unit_chunk_size,
                                     text_bucket=text_bucket, device=device),
            VocoderAgent(vocoder_params, vocoder_cfg, lang_spkr_idx_map=lang_spkr_idx_map,
                         tgt_lang=tgt_lang, device=device))


def build_s2st_pipeline(unity_params: dict, unity_cfg: UnitYConfig, mono_params: dict,
                        mono_cfg: MonotonicDecoderConfig, text_tokenizer: NllbTokenizer,
                        unit_tokenizer: UnitTokenizer, char_tokenizer: CharTokenizer,
                        vocoder_params: dict, vocoder_cfg: CodeHifiGanConfig,
                        lang_spkr_idx_map: dict, *, tgt_lang: str = "eng",
                        min_starting_wait_w2vbert: int = 192,
                        decision_threshold: float = 0.5, min_unit_chunk_size: int = 50,
                        denormalize: bool = False, max_len_b: int = 200,
                        max_consecutive_writes: int = 50, text_bucket: int = 16,
                        mono_quantize_int8: Optional[bool] = None, fused="auto",
                        device=None) -> AgentPipeline:
    """The SeamlessStreaming S2ST pipeline: feature extractor, encoder and
    EMMA text decoder (the UnitY variant), NAR unit decoder, vocoder."""
    unity_params, mono_params, device = _prepare(unity_params, mono_params,
                                                 mono_quantize_int8, device)
    head = _text_head(unity_params, unity_cfg, mono_params, mono_cfg, text_tokenizer,
                      fused=_resolve_fused(fused, unity_cfg), unity_out=True,
                      tgt_lang=tgt_lang, min_starting_wait_w2vbert=min_starting_wait_w2vbert,
                      decision_threshold=decision_threshold, max_len_b=max_len_b,
                      max_consecutive_writes=max_consecutive_writes, min_gen_len=0,
                      device=device)
    tail = _speech_tail(unity_params, unity_cfg, text_tokenizer, unit_tokenizer,
                        char_tokenizer, vocoder_params, vocoder_cfg, lang_spkr_idx_map,
                        tgt_lang=tgt_lang, min_unit_chunk_size=min_unit_chunk_size,
                        text_bucket=text_bucket, device=device)
    return AgentPipeline([OnlineFeatureExtractorAgent(denormalize=denormalize), *head,
                          *tail])


def build_s2st_tree_pipeline(unity_params: dict, unity_cfg: UnitYConfig,
                             mono_params: dict, mono_cfg: MonotonicDecoderConfig,
                             text_tokenizer: NllbTokenizer, unit_tokenizer: UnitTokenizer,
                             char_tokenizer: CharTokenizer, vocoder_params: dict,
                             vocoder_cfg: CodeHifiGanConfig, lang_spkr_idx_map: dict, *,
                             tgt_lang: str = "eng", min_starting_wait_w2vbert: int = 192,
                             decision_threshold: float = 0.5,
                             min_unit_chunk_size: int = 50, denormalize: bool = False,
                             max_len_b: int = 200, max_consecutive_writes: int = 50,
                             text_bucket: int = 16,
                             mono_quantize_int8: Optional[bool] = None, fused="auto",
                             device=None) -> TreeAgentPipeline:
    """The joint S2TT + S2ST tree: the text decoder's output feeds both a
    detokenizer branch (text segments) and the unit decoder -> vocoder branch
    (speech segments), so one session emits text and waveform together. The
    options are ``build_s2st_pipeline``'s."""
    unity_params, mono_params, device = _prepare(unity_params, mono_params,
                                                 mono_quantize_int8, device)
    chain = [OnlineFeatureExtractorAgent(denormalize=denormalize)] + _text_head(
        unity_params, unity_cfg, mono_params, mono_cfg, text_tokenizer,
        fused=_resolve_fused(fused, unity_cfg), unity_out=True, tgt_lang=tgt_lang,
        min_starting_wait_w2vbert=min_starting_wait_w2vbert,
        decision_threshold=decision_threshold, max_len_b=max_len_b,
        max_consecutive_writes=max_consecutive_writes, min_gen_len=0, device=device)
    unit_decoder, vocoder = _speech_tail(
        unity_params, unity_cfg, text_tokenizer, unit_tokenizer, char_tokenizer,
        vocoder_params, vocoder_cfg, lang_spkr_idx_map, tgt_lang=tgt_lang,
        min_unit_chunk_size=min_unit_chunk_size, text_bucket=text_bucket, device=device)
    tree = {a: [b] for a, b in zip(chain, chain[1:])}
    tree[chain[-1]] = [UnitYDetokenizerAgent(), unit_decoder]
    tree[unit_decoder] = [vocoder]
    return TreeAgentPipeline(tree)


def build_expressive_s2st_pipeline(unity_params: dict, unity_cfg: UnitYConfig,
                                   mono_params: dict, mono_cfg: MonotonicDecoderConfig,
                                   text_tokenizer: NllbTokenizer,
                                   unit_tokenizer: UnitTokenizer,
                                   char_tokenizer: CharTokenizer, pretssel_params: dict,
                                   pretssel_cfg: PretsselConfig, lang_to_index: dict,
                                   gcmvn_mean, gcmvn_std, *, sample_rate: int = 16000,
                                   tgt_lang: str = "eng",
                                   min_starting_wait_w2vbert: int = 192,
                                   decision_threshold: float = 0.5,
                                   min_unit_chunk_size: int = 50, denormalize: bool = False,
                                   use_vad: bool = False,
                                   mono_quantize_int8: Optional[bool] = None,
                                   fused="auto", device=None) -> AgentPipeline:
    """The SeamlessExpressive streaming S2ST pipeline: feature extractor,
    encoder and EMMA text decoder (the UnitY variant; ``fused`` as in
    ``build_s2t_pipeline``), NAR unit decoder, then the PRETSSEL vocoder
    agent, which reads the audio the feature extractor has received for its
    prosody input (normalised by ``gcmvn_mean``, ``gcmvn_std``). The text
    decoder keeps its defaults (``max_len_b`` 200, 50 writes a call), as in
    the JAX package. ``use_vad=True`` puts a ``VADAgent`` (the energy VAD)
    first: silences of 700 ms end an utterance."""
    unity_params, mono_params, device = _prepare(unity_params, mono_params,
                                                 mono_quantize_int8, device)
    feat = OnlineFeatureExtractorAgent(denormalize=denormalize)
    head = _text_head(unity_params, unity_cfg, mono_params, mono_cfg, text_tokenizer,
                      fused=_resolve_fused(fused, unity_cfg), unity_out=True,
                      tgt_lang=tgt_lang, min_starting_wait_w2vbert=min_starting_wait_w2vbert,
                      decision_threshold=decision_threshold, max_len_b=200,
                      max_consecutive_writes=50, min_gen_len=0, device=device)
    units = NARUnitYUnitDecoderAgent(unity_params, unity_cfg, unit_tokenizer,
                                     text_tokenizer, char_tokenizer,
                                     min_unit_chunk_size=min_unit_chunk_size, device=device)
    vocoder = PretsselVocoderAgent(
        pretssel_params, pretssel_cfg, lang_to_index=lang_to_index, gcmvn_mean=gcmvn_mean,
        gcmvn_std=gcmvn_std, tgt_lang=tgt_lang, sample_rate=sample_rate,
        upstream_audio_getter=lambda: [x for c in feat.states.source for x in c],
        device=device)
    vad = [VADAgent()] if use_vad else []
    return AgentPipeline([*vad, feat, *head, units, vocoder])


class StreamingSession:
    """Pushes a waveform through a pipeline in ``segment_size_ms`` chunks and
    collects the output segments (the SimulEval evaluator's inner loop)."""

    def __init__(self, pipeline, *, segment_size_ms: int = 320,
                 sample_rate: int = 16000, tgt_lang: Optional[str] = None):
        self.pipeline = pipeline
        self.segment_size = int(segment_size_ms * sample_rate / 1000)
        self.sample_rate = sample_rate
        self.tgt_lang = tgt_lang
        pipeline.reset()

    def run(self, waveform: np.ndarray, *, max_drain_steps: int = 128):
        """Stream the whole waveform; yields (chunk index, output segment).
        After the source ends the pipeline is pumped with empty finished
        segments until it has finished (a tree: every leaf), at most
        ``max_drain_steps`` times."""
        n_chunks = max(1, -(-len(waveform) // self.segment_size))
        done = False
        for i in range(n_chunks):
            chunk = waveform[i * self.segment_size:(i + 1) * self.segment_size]
            seg = SpeechSegment(content=list(np.asarray(chunk, np.float32)),
                                finished=(i == n_chunks - 1), tgt_lang=self.tgt_lang)
            for out in self.pipeline.process(seg):
                yield i, out
            done = self.pipeline.finished
        drain = 0
        while not done and drain < max_drain_steps:
            drain += 1
            for out in self.pipeline.process(EmptySegment(finished=True,
                                                          tgt_lang=self.tgt_lang)):
                yield n_chunks - 1, out
            done = self.pipeline.finished
