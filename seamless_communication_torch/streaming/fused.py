"""The fused streaming agents (counterpart of
``seamless_communication_tpu/streaming/fused.py``): the speech encoder and
the EMMA text decoder in one agent, so the encoder output never leaves the
card between them.

``fused_s2t_chunk`` re-encodes the whole fbank prefix (padded to a multiple
of ``fbank_bucket`` = 128 frames, the JAX package's padded lengths), then
builds the monotonic cache, prefills the context and runs the write burst.
``incremental_s2t_chunk`` encodes only the new fbank block with the
incremental encoder (``models/wav2vec2/incremental.py``, exact for the
chunk-causal streaming conformer) before the same decode. The numerics are
the unfused agents': padded encoder frames repeat the last valid one (the
pooled keys of p_choose have no mask) and the true length masks
cross-attention.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from seamless_communication_torch.device import params_to
from seamless_communication_torch.models.monotonic.model import (
    MonotonicDecoderConfig, monotonic_encode_and_prefill, monotonic_write_burst,
    monotonic_write_burst_rows,
)
from seamless_communication_torch.models.unity import model as unity
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.models.wav2vec2.encoder import SpeechEncoderConfig
from seamless_communication_torch.models.wav2vec2.incremental import (
    speech_encoder_stream_init, speech_encoder_stream_output, speech_encoder_stream_step,
)
from seamless_communication_torch.streaming.agents.common import (
    ReadAction, Segment, TextSegment, WriteAction,
)
from seamless_communication_torch.streaming.agents.online_text_decoder import (
    DecoderAgentStates, MMATextDecoderAgent, UnitYMMATextDecoderAgent,
)
from seamless_communication_torch.utils.profiling import TRACER


def encoder_output_length(cfg: SpeechEncoderConfig, n_frames: int) -> int:
    """The speech encoder's output length for ``n_frames`` fbank frames
    (``speech_encoder_forward``'s length arithmetic, on the host)."""
    n = n_frames // cfg.fbank_stride
    k, s = cfg.adaptor_kernel_size, cfg.adaptor_stride
    for _ in range(cfg.adaptor_layers):
        n = (n + 2 * (k // 2) - k) // s + 1
    return n


def _decode_over_encoder(mono_params: dict, enc_seqs_raw: torch.Tensor, enc_len: int,
                        tokens: torch.Tensor, n_tokens: int,
                        mono_cfg: MonotonicDecoderConfig, *, max_target_len: int,
                        decision_threshold: float, decision_method: str,
                        p_choose_start_layer: int, eos_idx: int, max_len_a: int,
                        max_len_b: int, max_writes: int, source_finished: bool,
                        min_gen_len: int = 0, timings: Optional[dict] = None):
    """The monotonic cache, prefill and write burst over a (padded) encoder
    output whose first ``enc_len`` frames are valid -> (burst, context
    features (B, T, D)). ``timings``: where given, the wall seconds of the
    "prefill" (the cache with it) and the "burst"."""
    t0 = time.perf_counter()
    S = enc_seqs_raw.shape[1]
    idx = torch.clamp_max(torch.arange(S, device=enc_seqs_raw.device), enc_len - 1)
    enc_seqs = enc_seqs_raw[:, idx]
    enc_mask = (torch.arange(S, device=enc_seqs_raw.device) < enc_len)[None, :]
    logits, ctx_feats, pcs, cache = monotonic_encode_and_prefill(
        mono_params, tokens, n_tokens, enc_seqs, max_target_len, mono_cfg,
        enc_padding_mask=enc_mask)
    t0 = TRACER.stage_end(timings, "prefill", t0, enc_seqs.device)
    burst = monotonic_write_burst(
        mono_params, cache, n_tokens, logits, pcs, mono_cfg,
        decision_threshold=decision_threshold, decision_method=decision_method,
        p_choose_start_layer=p_choose_start_layer,
        sp_valid=max(1, -(-enc_len // mono_cfg.pre_decision_ratio)), eos_idx=eos_idx,
        max_len=max_len_a * enc_len + max_len_b, n_context=n_tokens,
        max_writes=max_writes, source_finished=source_finished,
        enc_padding_mask=enc_mask, min_gen_len=min_gen_len)
    TRACER.stage_end(timings, "burst", t0, enc_seqs.device)
    return burst, ctx_feats


def fused_s2t_chunk(unity_params: dict, mono_params: dict, fbank: torch.Tensor,
                    fbank_len: int, tokens: torch.Tensor, n_tokens: int,
                    unity_cfg: UnitYConfig, mono_cfg: MonotonicDecoderConfig, **kw):
    """The re-encode of the (1, T, 80) fbank prefix, its first ``fbank_len``
    frames valid, then ``_decode_over_encoder`` (``kw``: its options) ->
    (burst, context features)."""
    t0 = time.perf_counter()
    enc = unity.encode_speech(unity_params, unity_cfg, fbank,
                              torch.tensor([fbank_len], device=fbank.device))
    TRACER.stage_end(kw.get("timings"), "encoder", t0, fbank.device)
    enc_len = encoder_output_length(unity_cfg.speech, fbank_len)
    return _decode_over_encoder(mono_params, enc.seqs, enc_len, tokens, n_tokens,
                               mono_cfg, **kw)


def incremental_s2t_chunk(unity_params: dict, mono_params: dict, enc_state,
                          fbank_new: torch.Tensor, n_valid: int, tokens: torch.Tensor,
                          n_tokens: int, unity_cfg: UnitYConfig,
                          mono_cfg: MonotonicDecoderConfig, **kw):
    """The incremental encode of the new (1, FB, 80) fbank block (its first
    ``n_valid`` stacked frames valid), the adaptor over everything encoded,
    then ``_decode_over_encoder`` -> (new encoder state, burst, context
    features)."""
    t0 = time.perf_counter()
    se = unity_params["speech_encoder"]
    enc_state = speech_encoder_stream_step(se, enc_state, fbank_new, unity_cfg.speech,
                                           n_valid=n_valid)
    enc_seqs, _ = speech_encoder_stream_output(se, enc_state, unity_cfg.speech)
    TRACER.stage_end(kw.get("timings"), "encoder", t0, fbank_new.device)
    enc_len = encoder_output_length(unity_cfg.speech,
                                    int(enc_state.n[0]) * unity_cfg.speech.fbank_stride)
    burst, ctx_feats = _decode_over_encoder(mono_params, enc_seqs, enc_len, tokens,
                                           n_tokens, mono_cfg, **kw)
    return enc_state, burst, ctx_feats


def _decode_over_encoder_rows(mono_params: dict, enc_seqs_raw: torch.Tensor,
                             enc_len: Sequence[int], tokens: torch.Tensor,
                             n_tokens: Sequence[int], mono_cfg: MonotonicDecoderConfig, *,
                             max_target_len: int, decision_threshold: float,
                             decision_method: str, p_choose_start_layer: int,
                             eos_idx: int, max_len_a: int, max_len_b: int,
                             max_writes: int, source_finished: Sequence[bool],
                             active: Sequence[bool], min_gen_len: int = 0,
                             with_gaps: bool = False, timings: Optional[dict] = None):
    """``_decode_over_encoder`` of B sessions, row b's first ``enc_len[b]``
    frames valid and its context ``tokens[b, :n_tokens[b]]``, the burst for
    the ``active`` rows -> one burst a row."""
    span = TRACER.begin("pool.prefill") if TRACER.on else None
    t0 = time.perf_counter()
    B, S, D = enc_seqs_raw.shape
    dev = enc_seqs_raw.device
    pos = torch.arange(S, device=dev)
    lens = torch.tensor(list(enc_len), device=dev)
    idx = torch.minimum(pos[None, :], lens[:, None] - 1)
    enc_seqs = torch.gather(enc_seqs_raw, 1, idx[..., None].expand(B, S, D))
    enc_mask = pos[None, :] < lens[:, None]
    logits, _, pcs, cache = monotonic_encode_and_prefill(
        mono_params, tokens, list(n_tokens), enc_seqs, max_target_len, mono_cfg,
        enc_padding_mask=enc_mask)
    t0 = TRACER.stage_end(timings, "prefill", t0, dev, span)
    span = TRACER.begin("pool.burst") if TRACER.on else None
    bursts = monotonic_write_burst_rows(
        mono_params, cache, n_tokens, logits, pcs, mono_cfg,
        decision_threshold=decision_threshold, decision_method=decision_method,
        p_choose_start_layer=p_choose_start_layer,
        sp_valid=[max(1, -(-n // mono_cfg.pre_decision_ratio)) for n in enc_len],
        eos_idx=eos_idx, max_len=[max_len_a * n + max_len_b for n in enc_len],
        n_context=n_tokens, max_writes=max_writes, source_finished=source_finished,
        active=active, enc_padding_mask=enc_mask, min_gen_len=min_gen_len,
        with_gaps=with_gaps)
    TRACER.stage_end(timings, "burst", t0, dev, span)
    return bursts


def batched_incremental_s2t_chunk(unity_params: dict, mono_params: dict, enc_state,
                                  fbank_new: torch.Tensor, n_valid: Sequence[int],
                                  tokens: torch.Tensor, n_tokens: Sequence[int],
                                  unity_cfg: UnitYConfig,
                                  mono_cfg: MonotonicDecoderConfig, *,
                                  commit: Sequence[bool], active: Sequence[bool], **kw):
    """``incremental_s2t_chunk`` for B sessions at once (the streaming pool's
    slots): row b encodes its (FB, 80) block of ``fbank_new`` (B, FB, 80) at
    its own offset ``enc_state.n[b]`` with ``n_valid[b]`` stacked frames
    valid, and decodes its context ``tokens[b, :n_tokens[b]]``
    (``kw``: the options of ``_decode_over_encoder_rows``). The decode runs
    for the ``active`` rows only, and not at all when no row is active
    (blocks that are only taken up). A row that is not ``commit``ted keeps
    its previous conv tail and count (the rows written past its count are
    written again by its next step) -> (new encoder state, one burst a row,
    or None where no row was active). The stages' spans are ``pool.encoder``,
    ``pool.prefill`` and ``pool.burst``."""
    timings = kw.get("timings")
    span = TRACER.begin("pool.encoder") if TRACER.on else None
    t0 = time.perf_counter()
    se = unity_params["speech_encoder"]
    new = speech_encoder_stream_step(se, enc_state, fbank_new, unity_cfg.speech,
                                     n_valid=n_valid)
    bursts = None
    if any(active):
        enc_seqs, _ = speech_encoder_stream_output(se, new, unity_cfg.speech)
        TRACER.stage_end(timings, "encoder", t0, fbank_new.device, span)
        enc_len = [encoder_output_length(unity_cfg.speech, n * unity_cfg.speech.fbank_stride)
                   for n in new.n.tolist()]
        bursts = _decode_over_encoder_rows(mono_params, enc_seqs, enc_len, tokens, n_tokens,
                                           mono_cfg, active=active, **kw)
    else:
        TRACER.stage_end(timings, "encoder", t0, fbank_new.device, span)
    take = torch.tensor(list(commit))
    # the new tails keep the activations' dtype, as a single session's do
    tail = torch.where(take.to(fbank_new.device)[None, :, None, None], new.conv_tail,
                       enc_state.conv_tail)
    return new._replace(conv_tail=tail, n=torch.where(take, new.n, enc_state.n)), bursts


class FusedDecoderAgentStates(DecoderAgentStates):
    """The fused agent's source is the fbank stream: chunks accumulate."""

    def update_source(self, segment: Segment) -> None:
        self.source_finished = segment.finished
        if self.tgt_lang is None and segment.tgt_lang is not None:
            self.tgt_lang = segment.tgt_lang
        if not segment.is_empty and segment.content is not None:
            self.source.append(segment.content)
            self.source_len = sum(f.shape[0] for f in self.source)
        elif segment.is_empty and segment.finished and len(self.source) == 0:
            self.target_finished = True


class FusedMMASpeechToTextDecoderAgent(MMATextDecoderAgent):
    """The speech encoder and the EMMA text decoder in one agent, in place
    of the ``OfflineWav2VecBertEncoderAgent`` + ``MMASpeechToTextDecoderAgent``
    pair (the default policy only: ``no_early_stop`` and ``block_ngrams``
    need the unfused step-by-step loop)."""

    source_type = "speech"
    target_type = "text"

    def __init__(self, unity_params: dict, unity_cfg: UnitYConfig, mono_params: dict,
                 mono_cfg: MonotonicDecoderConfig, text_tokenizer, *,
                 tgt_lang: str = "eng", min_starting_wait: Optional[int] = 192,
                 fbank_bucket: int = 128, min_input_length: int = 80,
                 max_len_a: int = 1, max_len_b: int = 200,
                 max_consecutive_writes: int = 50, decision_threshold: float = 0.5,
                 decision_method: str = "min", p_choose_start_layer: int = 0,
                 max_target_len: int = 512, min_gen_len: int = 0, device=None,
                 args=None):
        super().__init__(mono_params, mono_cfg, text_tokenizer, tgt_lang=tgt_lang,
                         max_len_a=max_len_a, max_len_b=max_len_b,
                         max_consecutive_writes=max_consecutive_writes,
                         decision_threshold=decision_threshold,
                         decision_method=decision_method,
                         p_choose_start_layer=p_choose_start_layer,
                         max_target_len=max_target_len, device=device, args=args)
        self.unity_params = params_to(unity_params, self.device)
        self.unity_cfg = unity_cfg
        self.min_starting_wait = min_starting_wait
        self.fbank_bucket = fbank_bucket
        self.min_input_length = min_input_length
        self.min_gen_len = min_gen_len

    def build_states(self) -> FusedDecoderAgentStates:
        return FusedDecoderAgentStates()

    def max_len(self, states: FusedDecoderAgentStates) -> int:
        # source_len counts fbank frames here: the limit is in encoder frames
        return (self.max_len_a * encoder_output_length(self.unity_cfg.speech,
                                                       states.source_len)
                + self.max_len_b)

    def _decode_options(self, states) -> dict:
        return dict(max_target_len=self.max_target_len,
                    decision_threshold=self.decision_threshold,
                    decision_method=self.decision_method,
                    p_choose_start_layer=self.p_choose_start_layer, eos_idx=self.eos_idx,
                    max_len_a=self.max_len_a, max_len_b=self.max_len_b,
                    max_writes=self.max_consecutive_writes,
                    source_finished=bool(states.source_finished),
                    min_gen_len=self.min_gen_len, timings=self.last_timings)

    def _waiting(self, states):
        """READ, the finishing empty write, or None when the policy runs."""
        total = sum(f.shape[0] for f in states.source)
        if (self.min_starting_wait is not None and total < self.min_starting_wait
                and not states.source_finished):
            return ReadAction()
        if total < self.min_input_length:
            if states.source_finished or states.target_finished:
                return WriteAction(TextSegment(content=None, is_empty=True),
                                   finished=True)
            return ReadAction()
        if states.target_finished:
            return WriteAction(TextSegment(content=None, is_empty=True), finished=True)
        return None

    @torch.inference_mode()
    def policy(self, states: FusedDecoderAgentStates):
        waiting = self._waiting(states)
        if waiting is not None:
            return waiting
        self._enforce_tgt_lang(states)
        fbank = np.concatenate(states.source, axis=0)
        T = int(math.ceil(fbank.shape[0] / self.fbank_bucket)) * self.fbank_bucket
        fb = np.zeros((1, T, fbank.shape[1]), np.float32)
        fb[0, :fbank.shape[0]] = fbank
        # the host's copy of the encoder lengths (for the UnitY "," step)
        self._set_encoder_valid(encoder_output_length(self.unity_cfg.speech,
                                                      fbank.shape[0]),
                                encoder_output_length(self.unity_cfg.speech, T))
        context, ctx = self._context(states)
        self.last_timings = {}
        burst, ctx_feats = fused_s2t_chunk(
            self.unity_params, self.params, torch.as_tensor(fb, device=self.device),
            fbank.shape[0], ctx, len(context), self.unity_cfg, self.cfg,
            **self._decode_options(states))
        self.decision_stats += burst.stats
        return self._write_or_read(states, context, ctx_feats, burst)


class FusedUnitYMMATextDecoderAgent(FusedMMASpeechToTextDecoderAgent,
                                    UnitYMMATextDecoderAgent):
    """The fused agent feeding the NAR unit decoder: the fused policy with
    the feature-emitting postprocess (and its "," step)."""


class IncrementalDecoderAgentStates(FusedDecoderAgentStates):
    def reset(self) -> None:
        self.enc_state = None      # SpeechEncoderStreamState
        self.fb_consumed = 0       # fbank frames the encoder has taken up
        self.n_stacked = 0         # stacked frames encoded
        super().reset()


def _float_dtype(tree) -> torch.dtype:
    """The dtype of the first floating leaf, dict keys in sorted order (the
    JAX package's leaf order): an int8 tree's int8 leaves must not set the
    encoder state's dtype."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            dt = _float_dtype(tree[k])
            if dt is not None:
                return dt
        return None
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dt = _float_dtype(v)
            if dt is not None:
                return dt
        return None
    return tree.dtype if tree.is_floating_point() else None


class IncrementalFusedMMASpeechToTextDecoderAgent(FusedMMASpeechToTextDecoderAgent):
    """The fused agent with the incremental encoder: a chunk encodes only the
    new fbank block, and the conformer's total work over a stream is linear
    in its length. ``max_stream_frames`` bounds a stream in stacked frames
    (fbank frames / 2): 2048 is about 41 s of audio."""

    def __init__(self, unity_params: dict, unity_cfg: UnitYConfig, mono_params: dict,
                 mono_cfg: MonotonicDecoderConfig, text_tokenizer, *,
                 fbank_block: int = 32, max_stream_frames: int = 2048, **kw):
        super().__init__(unity_params, unity_cfg, mono_params, mono_cfg, text_tokenizer,
                         **kw)
        sp = unity_cfg.speech
        if not (sp.chunk_size and sp.left_chunk_num == -1
                and sp.conformer.causal_depthwise_conv):
            raise ValueError(
                "incremental encoding is exact only for chunk-causal encoders "
                "(chunk_size set, full left context, causal depthwise conv): use the "
                "re-encoding fused agent for this model")
        self.fbank_block = fbank_block
        self.max_stream_frames = max_stream_frames
        if (fbank_block // sp.fbank_stride) % sp.chunk_size:
            raise ValueError("fbank_block must cover whole attention chunks")

    def build_states(self) -> IncrementalDecoderAgentStates:
        return IncrementalDecoderAgentStates()

    def _adaptor_len(self, n_stacked: int) -> int:
        return encoder_output_length(self.unity_cfg.speech,
                                     n_stacked * self.unity_cfg.speech.fbank_stride)

    def max_len(self, states) -> int:
        n = getattr(self, "_last_decode_stacked", 0) or states.n_stacked
        return self.max_len_a * self._adaptor_len(n) + self.max_len_b

    @torch.inference_mode()
    def policy(self, states: IncrementalDecoderAgentStates):
        waiting = self._waiting(states)
        if waiting is not None:
            return waiting
        self._enforce_tgt_lang(states)
        sp = self.unity_cfg.speech
        if states.enc_state is None:
            states.enc_state = speech_encoder_stream_init(
                sp, batch=1, max_frames=self.max_stream_frames,
                dtype=_float_dtype(self.unity_params), device=self.device)

        FB, stride = self.fbank_block, sp.fbank_stride
        total = sum(f.shape[0] for f in states.source)
        new = total - states.fb_consumed
        n_full = new // FB
        partial = new - n_full * FB
        if n_full == 0 and partial == 0 and not states.source_finished:
            return ReadAction()
        fbank = np.concatenate(states.source, axis=0)[states.fb_consumed:total]

        # full blocks are taken up by the encoder state; the block decoded is
        # the last full one (taken up) or the pending partial one padded to FB
        # (taken up only once the source has finished: the unfused agents
        # decode over it too)
        commit_blocks = [fbank[b * FB:(b + 1) * FB] for b in range(n_full)]
        if partial > 0:
            decode_fb = np.zeros((FB, fbank.shape[1]), np.float32)
            decode_fb[:partial] = fbank[n_full * FB:]
            decode_nv, commit_decode = partial // stride, bool(states.source_finished)
        elif n_full > 0:
            decode_fb, decode_nv, commit_decode = commit_blocks.pop(), FB // stride, True
        else:   # pumped after the source ended: decode only
            decode_fb = np.zeros((FB, 80), np.float32)
            decode_nv, commit_decode = 0, True

        context, ctx = self._context(states)
        self.last_timings = {}
        t0 = time.perf_counter()
        for fb_np in commit_blocks:
            states.enc_state = speech_encoder_stream_step(
                self.unity_params["speech_encoder"], states.enc_state,
                torch.as_tensor(fb_np[None], device=self.device), sp,
                n_valid=FB // stride)
            states.n_stacked += FB // stride
            states.fb_consumed += FB
        TRACER.stage_end(self.last_timings, "commit", t0, self.device)
        decode_stacked = states.n_stacked + decode_nv
        # the host's copy of the encoder lengths, for max_len and the "," step
        self._set_encoder_valid(self._adaptor_len(decode_stacked),
                                self._adaptor_len(self.max_stream_frames))
        self._last_decode_stacked = decode_stacked
        new_state, burst, ctx_feats = incremental_s2t_chunk(
            self.unity_params, self.params, states.enc_state,
            torch.as_tensor(decode_fb[None], device=self.device), decode_nv, ctx,
            len(context), self.unity_cfg, self.cfg, **self._decode_options(states))
        if commit_decode:
            states.enc_state = new_state
            states.n_stacked = decode_stacked
            states.fb_consumed = total
        self.decision_stats += burst.stats
        return self._write_or_read(states, context, ctx_feats, burst)


class IncrementalFusedUnitYMMATextDecoderAgent(IncrementalFusedMMASpeechToTextDecoderAgent,
                                               UnitYMMATextDecoderAgent):
    """The incremental fused agent feeding the NAR unit decoder."""
