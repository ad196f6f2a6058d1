"""The EMMA monotonic text decoder agents (counterpart of
``seamless_communication_tpu/streaming/agents/online_text_decoder.py``).

The policy of a chunk: build the decoder's cache over the (re-encoded)
source prefix, prefill the context (EOS, the target language and the tokens
written so far), then write greedy tokens while the p_choose statistic (min,
mean or median over the heads of the layers from ``p_choose_start_layer``, at
the last valid pooled key) clears ``decision_threshold`` or the source is
finished; stop on EOS, the length limit or ``max_consecutive_writes``. With
``no_early_stop`` or ``block_ngrams`` the step-by-step loop of the reference
runs instead of the write burst (n-gram blocking forces a READ on a repeat).

Encoder padding: the pooled keys of p_choose have no mask, so padded frames
repeat the last valid one; cross-attention is masked with the true length.

Each agent keeps ``decision_stats`` (the statistic at every decision) and
``policy_counts`` (its READ and WRITE actions and the tokens written) for
whoever measures the policy; ``reset`` leaves them. ``last_timings`` holds
the wall seconds of the stages of its last policy call that ran the model
("prefill", "burst" or "steps"; the fused agents also "encoder"), each
ended by a synchronize on the card.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Set

import numpy as np
import torch

from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.models.monotonic.model import (
    MonotonicDecoderConfig, monotonic_decode_step, monotonic_encode_and_prefill,
    monotonic_write_burst,
)
from seamless_communication_torch.streaming.agents.common import (
    AgentStates, GenericAgent, ReadAction, Segment, TextSegment, WriteAction,
)
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.utils.profiling import TRACER


class DecoderAgentStates(AgentStates):
    def reset(self) -> None:
        self.source_len = 0
        self.target_indices: List[int] = []
        self.ngram_block_count = 0
        super().reset()

    def update_source(self, segment: Segment) -> None:
        self.source_finished = segment.finished
        if self.tgt_lang is None and segment.tgt_lang is not None:
            self.tgt_lang = segment.tgt_lang
        if not segment.is_empty and segment.content is not None:
            self.source = segment.content          # replaced: the whole encoded prefix
            if len(self.source) == 0 and segment.finished:
                self.target_finished = True
                return
            self.source_len = self.source.shape[0]
        elif segment.is_empty and segment.finished and len(self.source) == 0:
            self.target_finished = True


class UnitYTextDecoderOutput:
    """What the text decoder hands the NAR unit decoder: the decoder features
    (1, T, D) fp32 on the device, the token strings written this chunk and
    the target ids (1, T) of the whole context."""

    def __init__(self, decoder_features: torch.Tensor, tokens: List[str],
                 target_indices: Optional[np.ndarray] = None):
        self.decoder_features = decoder_features
        self.tokens = tokens
        self.target_indices = target_indices


class MMATextDecoderAgent(GenericAgent):
    source_type = "speech"
    target_type = "text"
    # the text postprocess reads no decoder features
    needs_features = False

    def __init__(self, params: dict, cfg: MonotonicDecoderConfig,
                 text_tokenizer: NllbTokenizer, *, tgt_lang: str = "eng",
                 max_len_a: int = 1, max_len_b: int = 200,
                 max_consecutive_writes: int = 50, min_starting_wait: int = 1,
                 no_early_stop: bool = False, decision_threshold: float = 0.5,
                 decision_method: str = "min", p_choose_start_layer: int = 0,
                 block_ngrams: bool = False, enc_bucket: int = 64,
                 max_target_len: int = 512, device=None, args=None):
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.text_tokenizer = text_tokenizer
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.max_consecutive_writes = max_consecutive_writes
        self.min_starting_wait = min_starting_wait
        self.no_early_stop = no_early_stop
        self.decision_threshold = decision_threshold
        self.decision_method = decision_method
        self.p_choose_start_layer = p_choose_start_layer
        self.block_ngrams = block_ngrams
        self.enc_bucket = enc_bucket
        self.max_target_len = max_target_len
        self.min_gen_len = 0        # the fused agents' option; EOS is always allowed here
        self.eos_idx = text_tokenizer.vocab_info.eos_idx
        self.prefix_indices = [self.eos_idx, text_tokenizer.lang_token(tgt_lang)]
        self.decision_stats: List[float] = []
        self.policy_counts = {"read": 0, "write": 0, "tokens": 0}
        self.last_timings: dict = {}
        super().__init__(args)

    def build_states(self) -> DecoderAgentStates:
        return DecoderAgentStates()

    def max_len(self, states: DecoderAgentStates) -> int:
        return self.max_len_a * states.source_len + self.max_len_b

    def _set_encoder_valid(self, valid: int, S: int) -> None:
        """The host's copy of the encoder's valid length and the (1, S)
        cross-attention mask."""
        self._enc_valid = valid
        self._enc_mask = (torch.arange(S, device=self.device) < valid)[None, :]

    def _sp_valid(self) -> int:
        return max(1, -(-self._enc_valid // self.cfg.pre_decision_ratio))

    def _pad_encoder_output(self, enc: torch.Tensor) -> torch.Tensor:
        """(S, D) -> (1, S rounded up to ``enc_bucket``, D), the padding
        filled with the last valid frame."""
        S = int(math.ceil(enc.shape[0] / self.enc_bucket)) * self.enc_bucket
        idx = torch.clamp_max(torch.arange(S, device=enc.device), enc.shape[0] - 1)
        self._set_encoder_valid(enc.shape[0], S)
        return enc[idx][None]

    def _prob(self, pchoose: np.ndarray) -> float:
        H = self.cfg.num_heads
        pl = pchoose.reshape(self.cfg.num_layers, H, -1)[
            self.p_choose_start_layer:, :, self._sp_valid() - 1]
        if self.decision_method == "min":
            return float(pl.min())
        if self.decision_method == "mean":
            return float(pl.mean())
        return float(np.median(pl))

    def _enforce_tgt_lang(self, states: DecoderAgentStates) -> None:
        if states.tgt_lang:
            self.prefix_indices[-1] = self.text_tokenizer.lang_token(states.tgt_lang)

    def _get_blocked_ngrams(self, target_indices: List[int]) -> Optional[Set[str]]:
        if not self.block_ngrams:
            return None
        blocked = set()
        if len(target_indices) >= 4:
            blocked |= {str(target_indices[-4:]), str(target_indices[-4:-2]),
                        str(target_indices[-4:-1])}
        if len(target_indices) >= 3:
            blocked |= {str(target_indices[-3:]), str(target_indices[-3:-1])}
        if len(target_indices) >= 2:
            blocked.add(str(target_indices[-2:]))
        return blocked

    def _context(self, states: DecoderAgentStates) -> tuple[list, torch.Tensor]:
        """The context ids and them as (1, T) zero-padded to a multiple of 16."""
        context = self.prefix_indices + states.target_indices
        Tb = max(16, int(math.ceil(len(context) / 16)) * 16)
        ctx = torch.zeros((1, Tb), dtype=torch.long)
        ctx[0, :len(context)] = torch.tensor(context)
        return context, ctx.to(self.device)

    def _count_write(self, pred_indices: List[int]) -> None:
        self.policy_counts["write"] += 1
        self.policy_counts["tokens"] += len(pred_indices)

    def _burst(self, states, cache, context, logits, pchoose):
        """The write burst after the prefill; its statistics are logged."""
        t0 = time.perf_counter()
        burst = monotonic_write_burst(
            self.params, cache, len(context), logits, pchoose, self.cfg,
            decision_threshold=self.decision_threshold,
            decision_method=self.decision_method,
            p_choose_start_layer=self.p_choose_start_layer, sp_valid=self._sp_valid(),
            eos_idx=self.eos_idx, max_len=self.max_len(states), n_context=len(context),
            max_writes=self.max_consecutive_writes,
            source_finished=bool(states.source_finished), enc_padding_mask=self._enc_mask,
            min_gen_len=self.min_gen_len)
        TRACER.stage_end(self.last_timings, "burst", t0, self.device)
        self.decision_stats += burst.stats
        return burst

    def _write_or_read(self, states, context, ctx_feats, burst):
        """The action after a burst: the tokens written (and, where the
        postprocess needs them, the features of the context and of each
        written token), or READ."""
        pred_indices = burst.tokens
        states.target_indices += pred_indices
        finished = burst.finished
        if len(pred_indices) > 0 or finished:
            feats: List[torch.Tensor] = []
            if self.needs_features:
                feats.append(ctx_feats[0, :len(context)].float())
                feats.append(burst.features)
            finished = finished or len(states.target_indices) > self.max_len(states)
            states.ngram_block_count = 0
            self._count_write(pred_indices)
            return WriteAction(self.postprocess(states, pred_indices, finished, feats,
                                                burst.cache,
                                                len(context) + len(pred_indices)),
                               finished=finished)
        self.policy_counts["read"] += 1
        return ReadAction()

    @torch.inference_mode()
    def policy(self, states: DecoderAgentStates):
        if len(states.source) == 0:
            return ReadAction()
        if states.source_len < self.min_starting_wait and not states.source_finished:
            return ReadAction()
        if states.target_finished:
            return WriteAction(TextSegment(content=None, is_empty=True), finished=True)

        self._enforce_tgt_lang(states)
        self.last_timings = {}
        t0 = time.perf_counter()
        enc_padded = self._pad_encoder_output(
            torch.as_tensor(states.source, dtype=torch.float32, device=self.device))
        context, ctx = self._context(states)
        blocked_ngrams = self._get_blocked_ngrams(states.target_indices)
        logits, ctx_feats, pchoose, cache = monotonic_encode_and_prefill(
            self.params, ctx, len(context), enc_padded, self.max_target_len, self.cfg,
            enc_padding_mask=self._enc_mask)
        t0 = TRACER.stage_end(self.last_timings, "prefill", t0, self.device)

        if not self.no_early_stop and blocked_ngrams is None:
            burst = self._burst(states, cache, context, logits, pchoose)
            return self._write_or_read(states, context, ctx_feats, burst)

        # the reference's step-by-step loop
        step = len(context)
        pred_indices: List[int] = []
        finished = False
        feats: List[torch.Tensor] = []
        if self.needs_features:
            feats.append(ctx_feats[0, :len(context)].float())
        while True:
            index = int(torch.argmax(logits[0]))
            prob = self._prob(pchoose[0].cpu().numpy())
            self.decision_stats.append(prob)

            if (self.no_early_stop and not states.source_finished
                    and (prob < self.decision_threshold or index == self.eos_idx)):
                if prob == 1.0:
                    pred_indices = []
                break
            # n-gram blocking: force a READ on a repeat
            if blocked_ngrams is not None and not states.source_finished:
                all_idx = states.target_indices + pred_indices + [index]
                hit = False
                for n in (3, 2):
                    if len(all_idx) >= n and states.ngram_block_count <= 4:
                        if str(all_idx[-n:]) in blocked_ngrams:
                            states.ngram_block_count += 1
                            pred_indices = pred_indices[:-(n - 1)]
                            # feats[0] holds the context; one entry a prediction follows
                            feats = feats[:1 + len(pred_indices)]
                            hit = True
                            break
                        blocked_ngrams.add(str(all_idx[-n:]))
                if hit:
                    break
            cur_len = len(states.target_indices) + len(pred_indices)
            if (index == self.eos_idx or cur_len > self.max_len(states)
                    # at the boundary with a finished source stop here: a break
                    # without a prediction would keep the drain loop going
                    or (states.source_finished and cur_len >= self.max_len(states))):
                finished = True
                break
            if prob < self.decision_threshold and not states.source_finished:
                break
            if (len(states.target_indices + pred_indices) >= self.max_len(states)
                    or len(pred_indices) >= self.max_consecutive_writes
                    or step >= self.max_target_len - 1):
                break

            pred_indices.append(index)
            logits, feat, pchoose, cache = monotonic_decode_step(
                self.params, torch.tensor([[index]], device=self.device), cache, step,
                self.cfg, enc_padding_mask=self._enc_mask)
            if self.needs_features:
                feats.append(feat[0].float())
            step += 1

        TRACER.stage_end(self.last_timings, "steps", t0, self.device)
        states.target_indices += pred_indices
        if len(pred_indices) > 0 or finished:
            finished = finished or len(states.target_indices) > self.max_len(states)
            states.ngram_block_count = 0
            self._count_write(pred_indices)
            return WriteAction(
                self.postprocess(states, pred_indices, finished, feats, cache, step),
                finished=finished)
        self.policy_counts["read"] += 1
        return ReadAction()

    def postprocess(self, states: DecoderAgentStates, pred_indices: List[int],
                    finished: bool, feats: List[torch.Tensor], cache, step: int
                    ) -> TextSegment:
        text = self.text_tokenizer.decode(pred_indices)
        return TextSegment(content=text, finished=finished, tgt_lang=states.tgt_lang)


class MMASpeechToTextDecoderAgent(MMATextDecoderAgent):
    source_type = "speech"


class UnitYMMATextDecoderAgent(MMASpeechToTextDecoderAgent):
    """The variant feeding the NAR unit decoder: it emits the decoder
    features and the target ids, and appends a "," token (one more decoder
    step) for smoother speech."""

    needs_features = True

    def postprocess(self, states: DecoderAgentStates, pred_indices: List[int],
                    finished: bool, feats: List[torch.Tensor], cache, step: int
                    ) -> TextSegment:
        tokens = [self.text_tokenizer.id_to_token(i) for i in pred_indices]
        token_list = self.prefix_indices + states.target_indices
        if len(pred_indices) > 0 and pred_indices[-1] != self.eos_idx:
            comma = self.text_tokenizer.token_to_id(",")
            token_list = token_list + [comma]
            _, feat, _, cache = monotonic_decode_step(
                self.params, torch.tensor([[comma]], device=self.device), cache, step,
                self.cfg, enc_padding_mask=self._enc_mask)
            feats = feats + [feat[0].float()]
        features = torch.cat(feats, dim=0)[None]          # (1, T, D)
        target_input = np.asarray([token_list], np.int64)
        return TextSegment(content=UnitYTextDecoderOutput(features, tokens, target_input),
                           finished=finished, tgt_lang=states.tgt_lang)
