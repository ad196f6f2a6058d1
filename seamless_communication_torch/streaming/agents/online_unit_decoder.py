"""The NAR unit decoder agent (counterpart of
``seamless_communication_tpu/streaming/agents/online_unit_decoder.py``): each
chunk runs the whole NAR T2U (``nar_t2u_forward``) over the decoder features
received so far and emits only the units of the chars from
``duration_start_index`` on, once at least ``min_unit_chunk_size`` new units
are there (or the source has finished)."""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.models.unity.t2u import nar_t2u_forward
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.streaming.agents.common import (
    AgentStates, GenericAgent, ReadAction, Segment, TextSegment, WriteAction,
)
from seamless_communication_torch.streaming.agents.online_text_decoder import (
    UnitYTextDecoderOutput,
)
from seamless_communication_torch.text.char_frontend import text_to_char_seqs
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.utils.profiling import TRACER


class NARUnitDecoderAgentStates(AgentStates):
    def reset(self) -> None:
        self.source_token_list: List[str] = []
        self.source_indices: Optional[np.ndarray] = None
        self.duration_start_index: int = 0
        super().reset()

    def update_source(self, segment: Segment) -> None:
        self.source_finished = segment.finished
        if self.tgt_lang is None and segment.tgt_lang is not None:
            self.tgt_lang = segment.tgt_lang
        if segment.is_empty or segment.content is None:
            if segment.finished:
                self.target_finished = True
            return
        content: UnitYTextDecoderOutput = segment.content
        self.source = content.decoder_features
        self.source_indices = content.target_indices
        self.source_token_list += content.tokens


class NARUnitYUnitDecoderAgent(GenericAgent):
    source_type = "text"
    target_type = "text"

    def __init__(self, params: dict, cfg: UnitYConfig, unit_tokenizer: UnitTokenizer,
                 text_tokenizer: NllbTokenizer, char_tokenizer: CharTokenizer, *,
                 min_unit_chunk_size: int = 50, d_factor: float = 1.0,
                 max_unit_len: int = 2048, text_bucket: int = 16, device=None,
                 args=None):
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.unit_tokenizer = unit_tokenizer
        self.text_tokenizer = text_tokenizer
        self.char_tokenizer = char_tokenizer
        self.min_unit_chunk_size = min_unit_chunk_size
        self.d_factor = d_factor
        self.max_unit_len = max_unit_len
        self.text_bucket = text_bucket
        self.last_timings: dict = {}      # the stage's wall seconds, last call
        super().__init__(args)

    def build_states(self) -> NARUnitDecoderAgentStates:
        return NARUnitDecoderAgentStates()

    @torch.inference_mode()
    def policy(self, states: NARUnitDecoderAgentStates):
        if states.target_finished:
            return WriteAction(TextSegment(content=None, is_empty=True), finished=True)
        if len(states.source_token_list) < 2:
            if not states.source_finished:
                return ReadAction()
            return WriteAction(TextSegment(content=None, is_empty=True), finished=True)

        self.last_timings = {}
        t0 = time.perf_counter()
        feats = states.source.float()                       # (1, T, D)
        T = feats.shape[1]
        Tb = int(math.ceil(T / self.text_bucket)) * self.text_bucket
        fpad = torch.nn.functional.pad(feats, (0, 0, 0, Tb - T))
        ids = np.zeros((1, Tb), np.int64)
        ids[0, :T] = states.source_indices[0, :T]
        char_ids, char_lens, char_counts = text_to_char_seqs(
            self.text_tokenizer, self.char_tokenizer, ids, max_char_len=max(64, Tb * 12))
        dev = self.device
        out = nar_t2u_forward(self.params["t2u"], self.cfg.nar_t2u, fpad,
                              torch.tensor([T], device=dev),
                              torch.as_tensor(char_ids, device=dev),
                              torch.as_tensor(char_counts, device=dev),
                              max_unit_len=self.max_unit_len,
                              duration_factor=self.d_factor)
        n_chars = int(char_lens[0])
        durations = out.durations[0].cpu().numpy()[:n_chars]
        TRACER.stage_end(self.last_timings, "t2u", t0, self.device)

        if states.source_finished and states.duration_start_index > 0:
            if durations[states.duration_start_index:].sum() == 0:
                return WriteAction(TextSegment(content=None, is_empty=True),
                                   finished=True)
            states.duration_start_index = max(states.duration_start_index - 1, 0)

        current_duration = int(durations[states.duration_start_index:].sum())
        if current_duration < self.min_unit_chunk_size:
            if not states.source_finished:
                return ReadAction()
            if current_duration == 0:
                return WriteAction(TextSegment(content=None, is_empty=True),
                                   finished=True)

        offset = int(durations[:states.duration_start_index].sum())
        total = int(durations.sum())
        unit_seqs = out.unit_logits[0, offset:total].argmax(dim=-1).cpu().numpy()[None]
        units = self.unit_tokenizer.decode(unit_seqs)[0]
        # minus one: each text chunk ends in an appended "," token
        states.duration_start_index = max(n_chars - 1, 0)
        return WriteAction(TextSegment(content=units, finished=states.source_finished,
                                       tgt_lang=states.tgt_lang),
                           finished=states.source_finished)
