"""The speech encoder agent (counterpart of
``seamless_communication_tpu/streaming/agents/offline_w2v_bert_encoder.py``):
each chunk re-encodes the whole fbank prefix with the offline speech encoder,
the fbank padded to a multiple of ``bucket`` frames. Its output (the encoder
frames of the prefix, fp32) stays on the agent's device."""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.models.unity import model as unity
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.streaming.agents.common import (
    AgentStates, GenericAgent, ReadAction, SpeechSegment, WriteAction,
)
from seamless_communication_torch.utils.profiling import TRACER


class OfflineWav2VecBertEncoderAgent(GenericAgent):
    source_type = "speech"
    target_type = "speech"

    def __init__(self, params: dict, cfg: UnitYConfig, *,
                 min_starting_wait: Optional[int] = 192, bucket: int = 128,
                 device=None, args=None):
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.min_starting_wait = min_starting_wait
        self.bucket = bucket
        self.min_input_length = 80
        self.last_timings: dict = {}      # the stage's wall seconds, last call
        super().__init__(args)

    @torch.inference_mode()
    def policy(self, states: AgentStates):
        total = sum(f.shape[0] for f in states.source)
        if (self.min_starting_wait is not None and total < self.min_starting_wait
                and not states.source_finished):
            return ReadAction()
        if total < self.min_input_length:
            if states.source_finished:
                return WriteAction(SpeechSegment(content=None, is_empty=True),
                                   finished=True)
            return ReadAction()

        self.last_timings = {}
        t0 = time.perf_counter()
        fbank = np.concatenate(states.source, axis=0)
        T = int(math.ceil(fbank.shape[0] / self.bucket)) * self.bucket
        padded = np.zeros((1, T, fbank.shape[1]), np.float32)
        padded[0, :fbank.shape[0]] = fbank
        enc = unity.encode_speech(
            self.params, self.cfg, torch.as_tensor(padded, device=self.device),
            torch.tensor([fbank.shape[0]], device=self.device))
        seqs = enc.seqs[0, :int(enc.lengths[0])].float()
        TRACER.stage_end(self.last_timings, "encoder", t0, self.device)
        return WriteAction(SpeechSegment(content=seqs, tgt_lang=states.tgt_lang,
                                         finished=states.source_finished),
                           finished=states.source_finished)
