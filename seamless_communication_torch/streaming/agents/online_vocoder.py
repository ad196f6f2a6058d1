"""The vocoder agent (counterpart of
``seamless_communication_tpu/streaming/agents/online_vocoder.py``): each unit
chunk becomes a waveform chunk through the unit HiFi-GAN, without the
duration predictor, the units padded to a multiple of ``unit_bucket``."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.models.vocoder.codehifigan import (
    CodeHifiGanConfig, code_hifigan_forward,
)
from seamless_communication_torch.streaming.agents.common import (
    AgentStates, GenericAgent, ReadAction, SpeechSegment, WriteAction,
)
from seamless_communication_torch.utils.profiling import TRACER


class VocoderAgent(GenericAgent):
    source_type = "text"
    target_type = "speech"

    def __init__(self, params: dict, cfg: CodeHifiGanConfig, *, lang_spkr_idx_map: dict,
                 tgt_lang: str = "eng", spkr: int = -1, sample_rate: int = 16000,
                 unit_bucket: int = 32, device=None, args=None):
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.lang_spkr_idx_map = lang_spkr_idx_map
        self.default_tgt_lang = tgt_lang
        self.spkr = spkr
        self.sample_rate = sample_rate
        self.unit_bucket = unit_bucket
        self.last_timings: dict = {}      # the stage's wall seconds, last call
        super().__init__(args)

    def _empty(self):
        return WriteAction(SpeechSegment(content=np.zeros(0, np.float32), is_empty=True),
                           finished=True)

    @torch.inference_mode()
    def policy(self, states: AgentStates):
        if len(states.source) == 0:
            return self._empty() if states.source_finished else ReadAction()
        units = np.asarray(states.source[-1]).reshape(-1)
        units = units[(units >= 0) & (units < self.cfg.num_units)]
        states.source = []
        if units.size == 0:
            return self._empty() if states.source_finished else ReadAction()

        tgt_lang = states.tgt_lang or self.default_tgt_lang
        lang_id = self.lang_spkr_idx_map.get("multilingual", {}).get(tgt_lang, 0)
        spkrs = self.lang_spkr_idx_map.get("multispkr", {}).get(tgt_lang, [0])
        spkr_id = spkrs[self.spkr] if 0 <= self.spkr < len(spkrs) else spkrs[-1]
        self.last_timings = {}
        t0 = time.perf_counter()
        U = int(math.ceil(units.size / self.unit_bucket)) * self.unit_bucket
        arr = np.zeros((1, U), np.int64)
        arr[0, :units.size] = units
        dev = self.device
        out = code_hifigan_forward(self.params, self.cfg, torch.as_tensor(arr, device=dev),
                                   torch.tensor([units.size], device=dev),
                                   torch.tensor([lang_id], device=dev),
                                   torch.tensor([spkr_id], device=dev),
                                   dur_prediction=False)
        wav = out.waveform[0, :int(out.sample_lengths[0])].float().cpu().numpy()
        TRACER.stage_end(self.last_timings, "vocoder", t0, self.device)
        return WriteAction(SpeechSegment(content=wav, sample_rate=self.sample_rate,
                                         tgt_lang=tgt_lang,
                                         finished=states.source_finished),
                           finished=states.source_finished)
