"""The expressive streaming vocoder agents (counterpart of
``seamless_communication_tpu/streaming/agents/pretssel_vocoder.py``).

``PretsselVocoderAgent``: a unit chunk -> deduplicated units (+4 control
offset), durations x2 -> a PRETSSEL waveform chunk, with the gcmvn-normalised
fbank of the source audio received so far as the prosody input (the audio
padded to 400 samples, the frames to a multiple of 128); the units and
mel frames in ``unit_batch``'s buckets, with no EOS unit.

``DualVocoderAgent``: the unit HiFi-GAN agent or the PRETSSEL one, per
utterance (the expressive flag and the target language's support).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from seamless_communication_torch.audio.fbank import fbank_numpy
from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.inference.pretssel_generator import unit_batch
from seamless_communication_torch.models.pretssel.vocoder import (
    PretsselConfig, pretssel_forward,
)
from seamless_communication_torch.streaming.agents.common import (
    AgentStates, GenericAgent, ReadAction, SpeechSegment, WriteAction,
)
from seamless_communication_torch.streaming.agents.online_vocoder import VocoderAgent
from seamless_communication_torch.utils.profiling import TRACER


class PretsselVocoderAgent(GenericAgent):
    source_type = "text"
    target_type = "speech"

    def __init__(self, params: dict, cfg: PretsselConfig, *, lang_to_index: dict,
                 gcmvn_mean: np.ndarray, gcmvn_std: np.ndarray, tgt_lang: str = "eng",
                 sample_rate: int = 16000, upstream_audio_getter=None, device=None,
                 args=None):
        """``upstream_audio_getter()`` returns the source waveform received
        so far (the feature extractor's states)."""
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.lang_to_index = lang_to_index
        self.gcmvn_mean = np.asarray(gcmvn_mean, np.float32)
        self.gcmvn_std = np.asarray(gcmvn_std, np.float32)
        self.default_tgt_lang = tgt_lang
        self.sample_rate = sample_rate
        self.upstream_audio_getter = upstream_audio_getter or (lambda: [])
        self.last_timings: dict = {}      # the stage's wall seconds, last call
        super().__init__(args)

    @torch.inference_mode()
    def policy(self, states: AgentStates):
        if len(states.source) == 0:
            if states.source_finished:
                return WriteAction(SpeechSegment(content=np.zeros(0, np.float32),
                                                 is_empty=True), finished=True)
            return ReadAction()
        units = np.asarray(states.source[-1]).reshape(-1).tolist()
        states.source = []
        tgt_lang = states.tgt_lang or self.default_tgt_lang
        if not units or tgt_lang not in self.lang_to_index:
            return WriteAction(SpeechSegment(content=np.zeros(0, np.float32),
                                             is_empty=not units, tgt_lang=tgt_lang),
                               finished=states.source_finished)

        self.last_timings = {}
        t0 = time.perf_counter()
        u_arr, d_arr, n, M = unit_batch(units, eos=False)
        source = np.asarray(self.upstream_audio_getter(), np.float32).reshape(-1)
        if source.size < 400:
            source = np.pad(source, (0, 400 - source.size))
        feats = ((fbank_numpy(source) - self.gcmvn_mean[None])
                 / self.gcmvn_std[None]).astype(np.float32)
        fpad = np.zeros((1, max(128, -(-feats.shape[0] // 128) * 128), feats.shape[1]),
                        np.float32)
        fpad[0, :feats.shape[0]] = feats
        dev = self.device
        out = pretssel_forward(self.params, self.cfg, torch.as_tensor(u_arr, device=dev),
                               torch.tensor([n], device=dev),
                               torch.as_tensor(d_arr, device=dev),
                               torch.as_tensor(fpad, device=dev),
                               torch.tensor([feats.shape[0]], device=dev),
                               torch.tensor([self.lang_to_index[tgt_lang]], device=dev),
                               max_mel_len=M)
        wav = out.waveform[0, :int(out.sample_lengths[0])].float().cpu().numpy()
        TRACER.stage_end(self.last_timings, "vocoder", t0, dev)
        return WriteAction(SpeechSegment(content=wav, sample_rate=self.sample_rate,
                                         tgt_lang=tgt_lang,
                                         finished=states.source_finished),
                           finished=states.source_finished)


class DualVocoderAgent(GenericAgent):
    """The expressive agent where ``expressive`` is set and it supports the
    utterance's target language, else the unit HiFi-GAN agent."""

    source_type = "text"
    target_type = "speech"

    def __init__(self, vocoder_agent: VocoderAgent, pretssel_agent: PretsselVocoderAgent,
                 *, expressive: bool = True, args=None):
        self.vocoder_agent = vocoder_agent
        self.pretssel_agent = pretssel_agent
        self.expressive = expressive
        super().__init__(args)

    def reset(self):
        super().reset()
        self.vocoder_agent.reset()
        self.pretssel_agent.reset()

    def _active(self, tgt_lang: Optional[str]) -> GenericAgent:
        if self.expressive and tgt_lang and tgt_lang in self.pretssel_agent.lang_to_index:
            return self.pretssel_agent
        return self.vocoder_agent

    def push(self, segment):
        super().push(segment)
        self._active(self.states.tgt_lang).push(segment)

    def policy(self, states: AgentStates):
        active = self._active(states.tgt_lang)
        return active.policy(active.states)
