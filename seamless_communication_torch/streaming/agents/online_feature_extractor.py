"""The incremental fbank agent (counterpart of
``seamless_communication_tpu/streaming/agents/online_feature_extractor.py``).

It keeps the samples left over between 320 ms chunks and emits the (frames,
80) log-mel fbank of the new samples each step, on the host with the port's
numpy fbank (``audio/fbank.py``), as the JAX package does: the fbank kernel
K4 is not on this path."""

from __future__ import annotations

import math
from typing import List

import numpy as np

from seamless_communication_torch.audio.fbank import FbankConfig, fbank_numpy
from seamless_communication_torch.streaming.agents.common import (
    AgentStates, GenericAgent, ReadAction, SpeechSegment, WriteAction,
)

SHIFT_SIZE = 10
WINDOW_SIZE = 25
SAMPLE_RATE = 16000
FEATURE_DIM = 80


class FeatureStates(AgentStates):
    def reset(self) -> None:
        super().reset()
        self.previous_residual_samples: List[float] = []


class OnlineFeatureExtractorAgent(GenericAgent):
    source_type = "speech"
    target_type = "speech"

    def __init__(self, *, shift_size: int = SHIFT_SIZE, window_size: int = WINDOW_SIZE,
                 sample_rate: int = SAMPLE_RATE, denormalize: bool = False, args=None):
        self.shift_size = shift_size
        self.window_size = window_size
        self.sample_rate = sample_rate
        self.num_samples_per_shift = int(shift_size * sample_rate / 1000)
        self.num_samples_per_window = int(window_size * sample_rate / 1000)
        # streamed input is already 16-bit-int scaled unless denormalize is set
        self.fbank_cfg = FbankConfig(waveform_scale=2.0 ** 15 if denormalize else 1.0)
        super().__init__(args)

    def build_states(self) -> FeatureStates:
        return FeatureStates()

    def policy(self, states: FeatureStates):
        if len(states.source) == 0:
            if states.source_finished:
                return WriteAction(SpeechSegment(
                    content=np.zeros((0, FEATURE_DIM), np.float32), is_empty=True),
                    finished=True)
            return ReadAction()

        samples = states.previous_residual_samples + list(states.source[-1])
        if len(samples) < self.num_samples_per_window:
            states.previous_residual_samples = samples
            return ReadAction()

        ms_to_samples = self.sample_rate / 1000
        num_frames = math.floor(
            (len(samples) - (self.window_size - self.shift_size) * ms_to_samples)
            / self.num_samples_per_shift)
        effective = int(num_frames * self.shift_size * ms_to_samples
                        + (self.window_size - self.shift_size) * ms_to_samples)
        input_samples = np.asarray(samples[:effective], np.float32)
        states.previous_residual_samples = samples[num_frames * self.num_samples_per_shift:]
        fbank = fbank_numpy(input_samples, self.fbank_cfg)
        return WriteAction(SpeechSegment(content=fbank, tgt_lang=states.tgt_lang,
                                         finished=states.source_finished),
                           finished=states.source_finished)
