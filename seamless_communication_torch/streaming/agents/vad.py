"""Streaming VAD agent (counterpart of
``seamless_communication_tpu/streaming/agents/vad.py``; reference
streaming/agents/silero_vad.py): gates the pipeline on voice activity. Speech
chunks pass through untouched; silence accumulates, and once it reaches
``silence_limit_ms`` after speech, a finished chunk ends the utterance so
the downstream agents finalize. Host numpy.

The speech probability of each window comes from ``probs_fn``: by default
the energy VAD of ``segment/vad.py``, or a silero TorchScript model
(``segment.vad.make_silero_probs_fn``)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from seamless_communication_torch.segment.vad import energy_vad_probs
from seamless_communication_torch.streaming.agents.common import (
    AgentStates, EmptySegment, GenericAgent, ReadAction, SpeechSegment, WriteAction,
)


class VADStates(AgentStates):
    def reset(self) -> None:
        super().reset()
        self.consecutive_silence_ms = 0.0
        self.speech_started = False


class VADAgent(GenericAgent):
    source_type = "speech"
    target_type = "speech"

    def __init__(self, *, sample_rate: int = 16000, speech_threshold: float = 0.5,
                 silence_limit_ms: float = 700.0, window_size: int = 512,
                 probs_fn: Optional[Callable] = None, args=None):
        self.sample_rate = sample_rate
        self.speech_threshold = speech_threshold
        self.silence_limit_ms = silence_limit_ms
        self.window_size = window_size
        self.probs_fn = probs_fn or (lambda w: energy_vad_probs(w, window_size))
        super().__init__(args)

    def build_states(self) -> VADStates:
        return VADStates()

    def _write(self, states: VADStates, chunk: np.ndarray, *, seg_finished: bool,
               finished: bool) -> WriteAction:
        return WriteAction(SpeechSegment(content=list(chunk), tgt_lang=states.tgt_lang,
                                         finished=seg_finished), finished=finished)

    def policy(self, states: VADStates):
        if len(states.source) == 0:
            if states.source_finished:
                return WriteAction(EmptySegment(finished=True), finished=True)
            return ReadAction()

        chunk = np.asarray(states.source[-1], np.float32).reshape(-1)
        states.source = []
        probs = self.probs_fn(chunk)
        is_speech = bool(probs.size and probs.mean() >= self.speech_threshold)
        if is_speech:
            states.speech_started = True
            states.consecutive_silence_ms = 0.0
            return self._write(states, chunk, seg_finished=states.source_finished,
                               finished=states.source_finished)

        states.consecutive_silence_ms += len(chunk) / self.sample_rate * 1000.0
        if states.speech_started and states.consecutive_silence_ms >= self.silence_limit_ms:
            # end of an utterance: a finished chunk makes the downstream finalize
            states.speech_started = False
            states.consecutive_silence_ms = 0.0
            return self._write(states, chunk, seg_finished=True,
                               finished=states.source_finished)
        if states.source_finished:
            return self._write(states, chunk, seg_finished=True, finished=True)
        return ReadAction()
