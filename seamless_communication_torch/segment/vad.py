"""VAD segmentation of long audio (a copy of
``seamless_communication_tpu/segment/vad.py``; reference
segment/silero_vad.py:17-287). Host numpy, as in the JAX package.

The reference downloads silero-vad through torch.hub; here the speech
probability of each window comes from a plug-in (``probs_fn``), by default a
dependency-free energy VAD, or a silero TorchScript file
(``make_silero_probs_fn``). The pdac recursive split (split a segment at its
lowest-probability window until each is shorter than ``chunk_size_sec``) is
the reference's (silero_vad.py:95-170). This is also how the reference
handles long inputs instead of sequence parallelism.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


class _Segment:
    def __init__(self, start: int, end: int, probs: np.ndarray):
        self.start = start
        self.end = end
        self.probs = probs

    @property
    def duration(self) -> float:
        return self.end - self.start


def energy_vad_probs(waveform: np.ndarray, window_size: int = 512) -> np.ndarray:
    """Per-window speech probability from log-energy, normalized to [0,1]."""
    n = len(waveform) // window_size
    if n == 0:
        return np.zeros((0,), np.float32)
    frames = waveform[:n * window_size].reshape(n, window_size)
    energy = np.log10(np.mean(frames ** 2, axis=1) + 1e-10)
    lo, hi = np.percentile(energy, 5), np.percentile(energy, 95)
    return np.clip((energy - lo) / max(hi - lo, 1e-6), 0.0, 1.0).astype(np.float32)


def make_silero_probs_fn(model_path: str, *, sample_rate: int = 16000,
                         window_size: int = 512
                         ) -> Callable[[np.ndarray], np.ndarray]:
    """Wrap a real silero-vad model (torchscript .jit file, the format
    torch.hub distributes — reference segment/silero_vad.py:40-46 downloads it
    via torch.hub) as a ``probs_fn`` for :class:`VADSegmenter`. The model is
    stateful and sequential, so windows are scored in order with a state reset
    per utterance (reference SileroVADSegmenter uses the same
    512-samples@16 kHz windows)."""
    import torch

    model = torch.jit.load(model_path, map_location="cpu")
    model.eval()

    def probs_fn(waveform: np.ndarray) -> np.ndarray:
        try:
            model.reset_states()
        except (AttributeError, RuntimeError):
            pass
        n = len(waveform) // window_size
        out = np.zeros((n,), np.float32)
        with torch.no_grad():
            for i in range(n):
                chunk = torch.from_numpy(
                    np.asarray(waveform[i * window_size:(i + 1) * window_size],
                               np.float32))
                out[i] = float(model(chunk, sample_rate).item())
        return out

    return probs_fn


class VADSegmenter:
    def __init__(self, sample_rate: int = 16000, chunk_size_sec: float = 10.0,
                 pause_length: float = 0.5, window_size: int = 512,
                 threshold: float = 0.5,
                 probs_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.sample_rate = sample_rate
        self.chunk_size_sec = chunk_size_sec
        self.pause_length = pause_length
        self.window_size = window_size
        self.threshold = threshold
        self.probs_fn = probs_fn or (
            lambda w: energy_vad_probs(w, self.window_size))

    # -- pdac splitting (reference silero_vad.py:95-170) ----------------------

    def _trim(self, sgm: _Segment) -> _Segment:
        idx = np.where(sgm.probs >= self.threshold)[0]
        if len(idx) == 0:
            return _Segment(sgm.start, sgm.start, np.empty(0))
        i0, i1 = idx[0], idx[-1]
        return _Segment(sgm.start + i0 * self.window_size,
                        sgm.start + (i1 + 1) * self.window_size,
                        sgm.probs[i0:i1 + 1])

    def _split(self, sgm: _Segment, split_idx: int) -> Tuple[_Segment, _Segment]:
        a = _Segment(sgm.start, sgm.start + split_idx * self.window_size,
                     sgm.probs[:split_idx])
        b = _Segment(sgm.start + (split_idx + 1) * self.window_size, sgm.end,
                     sgm.probs[split_idx + 1:])
        return self._trim(a), self._trim(b)

    def _recursive_split(self, sgm: _Segment, out: List[_Segment],
                         max_len: float, min_len: float) -> None:
        if sgm.duration < max_len:
            if sgm.duration > 0:
                out.append(sgm)
            return
        order = np.argsort(sgm.probs)
        sgm_a = sgm_b = None
        for split_idx in order:
            sgm_a, sgm_b = self._split(sgm, int(split_idx))
            if sgm_a.duration > min_len and sgm_b.duration > min_len:
                self._recursive_split(sgm_a, out, max_len, min_len)
                self._recursive_split(sgm_b, out, max_len, min_len)
                return
        if sgm_a is not None and sgm_a.duration > min_len:
            self._recursive_split(sgm_a, out, max_len, min_len)
        if sgm_b is not None and sgm_b.duration > min_len:
            self._recursive_split(sgm_b, out, max_len, min_len)

    # -- public API ------------------------------------------------------------

    def segment_long_input(self, waveform: np.ndarray) -> List[Tuple[int, int]]:
        """Return (start_sample, end_sample) chunks each <= chunk_size_sec."""
        probs = self.probs_fn(np.asarray(waveform, np.float32))
        max_len = self.chunk_size_sec * self.sample_rate
        min_len = self.pause_length * self.sample_rate
        segments: List[_Segment] = []
        root = self._trim(_Segment(0, len(probs) * self.window_size, probs))
        if root.duration > 0:
            self._recursive_split(root, segments, max_len, min_len)
        return [(int(s.start), int(s.end)) for s in segments]


def strip_silence(waveform: np.ndarray, *, window_size: int = 512,
                  threshold: float = 0.5,
                  probs_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None
                  ) -> np.ndarray:
    """Remove leading/trailing silence from one utterance: keep
    [first speech window start, last speech window end) — the streaming
    dataloader's default preprocessing (reference
    streaming/dataloaders/s2tt.py:48-81 SileroVADSilenceRemover: first
    timestamp's start to last timestamp's end; the full waveform when no
    speech is detected). ``probs_fn`` plugs in the real silero model
    (make_silero_probs_fn); default is the dependency-free energy VAD, gated
    by an absolute rms floor so silence-only input is returned unchanged (the
    percentile-normalized energy probs are otherwise relative and would mark
    "speech" in any input)."""
    waveform = np.asarray(waveform, np.float32)
    if probs_fn is None:
        probs = energy_vad_probs(waveform, window_size)
        n = len(waveform) // window_size
        if n:
            frames = waveform[:n * window_size].reshape(n, window_size)
            rms = np.sqrt(np.mean(frames ** 2, axis=1))
            probs = np.where(rms >= 5e-4, probs, 0.0)
    else:
        probs = probs_fn(waveform)
    idx = np.where(np.asarray(probs) >= threshold)[0]
    if len(idx) == 0:
        return waveform
    return waveform[int(idx[0]) * window_size:int(idx[-1] + 1) * window_size]
