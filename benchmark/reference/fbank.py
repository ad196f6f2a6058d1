"""Kaldi's 80-bin log-mel filterbank (``compute-fbank-feats`` defaults as
SeamlessM4T's feature extractor sets them) in NumPy float64: 25 ms frames
every 10 ms at 16 kHz with no padding, each frame's mean removed,
pre-emphasis 0.97 with the first sample repeated, the Povey window
(Hann^0.85), a 512-point FFT's power spectrum, triangular filters equally
spaced on Kaldi's mel scale 1127 ln(1 + f / 700) from 20 Hz to Nyquist, and
the natural log with floor FLT_EPSILON."""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
FRAME, HOP, NFFT, MELS = 400, 160, 512, 80
FLOOR = float(np.finfo(np.float32).eps)


def _mel(f):
    return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)


def mel_filters() -> np.ndarray:
    """(257, 80) triangular weights."""
    edges = np.linspace(_mel(20.0), _mel(SAMPLE_RATE / 2), MELS + 2)
    bins = _mel(np.arange(NFFT // 2 + 1) * SAMPLE_RATE / NFFT)
    lo, mid, hi = edges[:-2], edges[1:-1], edges[2:]
    rise = (bins[:, None] - lo) / (mid - lo)
    fall = (hi - bins[:, None]) / (hi - mid)
    return np.clip(np.minimum(rise, fall), 0.0, None)


def fbank(wav: np.ndarray, scale: float) -> np.ndarray:
    """(samples,) waveform times ``scale`` -> (frames, 80) float32 log-mels."""
    x = np.asarray(wav, np.float64) * scale
    n = 0 if len(x) < FRAME else 1 + (len(x) - FRAME) // HOP
    frames = np.lib.stride_tricks.sliding_window_view(x, FRAME)[::HOP][:n].copy()
    frames -= frames.mean(axis=1, keepdims=True)
    prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames - 0.97 * prev
    window = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(FRAME) / (FRAME - 1))) ** 0.85
    power = np.abs(np.fft.rfft(frames * window, n=NFFT, axis=1)) ** 2
    return np.log(np.maximum(power @ mel_filters(), FLOOR)).astype(np.float32)


def normalize_utterance(f: np.ndarray) -> np.ndarray:
    """One mean and standard deviation over the whole utterance."""
    f64 = f.astype(np.float64)
    return ((f64 - f64.mean()) / (f64.std() + 1e-7)).astype(np.float32)


def stream_fbank_frames(chunks: list, n_drain: int) -> np.ndarray:
    """The log-mels a streaming session's feature agent emits over its
    life, concatenated: each 320 ms chunk's samples appended to the ones
    left over (frames are cut every 10 ms, the 15 ms tail kept), the
    waveform already at the 16-bit scale. After the source has ended, each
    of ``n_drain`` further ticks cuts the leftover samples and the last
    chunk again (the agent reads its last source chunk at every tick)."""
    out, rest = [], np.zeros(0, np.float64)
    for c in list(chunks) + [chunks[-1]] * n_drain:
        s = np.concatenate([rest, np.asarray(c, np.float64)])
        if len(s) < FRAME:
            rest = s
            continue
        n = (len(s) - (FRAME - HOP)) // HOP
        out.append(fbank(s[:n * HOP + FRAME - HOP], 1.0))
        rest = s[n * HOP:]
    return np.concatenate(out) if out else np.zeros((0, MELS), np.float32)
