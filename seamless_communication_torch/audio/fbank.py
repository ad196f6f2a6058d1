"""Kaldi-compatible 80-mel log filterbank on the host (numpy), the features
the Translator feeds the speech encoder. A copy of the numpy half of
``seamless_communication_tpu/audio/fbank.py``:

  - waveform scaled by 2**15
  - 25 ms window / 10 ms hop at 16 kHz (400/160 samples), no centering
  - per-frame DC-offset removal, pre-emphasis 0.97 (edge-replicated), povey window
  - 512-point real FFT -> power spectrum (257 bins)
  - kaldi-mel triangular filters, 20 Hz .. nyquist, no normalization
  - natural log with floor 1.1921e-7
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MEL_FLOOR = 1.192092955078125e-07


@dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    num_mel_bins: int = 80
    frame_length: int = 400      # 25 ms
    hop_length: int = 160        # 10 ms
    fft_length: int = 512
    preemphasis: float = 0.97
    low_freq: float = 20.0
    waveform_scale: float = 2.0 ** 15


def povey_window(n: int) -> np.ndarray:
    """Kaldi 'povey' window: hann^0.85, non-periodic."""
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return hann ** 0.85


def kaldi_mel_filters(num_freq_bins: int, num_mel: int, sample_rate: int,
                      low_freq: float, high_freq: float) -> np.ndarray:
    """(num_freq_bins, num_mel) triangular filters built in mel space (kaldi
    scale 1127*ln(1+f/700), no area normalization)."""
    def hz_to_mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    mel_lo, mel_hi = hz_to_mel(low_freq), hz_to_mel(high_freq)
    mel_pts = np.linspace(mel_lo, mel_hi, num_mel + 2)
    fft_hz = np.arange(num_freq_bins) * sample_rate / ((num_freq_bins - 1) * 2)
    fft_mel = hz_to_mel(fft_hz)
    left, center, right = mel_pts[:-2], mel_pts[1:-1], mel_pts[2:]
    up = (fft_mel[:, None] - left[None, :]) / (center - left)[None, :]
    down = (right[None, :] - fft_mel[:, None]) / (right - center)[None, :]
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float64)


def num_frames(num_samples: int, cfg: FbankConfig = FbankConfig()) -> int:
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.hop_length


def fbank_numpy(waveform: np.ndarray, cfg: FbankConfig = FbankConfig()) -> np.ndarray:
    """(num_samples,) float waveform in [-1, 1] -> (frames, num_mel_bins) fp32 log-mel."""
    x = np.asarray(waveform, np.float64) * cfg.waveform_scale
    T = num_frames(len(x), cfg)
    idx = np.arange(cfg.frame_length)[None, :] + cfg.hop_length * np.arange(T)[:, None]
    frames = x[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)               # remove DC
    shifted = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)  # edge-replicate
    frames = frames - cfg.preemphasis * shifted
    frames = frames * povey_window(cfg.frame_length)[None, :]
    spec = np.fft.rfft(frames, n=cfg.fft_length, axis=1)
    power = np.abs(spec) ** 2
    mel_f = kaldi_mel_filters(cfg.fft_length // 2 + 1, cfg.num_mel_bins,
                              cfg.sample_rate, cfg.low_freq, cfg.sample_rate / 2)
    mel = np.maximum(power @ mel_f, MEL_FLOOR)
    return np.log(mel).astype(np.float32)



def normalize_per_mel_bin(feats: np.ndarray) -> np.ndarray:
    """Per-mel-bin zero-mean, unit-variance normalization over the utterance
    (the HF feature extractor's ``do_normalize_per_mel_bins``)."""
    mean = feats.mean(axis=0, keepdims=True)
    std = feats.std(axis=0, keepdims=True)
    return ((feats - mean) / (std + 1e-7)).astype(np.float32)
