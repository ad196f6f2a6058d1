"""Denoising front end (a copy of
``seamless_communication_tpu/denoise/denoiser.py``; the reference,
denoise/demucs.py:45-120, shells out to the demucs CLI): a built-in
spectral-subtraction denoiser in host numpy, and the demucs command where it
is on ``PATH``.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from seamless_communication_torch.audio.wav import read_wav, resample, write_wav


@dataclass
class DenoisingConfig:
    model: str = "htdemucs"
    two_stems: Optional[str] = "vocals"
    float32: bool = True
    sample_rate: int = 16000


class Denoiser:
    def __init__(self, cfg: DenoisingConfig = DenoisingConfig()):
        self.cfg = cfg

    def denoise(self, waveform: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        """External demucs if installed (reference behavior), else spectral
        subtraction."""
        if shutil.which("demucs"):
            return self._demucs(waveform, sample_rate)
        return self.spectral_subtract(waveform, sample_rate)

    def _demucs(self, waveform: np.ndarray, sample_rate: int) -> np.ndarray:
        with tempfile.TemporaryDirectory() as td:
            inp = Path(td) / "in.wav"
            write_wav(str(inp), waveform, sample_rate)
            cmd = ["demucs", str(inp), "-o", td, "-n", self.cfg.model]
            if self.cfg.two_stems:
                cmd += ["--two-stems", self.cfg.two_stems]
            if self.cfg.float32:
                cmd += ["--float32"]
            subprocess.run(cmd, check=True, capture_output=True)
            out = Path(td) / self.cfg.model / "in" / f"{self.cfg.two_stems}.wav"
            wav, sr = read_wav(str(out))
            return resample(wav, sr, self.cfg.sample_rate)

    @staticmethod
    def spectral_subtract(waveform: np.ndarray, sample_rate: int = 16000, *,
                          frame: int = 512, noise_percentile: float = 10.0
                          ) -> np.ndarray:
        """Simple magnitude spectral subtraction with a noise floor estimated from
        the quietest frames."""
        x = np.asarray(waveform, np.float32)
        hop = frame // 2
        n = max(0, (len(x) - frame) // hop + 1)
        if n < 4:
            return x
        win = np.hanning(frame).astype(np.float32)
        frames = np.stack([x[i * hop:i * hop + frame] * win for i in range(n)])
        spec = np.fft.rfft(frames, axis=1)
        mag = np.abs(spec)
        energy = mag.sum(axis=1)
        k = max(1, int(n * noise_percentile / 100))
        noise = mag[np.argsort(energy)[:k]].mean(axis=0, keepdims=True)
        clean = np.maximum(mag - 1.5 * noise, 0.1 * mag)
        out_spec = clean * np.exp(1j * np.angle(spec))
        frames_out = np.fft.irfft(out_spec, n=frame, axis=1).astype(np.float32)
        out = np.zeros_like(x)
        norm = np.zeros_like(x)
        for i in range(n):
            out[i * hop:i * hop + frame] += frames_out[i] * win
            norm[i * hop:i * hop + frame] += win ** 2
        return out / np.maximum(norm, 1e-8)
