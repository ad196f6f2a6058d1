"""Dependency-free WAV I/O and polyphase resampling (a copy of
``seamless_communication_tpu/audio/wav.py``)."""

from __future__ import annotations

import struct
import wave
from math import gcd
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (mono float32 waveform in [-1, 1], sample_rate).
    PCM16/24/32 and float32."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, raw = 12, None, None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 3 or (audio_format == 0xFFFE and bits == 32):
        x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"{path}: unsupported WAV format {audio_format}/{bits}bit")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate


def write_wav(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """Write a mono float32 waveform in [-1, 1] as a PCM16 WAV (clipped,
    scaled by 32767 and truncated toward zero)."""
    pcm = np.clip(np.asarray(waveform, np.float32), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def resample(waveform: np.ndarray, orig_rate: int, new_rate: int) -> np.ndarray:
    """Polyphase resampling (brings arbitrary-rate inputs to 16 kHz)."""
    if orig_rate == new_rate:
        return np.asarray(waveform, np.float32)
    from scipy.signal import resample_poly
    g = gcd(orig_rate, new_rate)
    return resample_poly(waveform, new_rate // g, orig_rate // g).astype(np.float32)
