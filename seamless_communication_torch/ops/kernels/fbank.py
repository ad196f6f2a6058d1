"""Kaldi 80-mel log filterbank of a waveform, on the device.

    (num_samples,) f32 waveform in [-1, 1] -> (max_frames, num_mel) f32

Per frame f: the samples [160 f, 160 f + 400) of waveform * 32768 (zero past
the end), less their mean, pre-emphasis 0.97 (the first sample replicated),
the Povey window, the 512-point DFT of the 400 samples zero-padded to 512
(257 bins), the power, the Kaldi mel product, then log(max(., MEL_FLOOR)).
The Translator computes its fbank with numpy on the host (``audio/fbank.py
fbank_numpy``); no path of the port calls this function, as no path of the
JAX package calls its TPU kernel.

``fbank``: CUDA kernel ``csrc/fbank.cu``, which replaces the TPU kernel
``_kernel`` of ``seamless_communication_tpu/ops/kernels/fbank_pallas.py:74``
(wrapper ``fbank_pallas``, :114). For a waveform on the CPU it computes
``_reference``, the plain PyTorch version of the same function, which is also
what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from seamless_communication_torch.audio.fbank import (
    MEL_FLOOR, kaldi_mel_filters, povey_window,
)
from seamless_communication_torch.ops.kernels import launch_counts

KERNEL = "fbank"
FRAME_BLOCK = 128             # max_frames must be a multiple of this
FRAME_LEN = 400
HOP = 160
NFFT = 512
BINS = NFFT // 2 + 1          # 257
BINS_PAD = 384                # the [cos | sin] halves of the plain version's basis
MEL_PAD = 128
SCALE = 32768.0
PREEMPH = 0.97


@lru_cache(maxsize=2)
def _bases(num_mel: int, sample_rate: int):
    """The plain version's windowed [cos | sin] DFT basis (400, 2*BINS_PAD)
    and mel matrix (BINS_PAD, MEL_PAD), fp32 (the JAX kernel's ``_bases``)."""
    n = FRAME_LEN
    t = np.arange(n)[:, None]
    k = np.arange(BINS)[None, :]
    ang = -2.0 * np.pi * t * k / NFFT
    win = povey_window(n)[:, None]
    basis = np.zeros((n, 2 * BINS_PAD), np.float32)
    basis[:, :BINS] = np.cos(ang) * win
    basis[:, BINS_PAD:BINS_PAD + BINS] = np.sin(ang) * win
    mel = np.zeros((BINS_PAD, MEL_PAD), np.float32)
    mel[:BINS, :num_mel] = kaldi_mel_filters(BINS, num_mel, sample_rate, 20.0,
                                             sample_rate / 2)
    return basis, mel


@lru_cache(maxsize=2)
def _kernel_tables(num_mel: int, sample_rate: int):
    """What the kernel reads besides the waveform, fp32: the Povey window
    (400,), cos and sin of 2*pi*i/512 for i < 512 (the DFT twiddles, indexed
    by (n*k) mod 512), and the (BINS, num_mel) mel matrix."""
    i = np.arange(NFFT)
    return (povey_window(FRAME_LEN).astype(np.float32),
            np.cos(2.0 * np.pi * i / NFFT).astype(np.float32),
            np.sin(2.0 * np.pi * i / NFFT).astype(np.float32),
            kaldi_mel_filters(BINS, num_mel, sample_rate, 20.0,
                              sample_rate / 2).astype(np.float32))


def _frames(waveform: torch.Tensor, max_frames: int) -> torch.Tensor:
    """(max_frames, 400) frames of waveform * 32768, zero past the end."""
    need = (max_frames + 2) * HOP
    x = waveform.float() * SCALE
    x = torch.nn.functional.pad(x, (0, max(0, need - x.shape[0])))[:need]
    idx = (torch.arange(max_frames, device=x.device)[:, None] * HOP
           + torch.arange(FRAME_LEN, device=x.device)[None, :])
    return x[idx]


_tables: dict = {}


def _on_device(kind: str, device: torch.device, num_mel: int, sample_rate: int) -> list:
    """The tables of ``kind`` ("bases" for the plain version, "kernel") as
    tensors on ``device``, copied there once."""
    key = (kind, device, num_mel, sample_rate)
    if key not in _tables:
        make = _bases if kind == "bases" else _kernel_tables
        _tables[key] = [torch.as_tensor(a, device=device) for a in make(num_mel, sample_rate)]
    return _tables[key]


def _reference(waveform: torch.Tensor, max_frames: int, num_mel: int = 80,
               sample_rate: int = 16000) -> torch.Tensor:
    """Plain PyTorch version: the frames, their DC removal and pre-emphasis,
    then fp32 products with the windowed DFT basis and the mel matrix."""
    basis, mel = _on_device("bases", waveform.device, num_mel, sample_rate)
    fr = _frames(waveform, max_frames)
    fr = fr - fr.mean(dim=1, keepdim=True)
    fr = fr - PREEMPH * torch.cat([fr[:, :1], fr[:, :-1]], dim=1)
    spec = fr @ basis
    power = spec[:, :BINS_PAD] ** 2 + spec[:, BINS_PAD:] ** 2
    return torch.log(torch.clamp_min(power @ mel, MEL_FLOOR))[:, :num_mel]


_function: list = []


def _launch(waveform: torch.Tensor, max_frames: int, num_mel: int,
            sample_rate: int) -> torch.Tensor:
    if waveform.dtype != torch.float32 or waveform.ndim != 1:
        raise ValueError(f"{KERNEL}: waveform is {tuple(waveform.shape)} "
                         f"{waveform.dtype}, expected (num_samples,) float32")
    if not waveform.is_contiguous():
        raise ValueError(f"{KERNEL}: waveform is not contiguous")
    if num_mel > MEL_PAD:
        raise ValueError(f"{KERNEL}: num_mel {num_mel} exceeds {MEL_PAD}")
    if not _function:
        from seamless_communication_torch.ops.kernels import build

        lib = build.load("fbank")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fbank.argtypes = [p, i, p, p, p, p, i, i, p, p]
        lib.fbank.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _function.extend([lib.fbank, lib.cuda_error_string])
    fn, error_string = _function
    win, cos, sin, mel = _on_device("kernel", waveform.device, num_mel, sample_rate)
    out = torch.empty((max_frames, num_mel), dtype=torch.float32, device=waveform.device)
    with torch.cuda.device(waveform.device):
        stream = torch.cuda.current_stream(waveform.device).cuda_stream
        err = fn(waveform.data_ptr(), waveform.shape[0], win.data_ptr(), cos.data_ptr(),
                 sin.data_ptr(), mel.data_ptr(), num_mel, max_frames, out.data_ptr(),
                 stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed: {error_string(err).decode()} ({err})")
    launch_counts[KERNEL] += 1
    return out


def fbank(waveform: torch.Tensor, *, max_frames: int, num_mel: int = 80,
          sample_rate: int = 16000) -> torch.Tensor:
    """(num_samples,) float32 waveform in [-1, 1] -> (max_frames, num_mel)
    log-mel fbank. ``max_frames`` must be a multiple of 128; frames past the
    waveform's end read zeros (so frames wholly past it hold
    log(MEL_FLOOR)). A CPU waveform takes the plain version; a CUDA one
    launches the kernel, and anything the kernel does not take raises."""
    if max_frames % FRAME_BLOCK:
        raise ValueError(f"{KERNEL}: max_frames {max_frames} is not a multiple of "
                         f"{FRAME_BLOCK}")
    if waveform.device.type == "cpu":
        return _reference(waveform, max_frames, num_mel, sample_rate)
    if waveform.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {waveform.device}")
    return _launch(waveform, max_frames, num_mel, sample_rate)


def needed_frames(num_samples: int, max_frames: int) -> int:
    """Frames of ``max_frames`` that read at least one sample of the
    waveform; the others are log(MEL_FLOOR) whatever the waveform."""
    return min(max_frames, -(-num_samples // HOP))


def bound(num_samples: int, max_frames: int, num_mel: int = 80,
          sample_rate: int = 16000) -> tuple[int, int]:
    """(bytes, fp32 operations) the function must spend: the waveform's
    samples that some frame reads, in once, and the output, out once. Per
    frame that reads a sample, the least work of any way to compute it: the
    DC removal, pre-emphasis and window (5 flops a sample), a real 512-point
    FFT (2.5 N log2 N flops, N = 512), the 257 powers (3 flops each), the
    mel product over the filters' nonzero weights only (2 flops each) and
    the num_mel logs (1 each). The kernel itself spends far more: it sums
    the DFT directly, 400 x 257 complex products a frame."""
    frames = needed_frames(num_samples, max_frames)
    samples = min(num_samples, (max_frames + 2) * HOP)
    mel_nonzero = int(np.count_nonzero(_kernel_tables(num_mel, sample_rate)[3]))
    fft = int(2.5 * NFFT * np.log2(NFFT))
    flops = frames * (5 * FRAME_LEN + fft + 3 * BINS + 2 * mel_nonzero + num_mel)
    return 4 * samples + 4 * max_frames * num_mel, flops
