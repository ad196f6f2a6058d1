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
(wrapper ``fbank_pallas``, :114): a warp a frame, the 512-point DFT as a
256-point complex FFT in shared memory and a split step, the mel product over
each filter's nonzero bins. For a waveform on the CPU it computes
``_reference``, the plain PyTorch version of the same function, which is also
what the kernel is held against on the card. ``_fft_reference`` repeats the
kernel's arithmetic in PyTorch (for the CPU tests only), and ``frame_plan``
mirrors its grid and shared memory.
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
    """What the kernel reads besides the waveform: the Povey window (400,),
    cos and sin of 2*pi*n/512 for n < 512 (the twiddles W_512^n = cos - i
    sin), all fp32 from fp64, the mel filters' nonzero weights compacted
    (filter by filter, bins ascending; fp32) and their ranges (num_mel, 3)
    int32: the bins [lo, hi) and the offset of the filter's first weight."""
    n = np.arange(NFFT)
    mel = kaldi_mel_filters(BINS, num_mel, sample_rate, 20.0,
                            sample_rate / 2).astype(np.float32)
    weights, ranges = [], np.zeros((num_mel, 3), np.int32)
    for m in range(num_mel):
        nz = np.flatnonzero(mel[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        if nz.size != hi - lo:
            raise ValueError(f"mel filter {m}: its nonzero bins are not one range")
        ranges[m] = (lo, hi, sum(len(w) for w in weights))
        weights.append(mel[lo:hi, m])
    return (povey_window(FRAME_LEN).astype(np.float32),
            np.cos(2.0 * np.pi * n / NFFT).astype(np.float32),
            np.sin(2.0 * np.pi * n / NFFT).astype(np.float32),
            np.concatenate(weights).astype(np.float32), ranges)


@lru_cache(maxsize=2)
def _packed_tables(num_mel: int, sample_rate: int) -> np.ndarray:
    """``_kernel_tables`` as the kernel copies them, one fp32 buffer: the
    window, cos, sin, the weights padded to a multiple of 4, then the ranges
    (int32 bits) padded likewise."""
    win, cos, sin, weights, ranges = _kernel_tables(num_mel, sample_rate)
    ranges = ranges.reshape(-1).view(np.float32)
    return np.concatenate([win, cos, sin, np.pad(weights, (0, -len(weights) % 4)),
                           np.pad(ranges, (0, -len(ranges) % 4))])


# the kernel's plan (csrc/fbank.cu): frames a block, and its static shared
# memory in floats
MAX_BLOCK_FRAMES = 8
PLANE = 288                   # a warp's re or im plane
MAX_MEL_WEIGHTS = 520
SMEM_LIMIT = 48 * 1024        # static shared memory a block may have


def frame_plan(max_frames: int) -> dict:
    """The kernel's grid at ``max_frames`` (a multiple of 128): a warp a
    frame, ``frames`` = min(8, max_frames / 128) frames a block, so that up
    to 1024 frames the grid is 128 blocks (one wave on 132 SMs); block b
    owns frames [b * frames, (b + 1) * frames). ``smem`` is the block's
    static shared memory in bytes: the samples of 8 frames, the window, the
    twiddles, the compacted mel weights and ranges, two planes a warp."""
    frames = min(MAX_BLOCK_FRAMES, max_frames // FRAME_BLOCK)
    stage = HOP * (MAX_BLOCK_FRAMES - 1) + FRAME_LEN
    tables = FRAME_LEN + 2 * NFFT + MAX_MEL_WEIGHTS + 3 * MEL_PAD
    smem = 4 * (stage + tables + 2 * MAX_BLOCK_FRAMES * PLANE)
    return {"frames": frames, "blocks": max_frames // frames, "threads": 32 * frames,
            "smem": smem}


def _frames(waveform: torch.Tensor, max_frames: int) -> torch.Tensor:
    """(max_frames, 400) frames of waveform * 32768, zero past the end."""
    need = (max_frames + 2) * HOP
    x = waveform.float() * SCALE
    x = torch.nn.functional.pad(x, (0, max(0, need - x.shape[0])))[:need]
    idx = (torch.arange(max_frames, device=x.device)[:, None] * HOP
           + torch.arange(FRAME_LEN, device=x.device)[None, :])
    return x[idx]


def _frames_prepared(waveform: torch.Tensor, max_frames: int) -> torch.Tensor:
    """(max_frames, 400) frames less their mean, pre-emphasized (the first
    sample replicated) and windowed: what the DFT takes."""
    fr = _frames(waveform, max_frames)
    fr = fr - fr.mean(dim=1, keepdim=True)
    fr = fr - PREEMPH * torch.cat([fr[:, :1], fr[:, :-1]], dim=1)
    win = torch.as_tensor(povey_window(FRAME_LEN).astype(np.float32), device=fr.device)
    return fr * win


_tables: dict = {}


def _on_device(kind: str, device: torch.device, num_mel: int, sample_rate: int) -> list:
    """The tables of ``kind`` ("bases" for the plain version, "kernel") as
    tensors on ``device``, copied there once."""
    key = (kind, device, num_mel, sample_rate)
    if key not in _tables:
        tables = (_bases(num_mel, sample_rate) if kind == "bases"
                  else [_packed_tables(num_mel, sample_rate)])
        _tables[key] = [torch.as_tensor(a, device=device) for a in tables]
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


def _dft8(r, i):
    """The kernel's 8-point forward DFT over the last axis of (r, i): a
    radix-2 step (x_m +- x_{m+4}, the difference times W_8^m), then two
    4-point DFTs; output in natural order."""
    h = 0.70710678118654752
    ar, ai = r[..., :4] + r[..., 4:], i[..., :4] + i[..., 4:]
    br, bi = r[..., :4] - r[..., 4:], i[..., :4] - i[..., 4:]
    (x0, x1, x2, x3), (y0, y1, y2, y3) = br.unbind(-1), bi.unbind(-1)
    br = torch.stack([x0, (x1 + y1) * h, y2, (y3 - x3) * h], dim=-1)
    bi = torch.stack([y0, (y1 - x1) * h, -x2, -(x3 + y3) * h], dim=-1)
    er, ei = _dft4(ar, ai)
    orr, oi = _dft4(br, bi)
    return (torch.stack([er, orr], dim=-1).flatten(-2),
            torch.stack([ei, oi], dim=-1).flatten(-2))


def _dft4(r, i):
    """The kernel's 4-point forward DFT over the last axis."""
    t0r, t0i = r[..., 0] + r[..., 2], i[..., 0] + i[..., 2]
    t1r, t1i = r[..., 0] - r[..., 2], i[..., 0] - i[..., 2]
    t2r, t2i = r[..., 1] + r[..., 3], i[..., 1] + i[..., 3]
    t3r, t3i = i[..., 1] - i[..., 3], r[..., 3] - r[..., 1]
    return (torch.stack([t0r + t2r, t1r + t3r, t0r - t2r, t1r - t3r], dim=-1),
            torch.stack([t0i + t2i, t1i + t3i, t0i - t2i, t1i - t3i], dim=-1))


def _twiddle(r, i, c, s):
    """(r, i) times W = c - i s."""
    return r * c + i * s, i * c - r * s


def _fft256_reference(zr, zi, cos_t, sin_t):
    """The kernel's 256-point FFT of z (..., 256) in its three stages, with
    n = j + 32 m = ja + 4 jb + 32 m and k = p + 8 qb + 64 qa (the header of
    csrc/fbank.cu): A over m, B over jb, C over ja. Returns Z (..., 256)."""
    lead = zr.shape[:-1]
    # A: [m, j] -> 8-point DFT over m, times W_512^(2 j p) -> A[p, j]
    r, i = (t.reshape(*lead, 8, 32).transpose(-1, -2) for t in (zr, zi))   # [j, m]
    r, i = _dft8(r, i)                                                        # [j, p]
    tw = (2 * torch.arange(32)[:, None] * torch.arange(8)[None, :]) % NFFT
    r, i = _twiddle(r, i, cos_t[tw], sin_t[tw])
    r, i = (t.transpose(-1, -2) for t in (r, i))                             # [p, j]
    # B: j = ja + 4 jb -> [p, ja, jb], 8-point DFT over jb, times W_512^(16 ja qb)
    r, i = (t.reshape(*lead, 8, 8, 4).transpose(-1, -2) for t in (r, i))     # [p, ja, jb]
    r, i = _dft8(r, i)                                                        # [p, ja, qb]
    tw = 16 * torch.arange(4)[:, None] * torch.arange(8)[None, :]
    r, i = _twiddle(r, i, cos_t[tw], sin_t[tw])
    # C: 4-point DFT over ja -> [p, qb, qa], k = p + 8 qb + 64 qa
    r, i = (t.transpose(-1, -2) for t in (r, i))                             # [p, qb, ja]
    r, i = _dft4(r, i)                                                        # [p, qb, qa]
    r, i = (t.permute(*range(len(lead)), -1, -2, -3).reshape(*lead, 256) for t in (r, i))
    return r, i


def _fft_reference(waveform: torch.Tensor, max_frames: int, num_mel: int = 80,
                   sample_rate: int = 16000) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (for the CPU tests; the
    wrapper's plain version is ``_reference``): the prepared frames as z[j]
    = y[2j] + i y[2j+1], the 256-point FFT in the kernel's radix stages, the
    split step to the 257 bins, the power, and the mel sums over each
    filter's compacted range in ascending bin order, then the log."""
    _, cos_t, sin_t, weights, ranges = (
        torch.as_tensor(a) for a in _kernel_tables(num_mel, sample_rate))
    y = torch.nn.functional.pad(_frames_prepared(waveform.cpu(), max_frames),
                                (0, NFFT - FRAME_LEN))
    zr, zi = _fft256_reference(y[:, 0::2], y[:, 1::2], cos_t, sin_t)
    k = torch.arange(BINS)
    a, b = zr[:, k % 256], zi[:, k % 256]
    c, d = zr[:, (256 - k) % 256], zi[:, (256 - k) % 256]
    u, v = 0.5 * (b + d), 0.5 * (c - a)
    xr = 0.5 * (a + c) + cos_t[k] * u + sin_t[k] * v
    xi = 0.5 * (b - d) + cos_t[k] * v - sin_t[k] * u
    power = xr * xr + xi * xi
    out = torch.zeros((max_frames, num_mel))
    for m, (lo, hi, off) in enumerate(ranges.tolist()):
        acc = torch.zeros(max_frames)
        for j in range(hi - lo):
            acc = acc + power[:, lo + j] * weights[off + j]
        out[:, m] = acc
    return torch.log(torch.clamp_min(out, MEL_FLOOR)).to(waveform.device)


_function: list = []
# the C entry point's argument types (ctypes would pass a Python int as a
# 32-bit int and cut the pointers)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, *[ctypes.c_int] * 3,
             ctypes.c_void_p, ctypes.c_void_p]


def _launch(waveform: torch.Tensor, max_frames: int, num_mel: int,
            sample_rate: int) -> torch.Tensor:
    if waveform.dtype != torch.float32 or waveform.ndim != 1:
        raise ValueError(f"{KERNEL}: waveform is {tuple(waveform.shape)} "
                         f"{waveform.dtype}, expected (num_samples,) float32")
    if not waveform.is_contiguous() or waveform.data_ptr() % 16:
        raise ValueError(f"{KERNEL}: waveform is not contiguous and 16-byte aligned")
    if num_mel > MEL_PAD:
        raise ValueError(f"{KERNEL}: num_mel {num_mel} exceeds {MEL_PAD}")
    if not _function:
        from seamless_communication_torch.ops.kernels import build

        lib = build.load("fbank")
        lib.fbank.argtypes, lib.fbank.restype = _ARGTYPES, ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _function.extend([lib.fbank, lib.cuda_error_string])
    fn, error_string = _function
    n_weights = _kernel_tables(num_mel, sample_rate)[3].shape[0]
    if n_weights > MAX_MEL_WEIGHTS:
        raise ValueError(f"{KERNEL}: {n_weights} nonzero mel weights exceed "
                         f"{MAX_MEL_WEIGHTS}")
    (tables,) = _on_device("kernel", waveform.device, num_mel, sample_rate)
    out = torch.empty((max_frames, num_mel), dtype=torch.float32, device=waveform.device)
    with torch.cuda.device(waveform.device):
        stream = torch.cuda.current_stream(waveform.device).cuda_stream
        err = fn(waveform.data_ptr(), waveform.shape[0], tables.data_ptr(), n_weights,
                 num_mel, max_frames, out.data_ptr(), stream)
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
    the num_mel logs (1 each). The kernel's FFT is a 256-point complex
    FFT and a split step, close to that count."""
    frames = needed_frames(num_samples, max_frames)
    samples = min(num_samples, (max_frames + 2) * HOP)
    mel_nonzero = int(np.count_nonzero(_kernel_tables(num_mel, sample_rate)[3]))
    fft = int(2.5 * NFFT * np.log2(NFFT))
    flops = frames * (5 * FRAME_LEN + fft + 3 * BINS + 2 * mel_nonzero + num_mel)
    return 4 * samples + 4 * max_frames * num_mel, flops
