"""The SEANet/EnCodec streamable conv stack, PRETSSEL's waveform post-filter
(counterpart of ``seamless_communication_tpu/models/pretssel/streamable.py``).

Pieces: the streamable conv (EnCodec padding, causal or centred), the
transposed conv trimmed on the right, two-conv residual blocks (ELU, kernels
[3, 1]), and the skip-connected LSTM. All (B, T, C); weight norm folded at
load.

The LSTM runs as one ``torch.lstm`` call over all its layers (cuDNN on the
card), where the JAX package scans a step at a time: at 10 s of 24 kHz audio
a layer has about 750 steps. The weights map exactly: the gates are i, f, g,
o in both packages, ``wx``'s weight and bias become ``weight_ih`` and
``bias_ih``, ``wh``'s weight ``weight_hh``, and ``bias_hh`` is zero (the
converter folds the checkpoint's two biases into ``wx``'s, as JAX's does).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from seamless_communication_torch.ops.modules import (
    conv1d, conv1d_init, conv_transpose1d, conv_transpose1d_init, linear_init,
)

ELU_ALPHA = 1.0


def _elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x, alpha=ELU_ALPHA)


def streamable_conv(params: dict, x: torch.Tensor, *, stride: int = 1,
                    dilation: int = 1, causal: bool = False) -> torch.Tensor:
    """Conv with EnCodec's padding: k_eff - stride in all, plus the zeros
    that make the last frame whole on the right; causal puts the k_eff -
    stride on the left, centred splits it with an odd total's extra zero on
    the left."""
    k = params["weight"].shape[0]
    k_eff = (k - 1) * dilation + 1
    T = x.shape[1]
    n_frames = (T - k_eff + (k_eff - stride)) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + k_eff - (k_eff - stride)
    extra = max(0, int(ideal - T))
    total_pad = k_eff - stride
    if causal:
        pad = (total_pad, extra)
    else:
        right = total_pad // 2
        pad = (total_pad - right, right + extra)
    return conv1d(params, x, stride=stride, padding=pad, dilation=dilation)


def streamable_conv_transpose(params: dict, x: torch.Tensor, *, stride: int,
                              causal: bool = False,
                              trim_right_ratio: float = 1.0) -> torch.Tensor:
    """Transposed conv with k - stride samples trimmed: on the right by
    ``trim_right_ratio`` when causal, else split with the odd one on the
    left."""
    k = params["weight"].shape[0]
    y = conv_transpose1d(params, x, stride=stride, padding=0)
    pad_total = k - stride
    if causal:
        pad_right = math.ceil(pad_total * trim_right_ratio)
        pad_left = pad_total - pad_right
    else:
        pad_right = pad_total // 2
        pad_left = pad_total - pad_right
    return y[:, pad_left:y.shape[1] - pad_right]


# ---------------------------------------------------------------------------
# resnet block
# ---------------------------------------------------------------------------

def resnet_block_init(gen: torch.Generator, dim: int, kernel_sizes=(3, 1), *,
                      compress: int = 2, true_skip: bool = True, dtype=torch.float32,
                      device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    hidden = dim // compress
    p = {"conv1": conv1d_init(gen, dim, hidden, kernel_sizes[0], **kw),
         "conv2": conv1d_init(gen, hidden, dim, kernel_sizes[1], **kw)}
    if not true_skip:
        p["shortcut"] = conv1d_init(gen, dim, dim, 1, **kw)
    return p


def resnet_block(p: dict, x: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
    h = streamable_conv(p["conv1"], _elu(x), causal=causal)
    h = streamable_conv(p["conv2"], _elu(h), causal=causal)
    skip = x if "shortcut" not in p else streamable_conv(p["shortcut"], x, causal=causal)
    return skip + h


# ---------------------------------------------------------------------------
# LSTM (skip-connected)
# ---------------------------------------------------------------------------

def lstm_init(gen: torch.Generator, dim: int, num_layers: int, *, dtype=torch.float32,
              device=None) -> list:
    kw = dict(dtype=dtype, device=device)
    return [{"wx": linear_init(gen, dim, 4 * dim, **kw),
             "wh": linear_init(gen, dim, 4 * dim, bias=False, **kw)}
            for _ in range(num_layers)]


def lstm_forward(layers: list, x: torch.Tensor) -> torch.Tensor:
    """Multi-layer LSTM over (B, T, C), zero initial state, plus the skip
    connection (y + x). One ``torch.lstm`` call runs every layer."""
    if not layers:
        return x
    B, _, C = x.shape
    flat = []
    for p in layers:
        b = p["wx"]["bias"].to(x.dtype)
        flat += [p["wx"]["weight"].to(x.dtype).T.contiguous(),
                 p["wh"]["weight"].to(x.dtype).T.contiguous(), b, torch.zeros_like(b)]
    h0 = x.new_zeros((len(layers), B, C))
    y, _, _ = torch.lstm(x, (h0, h0), flat, True, len(layers), 0.0, False, False, True)
    return y + x


# ---------------------------------------------------------------------------
# the SEANet post-filter (encoder -> bottleneck -> decoder)
# ---------------------------------------------------------------------------

class SeanetConfig(NamedTuple):
    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    ratios: Sequence[int] = (8, 5, 4, 2)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    causal: bool = False
    compress: int = 2
    true_skip: bool = True
    lstm: int = 2
    trim_right_ratio: float = 1.0


def seanet_init(gen: torch.Generator, cfg: SeanetConfig, *, dtype=torch.float32,
                device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    nf, mult = cfg.n_filters, 1
    res_k = (cfg.residual_kernel_size, 1)
    p: dict = {"enc_in": conv1d_init(gen, cfg.channels, nf, cfg.kernel_size, **kw),
               "enc_blocks": [], "dec_blocks": []}
    for ratio in reversed(list(cfg.ratios)):
        p["enc_blocks"].append({
            "res": resnet_block_init(gen, mult * nf, res_k, compress=cfg.compress,
                                     true_skip=cfg.true_skip, **kw),
            "down": conv1d_init(gen, mult * nf, mult * nf * 2, ratio * 2, **kw)})
        mult *= 2
    p["enc_lstm"] = lstm_init(gen, mult * nf, cfg.lstm, **kw)
    p["enc_out"] = conv1d_init(gen, mult * nf, cfg.dimension, cfg.last_kernel_size, **kw)
    p["dec_in"] = conv1d_init(gen, cfg.dimension, mult * nf, cfg.kernel_size, **kw)
    p["dec_lstm"] = lstm_init(gen, mult * nf, cfg.lstm, **kw)
    for ratio in cfg.ratios:
        p["dec_blocks"].append({
            "up": conv_transpose1d_init(gen, mult * nf, mult * nf // 2, ratio * 2, **kw),
            "res": resnet_block_init(gen, mult * nf // 2, res_k, compress=cfg.compress,
                                     true_skip=cfg.true_skip, **kw)})
        mult //= 2
    p["dec_out"] = conv1d_init(gen, nf, cfg.channels, cfg.last_kernel_size, **kw)
    return p


def seanet_forward(p: dict, x: torch.Tensor, cfg: SeanetConfig) -> torch.Tensor:
    """(B, T, 1) waveform -> (B, ~T, 1) refined waveform. The first conv's
    input goes through a tanh first (the reference's pre-activation)."""
    h = streamable_conv(p["enc_in"], torch.tanh(x), causal=cfg.causal)
    for blk, ratio in zip(p["enc_blocks"], reversed(list(cfg.ratios))):
        h = resnet_block(blk["res"], h, causal=cfg.causal)
        h = streamable_conv(blk["down"], _elu(h), stride=ratio, causal=cfg.causal)
    h = lstm_forward(p["enc_lstm"], h)
    h = streamable_conv(p["enc_out"], _elu(h), causal=cfg.causal)
    h = streamable_conv(p["dec_in"], h, causal=cfg.causal)
    h = lstm_forward(p["dec_lstm"], h)
    for blk, ratio in zip(p["dec_blocks"], cfg.ratios):
        h = streamable_conv_transpose(blk["up"], _elu(h), stride=ratio, causal=cfg.causal,
                                      trim_right_ratio=cfg.trim_right_ratio)
        h = resnet_block(blk["res"], h, causal=cfg.causal)
    return streamable_conv(p["dec_out"], _elu(h), causal=cfg.causal)
