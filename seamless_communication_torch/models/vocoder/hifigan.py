"""HiFi-GAN generator (counterpart of
``seamless_communication_tpu/models/vocoder/hifigan.py``).

conv_pre(k7) -> N x [leaky_relu -> transposed-conv upsample -> mean of
resblocks (k in {3,7,11}, dilations (1,3,5))] -> leaky_relu -> conv_post(k7)
-> tanh. Activations (B, T, C), conv weights WIO. The convolutions are
library calls (``F.conv1d`` / ``F.conv_transpose1d``): the JAX package leaves
them to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from seamless_communication_torch.ops.modules import (
    conv1d, conv1d_init, conv_transpose1d, conv_transpose1d_init,
)


class HifiGanConfig(NamedTuple):
    model_in_dim: int = 1792          # unit 1280 + lang 256 + spkr 256
    upsample_initial_channel: int = 512
    upsample_rates: Sequence[int] = (5, 4, 4, 2, 2)      # 320x total
    upsample_kernel_sizes: Sequence[int] = (11, 8, 8, 4, 4)
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3
    leaky_relu_slope: float = 0.1
    # PRETSSEL variant: upsampler padding (k-u)//2 + u%2 with output_padding
    # u%2, and conv_post's output returned without the tanh
    add_ups_out_pad: bool = False
    final_tanh: bool = True

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


def _resblock_init(gen, channels, kernel, dilations, **kw):
    return {"convs1": [conv1d_init(gen, channels, channels, kernel, **kw)
                       for _ in dilations],
            "convs2": [conv1d_init(gen, channels, channels, kernel, **kw)
                       for _ in dilations]}


def hifigan_init(gen: torch.Generator, cfg: HifiGanConfig, *, dtype=torch.float32,
                 device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    params = {"conv_pre": conv1d_init(gen, cfg.model_in_dim,
                                      cfg.upsample_initial_channel, 7, **kw),
              "upsampler": [], "resblocks": []}
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        in_ch = cfg.upsample_initial_channel // (2 ** i)
        out_ch = cfg.upsample_initial_channel // (2 ** (i + 1))
        params["upsampler"].append(conv_transpose1d_init(gen, in_ch, out_ch, k, **kw))
        for kernel, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            params["resblocks"].append(_resblock_init(gen, out_ch, kernel, dils, **kw))
    last_ch = cfg.upsample_initial_channel // (2 ** len(cfg.upsample_rates))
    params["conv_post"] = conv1d_init(gen, last_ch, 1, 7, **kw)
    return params


def _resblock(p: dict, x: torch.Tensor, dilations: Sequence[int],
              slope: float) -> torch.Tensor:
    for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
        h = conv1d(c1, F.leaky_relu(x, slope), padding="SAME", dilation=d)
        h = conv1d(c2, F.leaky_relu(h, slope), padding="SAME")
        x = x + h
    return x


def hifigan_forward(params: dict, x: torch.Tensor, cfg: HifiGanConfig) -> torch.Tensor:
    """(B, T, model_in_dim) -> (B, T * total_upsample) waveform."""
    h = conv1d(params["conv_pre"], x, padding="SAME")
    nk = len(cfg.resblock_kernel_sizes)
    for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        h = F.leaky_relu(h, cfg.leaky_relu_slope)
        out_pad = rate % 2 if cfg.add_ups_out_pad else 0
        h = conv_transpose1d(params["upsampler"][i], h, stride=rate,
                             padding=(k - rate) // 2 + out_pad, output_padding=out_pad)
        acc = None
        for j in range(nk):
            r = _resblock(params["resblocks"][i * nk + j], h,
                          cfg.resblock_dilation_sizes[j], cfg.leaky_relu_slope)
            acc = r if acc is None else acc + r
        h = acc / nk
    h = F.leaky_relu(h, 0.01)   # torch's default slope for the final activation
    h = conv1d(params["conv_post"], h, padding="SAME")
    if cfg.final_tanh:
        h = torch.tanh(h)
    return h[..., 0]
