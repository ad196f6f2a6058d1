"""Raw-waveform wav2vec2 encoder, the XLSR2-1B model of unit extraction
(counterpart of ``seamless_communication_tpu/models/unit_extractor/
wav2vec2_raw.py``; reference models/unit_extractor/wav2vec2_layer_output.py):

conv feature extractor [(512, k10, s5)] + 4 x (512, k3, s2) + 2 x (512, k2,
s2), each conv with a bias, a LayerNorm and a GELU -> post-extract LN and a
projection to 1280 -> conv positional encoder (k = 128 in 16 groups, GELU)
-> LN -> 48 pre-LN transformer layers (dim 1280, ffn 5120, 16 heads: head
dim 80), whose output at ``out_layer_idx`` (layer 35 of the reference's
numbering, index 34) is the feature that the k-means quantizes.

Copied from the JAX package on purpose: every GELU is ``jax.nn.gelu``'s
default, the tanh approximation (fairseq2's is erf). The padded steps are
masked in the attention only, by a (B, 1, 1, T) key-padding bias, which the
fused-attention option turns into key segment ids of K6.

A deliberate difference: the JAX package scans all ``num_layers`` layers
(a scan's length is static) and freezes the stream after
``out_layer_idx``; the port stops after layer ``out_layer_idx``, which gives
the same output. So an extraction runs ``out_layer_idx + 1`` layers (35 at
the default), each one attention.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from seamless_communication_torch.ops.masks import lengths_to_padding_mask, padding_bias
from seamless_communication_torch.ops.modules import (
    conv1d, conv1d_init, layer_norm, layer_norm_init, linear, linear_init,
)
from seamless_communication_torch.ops.transformer import (
    TransformerConfig, _layer_forward, transformer_layer_init,
)


class Wav2Vec2RawConfig(NamedTuple):
    model_dim: int = 1280
    feature_dim: int = 512
    conv_layers: Sequence[tuple] = ((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    num_layers: int = 48
    num_heads: int = 16
    ffn_inner_dim: int = 5120

    def layer_cfg(self) -> TransformerConfig:
        return TransformerConfig(self.model_dim, self.num_layers, self.num_heads,
                                 self.ffn_inner_dim, "gelu", 1, 0, 4096, False)

    def downsample_factor(self) -> int:
        f = 1
        for _, _, s in self.conv_layers:
            f *= s
        return f


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def wav2vec2_raw_init(gen: torch.Generator, cfg: Wav2Vec2RawConfig, *,
                      dtype=torch.float32, device=None) -> dict:
    """Random parameters drawn from ``gen`` (on ``gen``'s device; pass a CUDA
    generator and ``device="cuda"`` to draw a full-width tree on the card).
    The layers are a list of per-layer dicts."""
    kw = dict(dtype=dtype, device=device)
    convs = []
    in_ch = 1
    for out_ch, k, _ in cfg.conv_layers:
        convs.append({"conv": conv1d_init(gen, in_ch, out_ch, k, bias=True, **kw),
                      "norm": layer_norm_init(out_ch, **kw)})
        in_ch = out_ch
    layers = [transformer_layer_init(gen, cfg.layer_cfg(), **kw)
              for _ in range(cfg.num_layers)]
    return {
        "feature_extractor": convs,
        "post_extract_norm": layer_norm_init(cfg.feature_dim, **kw),
        "post_extract_proj": linear_init(gen, cfg.feature_dim, cfg.model_dim, **kw),
        "pos_conv": conv1d_init(gen, cfg.model_dim, cfg.model_dim, cfg.pos_conv_kernel,
                                groups=cfg.pos_conv_groups, **kw),
        "encoder_norm": layer_norm_init(cfg.model_dim, **kw),
        "layers": layers,
    }


def _output_lengths(lengths: torch.Tensor, cfg: Wav2Vec2RawConfig) -> torch.Tensor:
    """Valid frames of each waveform: ``(len - k) // s + 1`` through the conv
    stack."""
    for _, k, s in cfg.conv_layers:
        lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
    return lengths


def _feature_extract(params: list, wav: torch.Tensor, cfg: Wav2Vec2RawConfig
                    ) -> torch.Tensor:
    """(B, T_samples) -> (B, T_frames, feature_dim): each conv (VALID, its
    stride), LayerNorm, GELU."""
    x = wav[..., None]
    for p, (_, _, s) in zip(params, cfg.conv_layers):
        x = _gelu(layer_norm(p["norm"], conv1d(p["conv"], x, stride=s, padding="VALID")))
    return x


def wav2vec2_layer_output(params: dict, wav: torch.Tensor, lengths: torch.Tensor,
                          cfg: Wav2Vec2RawConfig, *, out_layer_idx: int = 34
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T_samples) normalized waveform and its (B,) valid sample counts ->
    (the features of encoder layer ``out_layer_idx`` (0-based), (B, T,
    model_dim); the valid frames (B,)). Runs the layers up to
    ``out_layer_idx`` and no further (all of them where it is past the
    last, none where it is negative, as the JAX package's frozen scan)."""
    feats = _feature_extract(params["feature_extractor"], wav, cfg)
    feats = layer_norm(params["post_extract_norm"], feats)
    x = linear(params["post_extract_proj"], feats)
    T = x.shape[1]
    out_lens = _output_lengths(lengths, cfg)
    bias = padding_bias(lengths_to_padding_mask(out_lens, T))

    # conv positional embedding; an even kernel gives one step more than T,
    # the trailing one trimmed (the w2v2 convention)
    k = cfg.pos_conv_kernel
    pos = conv1d(params["pos_conv"], x, padding=(k // 2, k // 2),
                 groups=cfg.pos_conv_groups)
    x = layer_norm(params["encoder_norm"], x + _gelu(pos[:, :T]))

    lcfg = cfg.layer_cfg()
    for layer in params["layers"][:max(out_layer_idx + 1, 0)]:
        x = _layer_forward(layer, x, lcfg, self_bias=bias, enc_out=None, cross_bias=None)
    return x, out_lens
