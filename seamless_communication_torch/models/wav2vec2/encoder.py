"""W2v-BERT speech encoder and length adaptor (counterpart of
``seamless_communication_tpu/models/wav2vec2/encoder.py``): stride-2 fbank
stacking (80 -> 160 mel), LN + projection, the conformer stack, the
``x + 0.5 * ffn(x)`` intermediate FFN, and the UnitY adaptor (strided GLU
convs on the attention input and the residual, 8x time downsampling). With
``chunk_size`` set (the SeamlessStreaming encoder) the conformer attends
chunk-causally (``ops/conformer.py chunk_attention_bias``);
``conformer_shaw_standalone_forward`` runs the frontend and the conformer
stack alone."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seamless_communication_torch.ops import attention as attn_ops
from seamless_communication_torch.ops.conformer import (
    ConformerConfig, chunk_attention_bias, conformer_encoder, conformer_stack_init,
)
from seamless_communication_torch.ops.masks import (
    apply_padding_mask, lengths_to_padding_mask, padding_bias,
)
from seamless_communication_torch.ops.modules import (
    conv1d, conv1d_init, glu, layer_norm, layer_norm_init, linear, linear_init,
)


class SpeechEncoderConfig(NamedTuple):
    model_dim: int = 1024
    feature_dim: int = 160            # stacked fbank (80 x fbank_stride)
    fbank_stride: int = 2
    conformer: ConformerConfig = ConformerConfig()
    adaptor_layers: int = 1
    adaptor_kernel_size: int = 8
    adaptor_stride: int = 8
    num_adaptor_heads: int = 16
    ffn_inner_dim: int = 4096
    # the streaming encoder's chunked attention (None: full attention)
    chunk_size: Optional[int] = None
    left_chunk_num: int = -1


def stack_fbank_frames(fbank: torch.Tensor, frame_lens: torch.Tensor, stride: int = 2
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, 80) -> (B, T // stride, 80 * stride) frame stacking."""
    B, T, F = fbank.shape
    T2 = T // stride
    return (fbank[:, :T2 * stride].reshape(B, T2, F * stride),
            torch.div(frame_lens, stride, rounding_mode="floor"))


def adaptor_out_length(length: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """floor((len + 2 * (k // 2) - k) / s) + 1"""
    return torch.div(length + 2 * (k // 2) - k, s, rounding_mode="floor") + 1


def _adaptor_layer_init(gen, cfg: SpeechEncoderConfig, kw) -> dict:
    d, k = cfg.model_dim, cfg.adaptor_kernel_size
    return {
        "residual_layer_norm": layer_norm_init(d, **kw),
        "residual_conv": conv1d_init(gen, d, 2 * d, k, **kw),
        "self_attn_layer_norm": layer_norm_init(d, **kw),
        "self_attn_conv": conv1d_init(gen, d, 2 * d, k, **kw),
        "self_attn": attn_ops.mha_init(gen, d, cfg.num_adaptor_heads, **kw),
        "ffn_layer_norm": layer_norm_init(d, **kw),
        "ffn": {"inner_proj": linear_init(gen, d, cfg.ffn_inner_dim, **kw),
                "output_proj": linear_init(gen, cfg.ffn_inner_dim, d, **kw)},
    }


def speech_encoder_init(gen: torch.Generator, cfg: SpeechEncoderConfig, *,
                        dtype=torch.float32, device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "feature_projection": {
            "layer_norm": layer_norm_init(cfg.feature_dim, **kw),
            "projection": linear_init(gen, cfg.feature_dim, cfg.model_dim, **kw),
        },
        "encoder": conformer_stack_init(gen, cfg.conformer, **kw),
        "intermediate_ffn": {
            "inner_proj": linear_init(gen, cfg.model_dim, cfg.ffn_inner_dim, **kw),
            "output_proj": linear_init(gen, cfg.ffn_inner_dim, cfg.model_dim, **kw),
        },
        "inner_layer_norm": layer_norm_init(cfg.model_dim, **kw),
        "adaptor": [_adaptor_layer_init(gen, cfg, kw) for _ in range(cfg.adaptor_layers)],
    }


def _adaptor_layer(p: dict, x: torch.Tensor, lengths: torch.Tensor,
                   cfg: SpeechEncoderConfig) -> tuple[torch.Tensor, torch.Tensor]:
    k, s = cfg.adaptor_kernel_size, cfg.adaptor_stride
    pad = (s // 2, s // 2)
    residual = layer_norm(p["residual_layer_norm"], x)
    residual = glu(conv1d(p["residual_conv"], residual, stride=s, padding=pad))

    h = layer_norm(p["self_attn_layer_norm"], x)
    h = glu(conv1d(p["self_attn_conv"], h, stride=s, padding=pad))

    new_len = adaptor_out_length(lengths, k, s)
    mask = lengths_to_padding_mask(new_len, h.shape[1])
    h = attn_ops.multi_head_attention(p["self_attn"], h, h, cfg.num_adaptor_heads,
                                      bias=padding_bias(mask))
    x = h + residual
    h = layer_norm(p["ffn_layer_norm"], x)
    h = torch.relu(linear(p["ffn"]["inner_proj"], h))
    return x + linear(p["ffn"]["output_proj"], h), new_len


def conformer_shaw_standalone_forward(params: dict, fbank: torch.Tensor,
                                      frame_lens: torch.Tensor,
                                      cfg: Optional[SpeechEncoderConfig] = None
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pretrained conformer-shaw encoder alone: frontend (stack x2 -> LN
    -> projection) and the conformer stack, no intermediate FFN and no
    adaptor -> ((B, T // 2, D) output, (B,) lengths)."""
    cfg = cfg or SpeechEncoderConfig()
    x, lens = stack_fbank_frames(fbank, frame_lens, stride=cfg.fbank_stride)
    x = layer_norm(params["feature_projection"]["layer_norm"], x)
    x = linear(params["feature_projection"]["projection"], x)
    mask = lengths_to_padding_mask(lens, x.shape[1])
    return conformer_encoder(params["encoder"], x, cfg.conformer, padding_mask=mask), lens


def speech_encoder_forward(params: dict, fbank: torch.Tensor, frame_lens: torch.Tensor,
                           cfg: SpeechEncoderConfig
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, 80) fbank + (B,) frame counts -> ((B, T', D) encoder output,
    (B,) output lengths): stack x2 -> LN + proj -> conformer -> +0.5 * ffn ->
    adaptor(s) -> LN."""
    x, lens = stack_fbank_frames(fbank, frame_lens, stride=cfg.fbank_stride)
    x = layer_norm(params["feature_projection"]["layer_norm"], x)
    x = linear(params["feature_projection"]["projection"], x)

    mask = lengths_to_padding_mask(lens, x.shape[1])
    chunk_bias = None
    if cfg.chunk_size is not None:
        chunk_bias = chunk_attention_bias(x.shape[1], cfg.chunk_size, cfg.left_chunk_num,
                                          device=x.device)
    x = conformer_encoder(params["encoder"], x, cfg.conformer, padding_mask=mask,
                          chunk_bias=chunk_bias)

    h = torch.relu(linear(params["intermediate_ffn"]["inner_proj"], x))
    x = x + 0.5 * linear(params["intermediate_ffn"]["output_proj"], h)

    for layer_params in params["adaptor"]:
        x = apply_padding_mask(x, lengths_to_padding_mask(lens, x.shape[1]))
        x, lens = _adaptor_layer(layer_params, x, lens, cfg)

    x = layer_norm(params["inner_layer_norm"], x)
    return apply_padding_mask(x, lengths_to_padding_mask(lens, x.shape[1])), lens
