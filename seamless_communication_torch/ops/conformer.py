"""Conformer encoder block (counterpart of
``seamless_communication_tpu/ops/conformer.py``):

    x += 0.5 * ffn1(LN(x))
    x += self_attn(LN(x))        # Shaw clipped relative positions (v2)
    x += conv_module(LN(x))      # pointwise(2x) + GLU -> depthwise -> norm -> swish -> pointwise
    x += 0.5 * ffn2(LN(x))
    x = LN(x)

The stack is a list of per-layer parameter dicts, run in a Python loop. The
v2 variant (Shaw attention, causal depthwise conv, layer-norm conv norm) is
the one ``base_v2`` uses; the v1 Transformer-XL attention is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seamless_communication_torch.ops import attention as attn_ops
from seamless_communication_torch.ops.masks import apply_padding_mask, padding_bias
from seamless_communication_torch.ops.modules import (
    conv1d, conv1d_init, glu, layer_norm, layer_norm_init, linear, linear_init, swish,
)


class ConformerConfig(NamedTuple):
    dim: int = 1024
    ffn_inner_dim: int = 4096
    num_heads: int = 16
    depthwise_kernel_size: int = 31
    num_layers: int = 24
    pos_type: str = "shaw"          # v1's "xl" is not ported yet
    causal_depthwise_conv: bool = True
    conv_norm: str = "layer_norm"   # v1's "batch_norm" is not ported yet
    shaw_max_left: int = 64
    shaw_max_right: int = 8


def _ffn_init(gen, dim, inner, kw):
    return {"layer_norm": layer_norm_init(dim, **kw),
            "inner_proj": linear_init(gen, dim, inner, **kw),
            "output_proj": linear_init(gen, inner, dim, **kw)}


def _check_v2(cfg: ConformerConfig) -> None:
    if (cfg.pos_type, cfg.causal_depthwise_conv, cfg.conv_norm) != (
            "shaw", True, "layer_norm"):
        raise NotImplementedError(f"conformer variant {cfg} is not ported yet: only "
                                  "Shaw attention, causal conv and layer-norm")


def conformer_layer_init(gen: torch.Generator, cfg: ConformerConfig, *,
                         dtype=torch.float32, device=None) -> dict:
    _check_v2(cfg)
    kw = dict(dtype=dtype, device=device)
    sa = attn_ops.shaw_attention_init(gen, cfg.dim, cfg.num_heads,
                                      max_left=cfg.shaw_max_left,
                                      max_right=cfg.shaw_max_right, **kw)
    conv = {
        "layer_norm": layer_norm_init(cfg.dim, **kw),
        "pointwise_conv1": linear_init(gen, cfg.dim, 2 * cfg.dim, bias=False, **kw),
        "depthwise_conv": conv1d_init(gen, cfg.dim, cfg.dim, cfg.depthwise_kernel_size,
                                      groups=cfg.dim, bias=False, **kw),
        "norm": layer_norm_init(cfg.dim, **kw),
        "pointwise_conv2": linear_init(gen, cfg.dim, cfg.dim, bias=False, **kw),
    }
    return {
        "ffn1": _ffn_init(gen, cfg.dim, cfg.ffn_inner_dim, kw),
        "self_attn_layer_norm": layer_norm_init(cfg.dim, **kw),
        "self_attn": sa,
        "conv": conv,
        "ffn2": _ffn_init(gen, cfg.dim, cfg.ffn_inner_dim, kw),
        "layer_norm": layer_norm_init(cfg.dim, **kw),
    }


def conformer_stack_init(gen: torch.Generator, cfg: ConformerConfig, *,
                         dtype=torch.float32, device=None) -> list:
    return [conformer_layer_init(gen, cfg, dtype=dtype, device=device)
            for _ in range(cfg.num_layers)]


def _ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = layer_norm(params["layer_norm"], x)
    h = swish(linear(params["inner_proj"], h))
    return linear(params["output_proj"], h)


def _conv_module(params: dict, x: torch.Tensor, cfg: ConformerConfig,
                 padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    h = layer_norm(params["layer_norm"], x)
    # zero padded steps so the depthwise conv cannot leak padding
    h = apply_padding_mask(h, padding_mask)
    h = glu(linear(params["pointwise_conv1"], h), dim=-1)
    h = conv1d(params["depthwise_conv"], h, padding="CAUSAL", groups=cfg.dim)
    h = layer_norm(params["norm"], h)
    return linear(params["pointwise_conv2"], swish(h))


def conformer_layer(params: dict, x: torch.Tensor, cfg: ConformerConfig, *,
                    attn_bias: Optional[torch.Tensor],
                    padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    x = x + 0.5 * _ffn(params["ffn1"], x)
    h = layer_norm(params["self_attn_layer_norm"], x)
    x = x + attn_ops.shaw_self_attention(params["self_attn"], h, cfg.num_heads,
                                         max_left=cfg.shaw_max_left,
                                         max_right=cfg.shaw_max_right, bias=attn_bias)
    x = x + _conv_module(params["conv"], x, cfg, padding_mask)
    x = x + 0.5 * _ffn(params["ffn2"], x)
    return layer_norm(params["layer_norm"], x)


def conformer_encoder(layers: list, x: torch.Tensor, cfg: ConformerConfig, *,
                      padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the conformer stack (a list of per-layer params) over (B, T, D)."""
    _check_v2(cfg)
    bias = padding_bias(padding_mask)
    for layer_params in layers:
        x = conformer_layer(layer_params, x, cfg, attn_bias=bias,
                            padding_mask=padding_mask)
    return x
