"""Conformer encoder block (counterpart of
``seamless_communication_tpu/ops/conformer.py``):

    x += 0.5 * ffn1(LN(x))
    x += self_attn(LN(x))        # XL (v1) or Shaw clipped (v2) relative positions
    x += conv_module(LN(x))      # pointwise(2x) + GLU -> depthwise -> norm -> swish -> pointwise
    x += 0.5 * ffn2(LN(x))
    x = LN(x)

The two variants of SeamlessM4T's speech encoder:
    v1: XL attention, SAME-padded depthwise conv, batch norm folded to a
        per-channel affine at load time;
    v2: Shaw attention, causal depthwise conv (left pad k-1), layer norm.
Both store the conv norm as ``{"scale", "bias"}`` under ``norm``. The stack
is a list of per-layer parameter dicts, run in a Python loop. The
SeamlessStreaming encoder's chunked attention is one more additive bias
(``chunk_attention_bias``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seamless_communication_torch.ops import attention as attn_ops
from seamless_communication_torch.ops import remat
from seamless_communication_torch.ops.masks import NEG_INF, apply_padding_mask, padding_bias
from seamless_communication_torch.ops.modules import (
    conv1d, conv1d_init, glu, layer_norm, layer_norm_init, linear, linear_init, swish,
)
from seamless_communication_torch.parallel.pipeline import run_layers


class ConformerConfig(NamedTuple):
    dim: int = 1024
    ffn_inner_dim: int = 4096
    num_heads: int = 16
    depthwise_kernel_size: int = 31
    num_layers: int = 24
    pos_type: str = "shaw"          # "shaw" (v2) | "xl" (v1) | "none"
    causal_depthwise_conv: bool = True   # v2: causal; v1: SAME
    conv_norm: str = "layer_norm"   # v2: layer_norm; v1: batch_norm
    shaw_max_left: int = 64
    shaw_max_right: int = 8


def _ffn_init(gen, dim, inner, kw):
    return {"layer_norm": layer_norm_init(dim, **kw),
            "inner_proj": linear_init(gen, dim, inner, **kw),
            "output_proj": linear_init(gen, inner, dim, **kw)}


def conformer_layer_init(gen: torch.Generator, cfg: ConformerConfig, *,
                         dtype=torch.float32, device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    if cfg.pos_type == "shaw":
        sa = attn_ops.shaw_attention_init(gen, cfg.dim, cfg.num_heads,
                                          max_left=cfg.shaw_max_left,
                                          max_right=cfg.shaw_max_right, **kw)
    elif cfg.pos_type == "xl":
        sa = attn_ops.xl_attention_init(gen, cfg.dim, cfg.num_heads, **kw)
    else:
        sa = attn_ops.mha_init(gen, cfg.dim, cfg.num_heads, **kw)
    conv = {
        "layer_norm": layer_norm_init(cfg.dim, **kw),
        "pointwise_conv1": linear_init(gen, cfg.dim, 2 * cfg.dim, bias=False, **kw),
        "depthwise_conv": conv1d_init(gen, cfg.dim, cfg.dim, cfg.depthwise_kernel_size,
                                      groups=cfg.dim, bias=False, **kw),
        # v1's batch norm is folded to a per-channel affine at load time, so
        # both variants store {scale, bias} here
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
    pad = "CAUSAL" if cfg.causal_depthwise_conv else "SAME"
    h = conv1d(params["depthwise_conv"], h, padding=pad, groups=cfg.dim)
    if cfg.conv_norm == "batch_norm":
        # v1: inference-mode batch norm folded to a per-channel affine
        h = h * params["norm"]["scale"].to(h.dtype) + params["norm"]["bias"].to(h.dtype)
    else:
        h = layer_norm(params["norm"], h)
    return linear(params["pointwise_conv2"], swish(h))


def conformer_layer(params: dict, x: torch.Tensor, cfg: ConformerConfig, *,
                    attn_bias: Optional[torch.Tensor],
                    padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    x = x + 0.5 * _ffn(params["ffn1"], x)
    h = layer_norm(params["self_attn_layer_norm"], x)
    if cfg.pos_type == "shaw":
        h = attn_ops.shaw_self_attention(params["self_attn"], h, cfg.num_heads,
                                         max_left=cfg.shaw_max_left,
                                         max_right=cfg.shaw_max_right, bias=attn_bias)
    elif cfg.pos_type == "xl":
        h = attn_ops.xl_self_attention(params["self_attn"], h, cfg.num_heads,
                                       bias=attn_bias)
    else:
        h = attn_ops.multi_head_attention(params["self_attn"], h, h, cfg.num_heads,
                                          bias=attn_bias)
    x = x + h
    x = x + _conv_module(params["conv"], x, cfg, padding_mask)
    x = x + 0.5 * _ffn(params["ffn2"], x)
    return layer_norm(params["layer_norm"], x)


def conformer_encoder(layers: list, x: torch.Tensor, cfg: ConformerConfig, *,
                      padding_mask: Optional[torch.Tensor] = None,
                      chunk_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the conformer stack (a list of per-layer params) over (B, T, D);
    each layer is a checkpoint region under ``ops/remat.py remat_layers``,
    and the stack a GPipe pipeline under ``parallel/pipeline.py
    pipeline_layers``.

    ``chunk_bias``: an optional additive (T, T) bias, the chunked attention
    of the streaming speech encoder (``chunk_attention_bias``), added to the
    padding bias."""
    bias = padding_bias(padding_mask)
    if chunk_bias is not None:
        cb = chunk_bias[None, None]
        bias = cb if bias is None else bias + cb
    return run_layers(
        lambda h, tens, lp: remat.layer_call(conformer_layer, lp, h, cfg,
                                             attn_bias=tens["bias"],
                                             padding_mask=tens["mask"]),
        layers, x, {"bias": bias, "mask": padding_mask})


def chunk_attention_bias(seq_len: int, chunk_size: int, left_chunk_num: int, *,
                         device=None) -> torch.Tensor:
    """Additive (T, T) fp32 bias restricting each position to its own chunk of
    ``chunk_size`` and ``left_chunk_num`` chunks before it (all of them for
    -1): 0 where allowed, ``NEG_INF`` elsewhere. The SeamlessStreaming speech
    encoder's chunked attention."""
    idx = torch.arange(seq_len, device=device)
    chunk = torch.div(idx, chunk_size, rounding_mode="floor")
    start_chunk = (torch.clamp_min(chunk - left_chunk_num, 0) if left_chunk_num >= 0
                   else torch.zeros_like(chunk))
    start, end = start_chunk * chunk_size, (chunk + 1) * chunk_size
    j = idx[None, :]
    ok = (j >= start[:, None]) & (j < end[:, None])
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)
