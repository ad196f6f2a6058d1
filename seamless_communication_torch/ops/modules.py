"""Primitive layers as plain functions over parameter dicts of tensors
(counterpart of ``seamless_communication_tpu/ops/modules.py``).

Conventions kept from the JAX package, so the two compare like with like:
- activations are ``(batch, time, dim)``;
- linear weights are ``(in_dim, out_dim)``;
- conv1d is NWC with ``(kernel, in_ch // groups, out_ch)`` ("WIO") weights,
  conv_transpose1d with ``(kernel, in_ch, out_ch)``;
- products accumulate in fp32 and return the activation dtype. Where the JAX
  code asks for an fp32 result from bf16 operands, the port widens the
  operands to fp32 first: a bf16 x bf16 product is exact in fp32, so the
  result is the same as a bf16 product with fp32 output.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from seamless_communication_torch.parallel.collectives import (
    copy_to, model_shard, reduce_from, split_to,
)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division in x's dtype. PyTorch turns a division
    by a host scalar into a multiplication by its reciprocal on CUDA, which
    can differ in the last bit; a divisor on x's device is divided exactly,
    as jnp and the CUDA kernels divide. (``torch.full`` fills on the device;
    ``torch.tensor`` would copy from the host.)"""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _uniform(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return (u * (2 * scale) - scale).to(dtype)


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, in_dim: int, out_dim: int, *, bias: bool = True,
                dtype=torch.float32, device=None) -> dict:
    """Kaiming-uniform init matching torch ``nn.Linear`` defaults."""
    scale = 1.0 / math.sqrt(in_dim)
    params = {"weight": _uniform(gen, (in_dim, out_dim), scale, dtype, device)}
    if bias:
        params["bias"] = _uniform(gen, (out_dim,), scale, dtype, device)
    return params


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+ b), fp32 accumulation, returns x.dtype. Dispatches to the
    int8 or int4 weight-only path for params rewritten by ``quantize_params``."""
    if "weight_i8" in params:
        from seamless_communication_torch.ops.quantization import linear_quantized
        return linear_quantized(params, x)
    if "weight_i4" in params:
        from seamless_communication_torch.ops.quantization import linear_quantized_int4
        return linear_quantized_int4(params, x)
    shard = model_shard(params["weight"])
    if shard is not None:
        return _linear_shard(params, x, shard)
    w = params["weight"].to(x.dtype)
    y = torch.matmul(x.float(), w.float())
    b = params.get("bias")
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _linear_shard(params: dict, x: torch.Tensor, shard) -> torch.Tensor:
    """``linear`` of a weight split over "model" (``parallel/sharding.py``):
    by columns (dim 1), the replicated input behind ``copy_to`` and this
    rank's output columns with its part of the bias; by rows (dim 0), this
    rank's input columns (split from a whole input), its partial product
    summed over the axis in fp32, then the bias."""
    w = params["weight"].to(x.dtype)
    b = params.get("bias")
    if shard.dim == 1:
        y = torch.matmul(copy_to(x, shard.axis).float(), w.float())
        if b is not None:
            y = y + b.float()
        return y.to(x.dtype)
    if x.shape[-1] != w.shape[0]:
        x = split_to(x, shard.axis, -1)
    y = reduce_from(torch.matmul(x.float(), w.float()), shard.axis)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def layer_norm_init(dim: int, *, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layer_norm(params: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if params:
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab_size: int, dim: int, *,
                   dtype=torch.float32, device=None) -> dict:
    emb = torch.randn((vocab_size, dim), generator=gen, dtype=torch.float32,
                      device=device) * (dim ** -0.5)
    return {"embedding": emb.to(dtype)}


def embedding(params: dict, ids: torch.Tensor, *, scale: Optional[float] = None
              ) -> torch.Tensor:
    """Token-id lookup times an optional ``scale`` (sqrt(dim) in transformer
    frontends). Dispatches to the int8 or int4 quantized table when present."""
    if "embedding_i8" in params:
        from seamless_communication_torch.ops.quantization import (
            embedding_lookup_quantized,
        )
        return embedding_lookup_quantized(params, ids, scale_mult=scale)
    if "embedding_i4" in params:
        from seamless_communication_torch.ops.quantization import (
            embedding_lookup_quantized_int4,
        )
        return embedding_lookup_quantized_int4(params, ids, scale_mult=scale)
    table = params["embedding"]
    shard = model_shard(table)
    if shard is not None:
        # a vocabulary split over "model": this rank's rows, the other ids
        # zero, summed over the axis (one nonzero term: exact)
        n = table.shape[0]
        local = ids - shard.axis.rank * n
        mine = (local >= 0) & (local < n)
        e = table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
        e = reduce_from(e, shard.axis)
    else:
        e = table[ids]
    if scale is not None:
        e = e * torch.full((), scale, dtype=e.dtype, device=e.device)
    return e


# ---------------------------------------------------------------------------
# Conv1d (NWC layout, WIO weights)
# ---------------------------------------------------------------------------

def conv1d_init(gen: torch.Generator, in_ch: int, out_ch: int, kernel_size: int, *,
                groups: int = 1, bias: bool = True, dtype=torch.float32,
                device=None) -> dict:
    scale = 1.0 / math.sqrt((in_ch // groups) * kernel_size)
    params = {"weight": _uniform(gen, (kernel_size, in_ch // groups, out_ch), scale,
                                 dtype, device)}
    if bias:
        params["bias"] = _uniform(gen, (out_ch,), scale, dtype, device)
    return params


def _conv_padding(padding, width: int, k: int, stride: int, dilation: int
                  ) -> tuple[int, int]:
    if padding == "CAUSAL":
        return (k - 1) * dilation, 0
    if padding == "VALID":
        return 0, 0
    if padding == "SAME":     # XLA's rule: output ceil(width / stride)
        out = -(-width // stride)
        total = max((out - 1) * stride + (k - 1) * dilation + 1 - width, 0)
        return total // 2, total - total // 2
    lo, hi = padding
    return lo, hi


def conv1d(params: dict, x: torch.Tensor, *, stride: int = 1, padding="SAME",
           groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """1-D convolution on (batch, time, channels). ``padding`` is "SAME",
    "VALID", "CAUSAL" or an explicit (lo, hi) pair."""
    w = params["weight"].to(x.dtype)
    k = w.shape[0]
    # a weight split over "model": by output channels (dim 2), the input
    # behind copy_to; by input channels (dim 1), this rank's channels in and
    # the partial outputs summed over the axis before the bias
    shard = model_shard(params["weight"])
    if shard is not None and shard.dim == 2:
        x = copy_to(x, shard.axis)
    elif shard is not None and x.shape[-1] != w.shape[1] * groups:
        x = split_to(x, shard.axis, -1)
    lo, hi = _conv_padding(padding, x.shape[1], k, stride, dilation)
    xc = F.pad(x.transpose(1, 2), (lo, hi))                  # (B, C, W)
    y = F.conv1d(xc, w.permute(2, 1, 0), stride=stride, dilation=dilation,
                 groups=groups).transpose(1, 2)
    if shard is not None and shard.dim == 1:
        y = reduce_from(y.float(), shard.axis)
    b = params.get("bias")
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype)


def conv_transpose1d_init(gen: torch.Generator, in_ch: int, out_ch: int,
                          kernel_size: int, *, bias: bool = True, dtype=torch.float32,
                          device=None) -> dict:
    scale = 1.0 / math.sqrt(in_ch * kernel_size)
    params = {"weight": _uniform(gen, (kernel_size, in_ch, out_ch), scale, dtype,
                                 device)}
    if bias:
        params["bias"] = _uniform(gen, (out_ch,), scale, dtype, device)
    return params


def conv_transpose1d(params: dict, x: torch.Tensor, *, stride: int,
                     padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """Transposed 1-D convolution on (batch, time, channels) with ``(kernel,
    in_ch, out_ch)`` weights, as torch ``ConvTranspose1d(stride, padding,
    output_padding)``: out_len = (in_len - 1) * stride - 2 * padding + kernel
    + output_padding, the output padding on the right edge."""
    w = params["weight"].to(x.dtype)
    y = F.conv_transpose1d(x.transpose(1, 2), w.permute(1, 2, 0), stride=stride,
                           padding=padding, output_padding=output_padding
                           ).transpose(1, 2)
    b = params.get("bias")
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / gating
# ---------------------------------------------------------------------------

def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Gated linear unit: split in half along ``dim``; a * sigmoid(b)."""
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
