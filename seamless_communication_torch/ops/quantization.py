"""Weight-only int8 quantization (counterpart of the int8 path of
``seamless_communication_tpu/ops/quantization.py``).

  quantize:   W (in, out)  ->  W_i8 int8, scale (out,) = max|W|/127 per column
  matmul:     y = (x @ W_i8) * scale   (fp32 accumulation)

``quantize_params`` rewrites selected linear weights in a parameter tree from
{"weight": ...} to {"weight_i8": ..., "scale": ...}; ``ops.modules.linear``
dispatches on the key. Embeddings quantize per row; the tied projection uses
the same table transposed. The int8 products here are plain products on the
widened table: they are not kernels of this port.
"""

from __future__ import annotations

import torch

from seamless_communication_torch.ops.modules import true_div


def _quantize(w32: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(true_div(w32.abs().amax(dim=dim), 127.0), 1e-8)
    q = torch.round(w32 / scale.unsqueeze(dim)).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(in, out) -> int8 weights + per-output-column fp32 scales."""
    return _quantize(w.float(), 0)


def quantize_embedding(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(vocab, dim) -> int8 rows + per-row fp32 scales (the tied projection
    reuses them as per-logit output scales)."""
    return _quantize(w.float(), 1)


def embedding_lookup_quantized(params: dict, ids: torch.Tensor, *,
                               scale_mult=None) -> torch.Tensor:
    """Lookup in the int8 table; returns fp32 whatever the model dtype."""
    e = params["embedding_i8"][ids].float() * params["row_scale"][ids][..., None]
    if scale_mult is not None:
        e = e * scale_mult
    return e


def tied_projection_quantized(params: dict, x: torch.Tensor) -> torch.Tensor:
    """logits = (x @ Q^T) * row_scale, fp32."""
    q = params["embedding_i8"]
    y = torch.matmul(x.float(), q.to(x.dtype).float().T)
    return y * params["row_scale"][None, None, :]


def linear_quantized(params: dict, x: torch.Tensor) -> torch.Tensor:
    """y = (x @ W_i8) * scale (+ b), returns x.dtype."""
    q = params["weight_i8"]
    y = torch.matmul(x.float(), q.to(x.dtype).float())
    y = y * params["scale"].float()
    b = params.get("bias")
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


# matmul linears only: conv weights go through conv1d, which reads fp weights
DEFAULT_QUANT_SUFFIXES = ("q_proj", "k_proj", "v_proj", "output_proj",
                          "inner_proj")

# keys whose lists hold the layers of one stack (scan-stacked in the JAX tree):
# transformer stacks, the conformer stack of the speech encoder, the FFT
# layers of the NAR T2U
STACK_KEYS = ("layers", "encoder", "decoder_layers")


def quantize_params(params, *, min_size: int = 1 << 16):
    """Rewrite large linear weights to int8 and large embeddings to int8 rows.

    A weight quantizes when its parent key is in ``DEFAULT_QUANT_SUFFIXES`` and it holds at
    least ``min_size`` elements. The layers of a stack (a list under one of
    ``STACK_KEYS``) are one scan-stacked leaf in the JAX tree, so ``min_size``
    counts the whole stack there as it does in the JAX package. Each layer
    gets its own per-column scales, as the JAX package's per-(layer, column)
    scales. Subtrees shared by two keys (a tied embedding) stay shared.
    """
    seen: dict = {}

    def walk(node, path, stack_len):
        if isinstance(node, dict):
            if id(node) in seen:
                return seen[id(node)]
            out = {}
            seen[id(node)] = out
            for k, v in node.items():
                if (k == "embedding" and isinstance(v, torch.Tensor)
                        and v.numel() >= min_size and v.ndim == 2):
                    out["embedding_i8"], out["row_scale"] = quantize_embedding(v)
                elif (k == "weight" and isinstance(v, torch.Tensor)
                      and path and path[-1] in DEFAULT_QUANT_SUFFIXES and v.ndim >= 2
                      and v.numel() * stack_len >= min_size):
                    out["weight_i8"], out["scale"] = quantize_weight(v)
                else:
                    out[k] = walk(v, path + [k], stack_len)
            return out
        if isinstance(node, list):
            n = len(node) if path and path[-1] in STACK_KEYS else 1
            return [walk(v, path + [str(i)], stack_len * n)
                    for i, v in enumerate(node)]
        return node

    return walk(params, [], 1)
