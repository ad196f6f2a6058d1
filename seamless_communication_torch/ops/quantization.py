"""Weight-only int8 and group-wise int4 quantization (counterpart of
``seamless_communication_tpu/ops/quantization.py``).

  int8:  W (in, out) -> W_i8 int8, scale (out,) = max|W|/127 per column
         y = (x @ W_i8) * scale   (fp32 accumulation)
  int4:  W (in, out) -> W_i4, scale4 (in/g, out) = max|W_group|/7 per
         (group of g input rows, column); y = sum_g (x_g @ W_i4_g) * scale4[g]

``quantize_params`` rewrites selected linear weights in a parameter tree from
{"weight": ...} to {"weight_i8": ..., "scale": ...} (or {"weight_i4": ...,
"scale4": ...}); ``ops.modules.linear`` dispatches on the key. Embeddings
quantize per row (int8) or per (row, group of g columns) (int4); the tied
projection uses the same table transposed. The products here are plain
products on the widened table: they are not kernels of this port.

int4 storage: torch has no int4 type that a product takes, so int4 values
(-7..7) are stored packed two to a byte in an int8 tensor whose last axis is
halved, as the int4 KV cache packs its rows (``ops.attention.pack_int4``):
byte j of a row holds value j in its low nibble and value j + n/2 in its high
nibble. ``weight_i4`` is (in, out/2) and
``embedding_i4`` (vocab, dim/2); the JAX package keeps (in, out) and (vocab,
dim) of ``jnp.int4``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from seamless_communication_torch.ops.attention import pack_int4
from seamless_communication_torch.ops.attention import unpack_int4 as unpack_int4_halves
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


# ---------------------------------------------------------------------------
# int4 (group-wise)
# ---------------------------------------------------------------------------

INT4_GROUP = 128


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., n/2) split-half packed bytes (``pack_int4``) -> (..., n) int8
    values."""
    return torch.cat(unpack_int4_halves(packed), dim=-1)


def _int4_group(dim: int, group: int) -> int:
    """``group`` when it divides ``dim``, else the whole axis (one group)."""
    return group if dim % group == 0 else dim


def quantize_weight_int4(w: torch.Tensor, *, group: int = INT4_GROUP
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(in, out) -> packed int4 weights (in, out/2) + (in/g, out) fp32 group
    scales, symmetric absmax per (group, column), -8 unused."""
    w32 = w.float()
    in_dim, out_dim = w32.shape
    g = _int4_group(in_dim, group)
    wg = w32.reshape(in_dim // g, g, out_dim)
    scale = torch.clamp_min(true_div(wg.abs().amax(dim=1), 7.0), 1e-8)
    q = torch.round(wg / scale[:, None, :]).clamp(-7, 7)
    return pack_int4(q.reshape(in_dim, out_dim).to(torch.int8)), scale


def linear_quantized_int4(params: dict, x: torch.Tensor) -> torch.Tensor:
    """y = sum_g (x_g @ W4_g) * scale4[g] (+ b): one product a group, then
    the scaled fp32 sum over the groups, as the JAX package orders it.
    Returns x.dtype."""
    q = unpack_int4(params["weight_i4"])
    s = params["scale4"].float()                       # (G, out)
    in_dim, out_dim = q.shape
    G = s.shape[0]
    g = in_dim // G
    xg = x.float().reshape(*x.shape[:-1], G, 1, g)
    y = torch.matmul(xg, q.to(x.dtype).float().reshape(G, g, out_dim)).squeeze(-2)
    y = (y * s).sum(dim=-2)
    b = params.get("bias")
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def quantize_embedding_int4(w: torch.Tensor, *, group: int = INT4_GROUP
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(vocab, dim) -> packed int4 rows (vocab, dim/2) + (vocab, dim/g) fp32
    scales (groups along the embedding axis; the tied projection reuses them
    per logit)."""
    w32 = w.float()
    V, D = w32.shape
    g = _int4_group(D, group)
    wg = w32.reshape(V, D // g, g)
    scale = torch.clamp_min(true_div(wg.abs().amax(dim=2), 7.0), 1e-8)
    q = torch.round(wg / scale[..., None]).clamp(-7, 7)
    return pack_int4(q.reshape(V, D).to(torch.int8)), scale


def embedding_lookup_quantized_int4(params: dict, ids: torch.Tensor, *,
                                    scale_mult=None) -> torch.Tensor:
    """Lookup in the packed int4 table; returns fp32."""
    s = params["row_scale4"]                           # (V, G)
    e = unpack_int4(params["embedding_i4"][ids]).float()
    D, G = e.shape[-1], s.shape[1]
    e = (e.reshape(*ids.shape, G, D // G) * s[ids][..., None]).reshape(*ids.shape, D)
    if scale_mult is not None:
        e = e * scale_mult
    return e


def tied_projection_quantized_int4(params: dict, x: torch.Tensor) -> torch.Tensor:
    """logits[..., v] = sum_g (x_g . Q4[v, g]) * row_scale4[v, g], fp32,
    summed group by group as the JAX package sums them."""
    q = unpack_int4(params["embedding_i4"])            # (V, D)
    s = params["row_scale4"]                           # (V, G)
    G = s.shape[1]
    g = q.shape[1] // G
    out = None
    for i in range(G):
        qi = q[:, i * g:(i + 1) * g].to(x.dtype).float()
        yi = torch.matmul(x[..., i * g:(i + 1) * g].float(), qi.T) * s[:, i]
        out = yi if out is None else out + yi
    return out


# matmul linears only: conv weights go through conv1d, which reads fp weights;
# not r_proj, whose raw weight the XL relative bias reads
DEFAULT_QUANT_SUFFIXES = ("q_proj", "k_proj", "v_proj", "output_proj",
                          "inner_proj")

# keys whose lists hold the layers of one stack (scan-stacked in the JAX tree):
# transformer stacks, the conformer stack of the speech encoder, the FFT
# layers of the NAR T2U
STACK_KEYS = ("layers", "encoder", "decoder_layers")


def quantize_params(params, *, include: Sequence[str] = DEFAULT_QUANT_SUFFIXES,
                    min_size: int = 1 << 16, predicate: Optional[Callable] = None,
                    bits: int = 8, int4_group: int = INT4_GROUP):
    """Rewrite large linear weights to int8 (default) or group-int4, and
    large embeddings to int8 rows or int4 row groups.

    A weight quantizes when its parent key is in ``include`` and it holds at
    least ``min_size`` elements, or where ``predicate(path, leaf)`` says so
    (it replaces that rule). The layers of a stack (a list under one of
    ``STACK_KEYS``) are one scan-stacked leaf in the JAX tree, so ``min_size``
    counts the whole stack there as it does in the JAX package, and the
    ``path`` a predicate gets is the JAX tree's: the keys from the root, a
    stack's layer index left out (the leaf is the layer's own tensor). Each
    layer gets its own scales, as the JAX package's per-layer scales. An
    embedding table quantizes where it is not in a stack (the JAX package
    quantizes 2-d tables only).
    ``int4_group``: input rows (embedding columns) a 4-bit scale covers; 0
    for one group over the whole axis. Subtrees shared by two keys (a tied
    embedding) stay shared.
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    int4_group = int4_group or (1 << 30)

    def default_pred(path, leaf, stack_len):
        return (len(path) >= 2 and path[-2] in include and leaf.ndim >= 2
                and leaf.numel() * stack_len >= min_size)

    def quantize(v: torch.Tensor, embedding: bool):
        if bits == 8:
            return quantize_embedding(v) if embedding else quantize_weight(v)
        fn = quantize_embedding_int4 if embedding else quantize_weight_int4
        return fn(v, group=int4_group)

    q_key, s_key = ("weight_i8", "scale") if bits == 8 else ("weight_i4", "scale4")
    e_key, r_key = (("embedding_i8", "row_scale") if bits == 8
                    else ("embedding_i4", "row_scale4"))
    seen: dict = {}

    def walk(node, path, stack_len):
        if isinstance(node, dict):
            if id(node) in seen:
                return seen[id(node)]
            out = {}
            seen[id(node)] = out
            for k, v in node.items():
                leaf = isinstance(v, torch.Tensor)
                # a table inside a stack (a conformer layer's rel_k_embed) is
                # a 3-d stacked leaf in the JAX tree, which it never quantizes
                if (k == "embedding" and leaf and v.numel() >= min_size
                        and v.ndim == 2 and stack_len == 1):
                    out[e_key], out[r_key] = quantize(v, True)
                elif k == "weight" and leaf and (
                        predicate(path + [k], v) if predicate is not None
                        else default_pred(path + [k], v, stack_len)):
                    out[q_key], out[s_key] = quantize(v, False)
                else:
                    out[k] = walk(v, path + [k], stack_len)
            return out
        if isinstance(node, list):
            if path and path[-1] in STACK_KEYS:
                return [walk(v, path, stack_len * len(node)) for v in node]
            return [walk(v, path + [str(i)], stack_len) for i, v in enumerate(node)]
        return node

    return walk(params, [], 1)
