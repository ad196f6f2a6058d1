"""Pre-LN transformer decoder stack with a KV-cached single-step forward
(counterpart of ``seamless_communication_tpu/ops/transformer.py``):

    x += self_attn(LN(x))
    x += cross_attn(LN(x), enc)
    x += ffn(LN(x))
    final stack LayerNorm.

A stack is ``{"layers": [per-layer params], "layer_norm": ...}``. The
full-sequence forward (encoder; decoder re-decode) and the KV-cached single
step are both here. The decode caches are per layer: lists of (B, H, T, Dh)
tensors ((B, H, T, Dh/2) packed bytes for int4).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from seamless_communication_torch.ops import attention as attn_ops
from seamless_communication_torch.ops import remat
from seamless_communication_torch.ops.attention import Int8KVCache, KVCache
from seamless_communication_torch.ops.kernels.decode_attention import (
    fused_decode_self_attention_int4, fused_decode_self_attention_int8, gather_rows,
    indexed_decode_self_attention_int8,
)
from seamless_communication_torch.ops.masks import (
    causal_mask, combine_masks, padding_bias,
)
from seamless_communication_torch.ops.modules import (
    embedding, layer_norm, layer_norm_init, linear, linear_init,
)
from seamless_communication_torch.ops.positional import apply_sinusoidal_pos
from seamless_communication_torch.parallel.collectives import copy_to, model_shard
from seamless_communication_torch.parallel.pipeline import run_layers


class TransformerConfig(NamedTuple):
    dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_inner_dim: int = 8192
    activation: str = "relu"
    vocab_size: int = 256102
    pad_idx: int = 0
    max_seq_len: int = 4096
    has_cross_attention: bool = False


# NLLB's activations. The expressive NLLB's "gelu" is jax.nn.gelu's default,
# the tanh approximation (the JAX package's choice; fairseq2's GELU is erf)
_ACTIVATIONS = {"relu": torch.relu,
                "gelu": lambda x: F.gelu(x, approximate="tanh")}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def ffn_init(gen, dim, inner, *, dtype=torch.float32, device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {"layer_norm": layer_norm_init(dim, **kw),
            "inner_proj": linear_init(gen, dim, inner, **kw),
            "output_proj": linear_init(gen, inner, dim, **kw)}


def transformer_layer_init(gen: torch.Generator, cfg: TransformerConfig, *,
                           dtype=torch.float32, device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    p = {"self_attn_layer_norm": layer_norm_init(cfg.dim, **kw),
         "self_attn": attn_ops.mha_init(gen, cfg.dim, cfg.num_heads, **kw),
         "ffn": ffn_init(gen, cfg.dim, cfg.ffn_inner_dim, **kw)}
    if cfg.has_cross_attention:
        p["cross_attn_layer_norm"] = layer_norm_init(cfg.dim, **kw)
        p["cross_attn"] = attn_ops.mha_init(gen, cfg.dim, cfg.num_heads, **kw)
    return p


def transformer_stack_init(gen: torch.Generator, cfg: TransformerConfig, *,
                           dtype=torch.float32, device=None) -> dict:
    return {"layers": [transformer_layer_init(gen, cfg, dtype=dtype, device=device)
                       for _ in range(cfg.num_layers)],
            "layer_norm": layer_norm_init(cfg.dim, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def _layer_forward(p: dict, x: torch.Tensor, cfg: TransformerConfig, *,
                   self_bias: Optional[torch.Tensor],
                   enc_out: Optional[torch.Tensor],
                   cross_bias: Optional[torch.Tensor]) -> torch.Tensor:
    h = layer_norm(p["self_attn_layer_norm"], x)
    x = x + attn_ops.multi_head_attention(p["self_attn"], h, h, cfg.num_heads,
                                          bias=self_bias)
    if enc_out is not None:
        h = layer_norm(p["cross_attn_layer_norm"], x)
        x = x + attn_ops.multi_head_attention(p["cross_attn"], h, enc_out,
                                              cfg.num_heads, bias=cross_bias)
    h = layer_norm(p["ffn"]["layer_norm"], x)
    h = _ACTIVATIONS[cfg.activation](linear(p["ffn"]["inner_proj"], h))
    return x + linear(p["ffn"]["output_proj"], h)


def transformer_encoder(params: dict, x: torch.Tensor, cfg: TransformerConfig, *,
                        padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence encoder stack; each layer is a checkpoint region under
    ``ops/remat.py remat_layers``, the stack a GPipe pipeline under
    ``parallel/pipeline.py pipeline_layers``."""
    bias = padding_bias(padding_mask)
    x = run_layers(
        lambda h, tens, lp: remat.layer_call(_layer_forward, lp, h, cfg,
                                             self_bias=tens["bias"], enc_out=None,
                                             cross_bias=None),
        params["layers"], x, {"bias": bias})
    return layer_norm(params["layer_norm"], x)


def transformer_decoder(params: dict, x: torch.Tensor, cfg: TransformerConfig, *,
                        enc_out: torch.Tensor,
                        enc_padding_mask: Optional[torch.Tensor] = None,
                        self_padding_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Full-sequence causal decoder pass (the re-decode of a hypothesis into
    the features the T2U reads; the training forward); each layer is a
    checkpoint region under ``ops/remat.py remat_layers``."""
    self_bias = combine_masks(causal_mask(x.shape[1], device=x.device)[None, None],
                              padding_bias(self_padding_mask))
    cross_bias = padding_bias(enc_padding_mask)
    x = run_layers(
        lambda h, tens, lp: remat.layer_call(_layer_forward, lp, h, cfg,
                                             self_bias=tens["self_bias"],
                                             enc_out=tens["enc_out"],
                                             cross_bias=tens["cross_bias"]),
        params["layers"], x, {"self_bias": self_bias, "enc_out": enc_out,
                              "cross_bias": cross_bias})
    return layer_norm(params["layer_norm"], x)


# ---------------------------------------------------------------------------
# KV-cached decode step
# ---------------------------------------------------------------------------

class DecoderCache(NamedTuple):
    """Per-layer lists: self-attention KV (B, H, T_max, Dh) and the
    precomputed cross-attention KV (B, H, S, Dh)."""
    self_k: list
    self_v: list
    cross_k: list
    cross_v: list


class DecoderCacheQ8(NamedTuple):
    """int8 variant: (B, H, T_max, Dh) int8 rows with (B, H, T_max) fp32
    scales, per layer.

    ``row_src``: the (B, T_max) int32 row-origin table of the lazy beam
    reorder, shared by all layers. The self-attention buffers are then never
    permuted: row t of logical beam b is read from physical slot
    ``row_src[b, t]`` (``indexed_decode_self_attention_int8``). None: the
    classic reorder, which gathers the buffers."""
    self_k: list
    self_v: list
    self_k_scale: list
    self_v_scale: list
    cross_k: list
    cross_v: list
    cross_k_scale: list
    cross_v_scale: list
    row_src: Optional[torch.Tensor] = None


class DecoderCacheQ4(NamedTuple):
    """Packed-int4 self-KV variant of :class:`DecoderCacheQ8`: (B, H, T_max,
    Dh/2) int8 bytes, two split-half nibbles each, with (B, H, T_max) fp32
    scales absmax/7, per layer. The cross-attention KV stays int8."""
    self_k: list
    self_v: list
    self_k_scale: list
    self_v_scale: list
    cross_k: list
    cross_v: list
    cross_k_scale: list
    cross_v_scale: list


def decoder_cache_init(params: dict, cfg: TransformerConfig, enc_out: torch.Tensor,
                       max_len: int, dtype=None, *, kv_int8: bool = False,
                       kv_bits: int = 8):
    """Empty per-layer self-attention caches of length ``max_len`` and the
    cross-attention K/V of ``enc_out``, computed once. With ``kv_int8``,
    ``kv_bits`` 4 packs the self-attention KV as int4. An int8 cache carries
    the identity ``row_src`` table of the lazy beam reorder when
    ``SEAMLESS_LAZY_REORDER=1`` (opt-in, as in the JAX package)."""
    dtype = dtype or enc_out.dtype
    B, H, L = enc_out.shape[0], cfg.num_heads, cfg.num_layers
    shape = (B, H, max_len, cfg.dim // H)
    dev = enc_out.device

    def zeros(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=dev) for _ in range(L)]

    layers = params["layers"]
    if kv_int8:
        cross = [attn_ops.cross_attention_precompute_int8(lp["cross_attn"], enc_out, H)
                 for lp in layers]
        fields = [[c.k for c in cross], [c.v for c in cross],
                  [c.k_scale for c in cross], [c.v_scale for c in cross]]
        scales = [zeros(shape[:3], torch.float32), zeros(shape[:3], torch.float32)]
        if kv_bits == 4:
            row = shape[:3] + (shape[3] // 2,)
            return DecoderCacheQ4(zeros(row, torch.int8), zeros(row, torch.int8),
                                  *scales, *fields)
        row_src = None
        if os.environ.get("SEAMLESS_LAZY_REORDER", "0") == "1":
            row_src = torch.arange(B, dtype=torch.int32, device=dev)[:, None].repeat(
                1, max_len)
        return DecoderCacheQ8(zeros(shape, torch.int8), zeros(shape, torch.int8),
                              *scales, *fields, row_src)
    cross = [attn_ops.cross_attention_precompute(lp["cross_attn"], enc_out, H)
             for lp in layers]
    return DecoderCache(zeros(shape, dtype), zeros(shape, dtype),
                        [c.k for c in cross], [c.v for c in cross])


def _take(xs: list, src: Optional[torch.Tensor]) -> list:
    return list(xs) if src is None else [x[src] for x in xs]


def decoder_cache_beam_reorder(cache, flat_src: torch.Tensor):
    """The beam reorder of a search that does not read the cache through
    ``beam_src``: gather every self-attention buffer of each layer by the
    (B*K,) ``flat_src`` on its beam axis. The cross-attention K/V is the
    same for the K beams of a batch row and is left as it is. A cache with a
    ``row_src`` table is gathered row by row through the composed table
    ``row_src[flat_src]``, and the table is reset to the identity; with an
    identity table this is the plain gather."""
    src = flat_src.long()
    names = [n for n in ("self_k", "self_v", "self_k_scale", "self_v_scale")
             if n in cache._fields]
    row_src = getattr(cache, "row_src", None)
    if row_src is None:
        return cache._replace(**{n: _take(getattr(cache, n), src) for n in names})
    rs = row_src[src]
    ident = torch.arange(rs.shape[0], dtype=torch.int32, device=rs.device)[:, None]
    return cache._replace(row_src=ident.repeat(1, rs.shape[1]),
                          **{n: [gather_rows(x, rs) for x in getattr(cache, n)]
                             for n in names})


def transformer_decoder_step(params: dict, x_t: torch.Tensor, cache, step: int,
                             cfg: TransformerConfig, *,
                             enc_padding_mask: Optional[torch.Tensor] = None,
                             beam_src: Optional[torch.Tensor] = None):
    """One decode step. ``x_t``: (B, 1, D) embedded current token; ``step``:
    the current position, a host int. ``beam_src``: optional (B,) beam
    origins of the previous beam selection: the caches are read through that
    gather, and the current row is written into the gathered copy.

    With a quantized cache, a ``beam_src`` and tensors on the card, the self
    attention of each layer is one launch of a fused decode-attention kernel
    (``ops/kernels/decode_attention.py``): the int8 one for
    :class:`DecoderCacheQ8`, the packed-int4 one for :class:`DecoderCacheQ4`.
    Otherwise it takes the plain composition. The caches in ``cache`` are
    written in place where no ``beam_src`` is given; the returned cache holds
    the new tensors.

    The lazy beam reorder: an int8 cache with a ``row_src`` table and a
    ``beam_src``. The cache alone decides it: it carries a table only when
    ``SEAMLESS_LAZY_REORDER`` was "1" at its creation, and the variable is
    not read again. The table inherits the source beams' rows and marks
    row ``step`` as each beam's own; each layer's attention reads through it
    (``indexed_decode_self_attention_int8``, a kernel on the card), and the
    only cache write is each beam's quantized new row, in place at
    [b, :, step] of the unpermuted buffers."""
    cross_bias = padding_bias(enc_padding_mask)
    int4 = isinstance(cache, DecoderCacheQ4)
    int8 = isinstance(cache, DecoderCacheQ8) or int4
    lazy = (isinstance(cache, DecoderCacheQ8) and beam_src is not None
            and cache.row_src is not None)
    row_src = None
    if lazy:
        B = x_t.shape[0]
        row_src = cache.row_src[beam_src.long()]
        row_src[:, step] = torch.arange(B, dtype=row_src.dtype, device=row_src.device)
    fused = int8 and beam_src is not None and x_t.is_cuda
    fused_step = (fused_decode_self_attention_int4 if int4
                  else fused_decode_self_attention_int8)
    plain_step = (attn_ops.self_attention_step_nocache_int4 if int4
                  else attn_ops.self_attention_step_nocache_int8)
    src = None if beam_src is None else beam_src.long()
    sk, sv = list(cache.self_k), list(cache.self_v)
    if int8:
        sks, svs = list(cache.self_k_scale), list(cache.self_v_scale)
    act = _ACTIVATIONS[cfg.activation]
    h = x_t
    for i, lp in enumerate(params["layers"]):
        z = layer_norm(lp["self_attn_layer_norm"], h)
        ap = lp["self_attn"]
        if lazy:
            qh, kh, vh = (attn_ops._split_heads(linear(ap[n], z), cfg.num_heads)[:, :, 0]
                          .contiguous() for n in ("q_proj", "k_proj", "v_proj"))
            o = indexed_decode_self_attention_int8(qh, kh, vh, sk[i], sv[i], sks[i],
                                                   svs[i], row_src, step)
            # safe in place: the attention above read only rows t < step
            kq, ks = attn_ops.quantize_kv_rows(kh)
            vq, vs = attn_ops.quantize_kv_rows(vh)
            sk[i][:, :, step], sv[i][:, :, step] = kq, vq
            sks[i][:, :, step], svs[i][:, :, step] = ks, vs
            y = linear(ap["output_proj"], attn_ops._merge_heads(o[:, :, None]))
        elif fused:
            heads = [attn_ops._split_heads(linear(ap[n], z), cfg.num_heads)[:, :, 0]
                     .contiguous() for n in ("q_proj", "k_proj", "v_proj")]
            o, sk[i], sv[i], sks[i], svs[i] = fused_step(
                *heads, sk[i], sv[i], sks[i], svs[i], step, beam_src)
            y = linear(ap["output_proj"], attn_ops._merge_heads(o[:, :, None]))
        elif int8:
            ski, svi, sksi, svsi = _take((sk[i], sv[i], sks[i], svs[i]), src)
            y, kq, ks, vq, vs = plain_step(ap, z, ski, svi, sksi, svsi, step,
                                           cfg.num_heads)
            ski[:, :, step], svi[:, :, step] = kq[:, :, 0], vq[:, :, 0]
            sksi[:, :, step], svsi[:, :, step] = ks[:, :, 0], vs[:, :, 0]
            sk[i], sv[i], sks[i], svs[i] = ski, svi, sksi, svsi
        else:
            ski, svi = _take((sk[i], sv[i]), src)
            y, k_t, v_t = attn_ops.self_attention_step_nocache(
                ap, z, ski, svi, step, cfg.num_heads)
            ski[:, :, step] = k_t[:, :, 0].to(ski.dtype)
            svi[:, :, step] = v_t[:, :, 0].to(svi.dtype)
            sk[i], sv[i] = ski, svi
        h = h + y
        z = layer_norm(lp["cross_attn_layer_norm"], h)
        if int8:
            cross_kv = Int8KVCache(cache.cross_k[i], cache.cross_v[i],
                                   cache.cross_k_scale[i], cache.cross_v_scale[i])
            h = h + attn_ops.cross_attention_step_int8(
                lp["cross_attn"], z, cross_kv, cfg.num_heads, bias=cross_bias)
        else:
            cross_kv = KVCache(cache.cross_k[i], cache.cross_v[i])
            h = h + attn_ops.cross_attention_step(
                lp["cross_attn"], z, cross_kv, cfg.num_heads, bias=cross_bias)
        z = layer_norm(lp["ffn"]["layer_norm"], h)
        z = act(linear(lp["ffn"]["inner_proj"], z))
        h = h + linear(lp["ffn"]["output_proj"], z)
    out = layer_norm(params["layer_norm"], h)
    if lazy:
        return out, cache._replace(row_src=row_src)
    if int8:
        return out, cache._replace(self_k=sk, self_v=sv, self_k_scale=sks,
                                   self_v_scale=svs)
    return out, cache._replace(self_k=sk, self_v=sv)


# ---------------------------------------------------------------------------
# Embedding frontend and tied projection
# ---------------------------------------------------------------------------

def embedding_frontend(embed_params: dict, ids: torch.Tensor, cfg: TransformerConfig, *,
                       padding_mask: Optional[torch.Tensor] = None,
                       start_step: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """ids -> embeddings scaled by sqrt(dim) + sinusoidal positions (fairseq
    convention: positions offset by pad_idx + 1); ``start_step`` is one int
    or a (B,) tensor, a first position for each row."""
    x = embedding(embed_params, ids, scale=cfg.dim ** 0.5)
    return apply_sinusoidal_pos(x, padding_mask=padding_mask, padding_idx=cfg.pad_idx,
                                start_step=start_step)


def tied_projection(embed_params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits through the tied embedding matrix, fp32; the int8 or int4
    quantized table when present. A table split over "model" gives this
    rank's vocabulary columns only."""
    if "embedding_i8" in embed_params:
        from seamless_communication_torch.ops.quantization import (
            tied_projection_quantized,
        )
        return tied_projection_quantized(embed_params, x)
    if "embedding_i4" in embed_params:
        from seamless_communication_torch.ops.quantization import (
            tied_projection_quantized_int4,
        )
        return tied_projection_quantized_int4(embed_params, x)
    w = embed_params["embedding"]
    shard = model_shard(w)
    if shard is not None:
        # a vocabulary split over "model": this rank's columns of the logits
        # (train/loss.py reduces over the axis)
        x = copy_to(x, shard.axis)
    return torch.matmul(x.float(), w.to(x.dtype).float().T)
