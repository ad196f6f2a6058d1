"""Multi-head attention (counterpart of
``seamless_communication_tpu/ops/attention.py``): plain scaled-dot-product
attention, Shaw clipped relative-position self-attention (the v2 speech
encoder), Transformer-XL u/v-bias relative-position self-attention (the v1
speech encoder), and the KV-cached single-step decode paths, fp, int8 and
packed int4. With ``SEAMLESS_FUSED_ATTN`` on, every full-sequence attention
goes through the flash-attention kernel where it is eligible
(``ops/fused_attention.py``).

Logit math is fp32; inputs and outputs keep the activation dtype. Caches are
(B, H, T, Dh).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from seamless_communication_torch.ops.fused_attention import try_flash
from seamless_communication_torch.ops.modules import linear, linear_init, true_div
from seamless_communication_torch.parallel.collectives import (
    local_heads, local_part, shared,
)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def mha_init(gen: torch.Generator, dim: int, num_heads: int, *,
             kv_dim: Optional[int] = None, bias: bool = True, dtype=torch.float32,
             device=None) -> dict:
    kv_dim = kv_dim or dim
    kw = dict(bias=bias, dtype=dtype, device=device)
    return {
        "q_proj": linear_init(gen, dim, dim, **kw),
        "k_proj": linear_init(gen, kv_dim, dim, **kw),
        "v_proj": linear_init(gen, kv_dim, dim, **kw),
        "output_proj": linear_init(gen, dim, dim, **kw),
    }


def shaw_attention_init(gen: torch.Generator, dim: int, num_heads: int, *,
                        max_left: int, max_right: int, dtype=torch.float32,
                        device=None) -> dict:
    params = mha_init(gen, dim, num_heads, dtype=dtype, device=device)
    head_dim = dim // num_heads
    num_pos = max_left + max_right + 1
    emb = torch.randn((num_pos, head_dim), generator=gen, dtype=torch.float32,
                      device=device) * head_dim ** -0.5
    params["rel_k_embed"] = {"embedding": emb.to(dtype)}
    return params


# ---------------------------------------------------------------------------
# Core
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, Dh)"""
    B, T, D = x.shape
    return x.reshape(B, T, num_heads, D // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (B, T, D)"""
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: Optional[torch.Tensor], *, extra_logits: Optional[torch.Tensor] = None,
          scale: Optional[float] = None) -> torch.Tensor:
    """Scaled-dot-product attention on (B, H, T, Dh) tensors, fp32 softmax:
    ``softmax(q @ k^T * scale + extra_logits + bias) @ v``. With the fused
    option on, an eligible call goes through the flash-attention kernel
    (``try_flash``); otherwise the plain matmul + softmax, as the JAX package
    computes it with the option off (its default)."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    fused = try_flash(q, k, v, bias, extra_logits, scale)
    if fused is not None:
        return fused
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if extra_logits is not None:
        logits = logits + extra_logits
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def multi_head_attention(params: dict, q_in: torch.Tensor, kv_in: torch.Tensor,
                         num_heads: int, *, bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Full-sequence MHA; ``bias`` is an additive fp32 logit mask broadcastable
    to (B, H, Tq, Tk)."""
    num_heads = local_heads(params["q_proj"], num_heads)
    q = _split_heads(linear(params["q_proj"], q_in), num_heads)
    k = _split_heads(linear(params["k_proj"], kv_in), num_heads)
    v = _split_heads(linear(params["v_proj"], kv_in), num_heads)
    out = _sdpa(q, k, v, bias)
    return linear(params["output_proj"], _merge_heads(out))


def shaw_self_attention(params: dict, x: torch.Tensor, num_heads: int, *,
                        max_left: int, max_right: int,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits[i,j] = (q_i.k_j + q_i.E[clip(j-i, -L, R) + L]) / sqrt(dh).

    The relative term is taken as the JAX package takes it: the (B,H,T,P)
    products with the P embeddings, then a product with the (T,T,P) one-hot
    of the clipped distance. Each output sums exactly one nonzero term.
    With the projections split over "model" a rank computes its own heads,
    each with the whole (replicated) table."""
    num_heads = local_heads(params["q_proj"], num_heads)
    q = _split_heads(linear(params["q_proj"], x), num_heads)
    k = _split_heads(linear(params["k_proj"], x), num_heads)
    v = _split_heads(linear(params["v_proj"], x), num_heads)
    T = x.shape[1]
    dh = q.shape[-1]
    rel = shared(params["rel_k_embed"]["embedding"], params["q_proj"]).to(q.dtype)  # (P, Dh)
    pos = torch.arange(T, device=x.device)
    idx = torch.clamp(pos[None, :] - pos[:, None], -max_left, max_right) + max_left
    rel_logits_full = torch.matmul(q.float(), rel.float().T)         # (B,H,T,P)
    P = rel.shape[0]
    onehot = (idx[:, :, None] == torch.arange(P, device=x.device)).float()
    rel_logits = torch.einsum("bhqp,qjp->bhqj", rel_logits_full, onehot)
    out = _sdpa(q, k, v, bias, extra_logits=rel_logits / math.sqrt(dh))
    return linear(params["output_proj"], _merge_heads(out))


# ---------------------------------------------------------------------------
# Transformer-XL u/v-bias relative attention (the v1 w2v-BERT conformer)
# ---------------------------------------------------------------------------

def xl_rel_table(seq_len: int, dim: int, dtype=torch.float32, device=None
                 ) -> torch.Tensor:
    """(2*seq_len - 1, dim) interleaved sin/cos encodings of the signed
    distance; row m encodes d = (seq_len - 1) - m (positive: the key left of
    the query). The table form of the relative positions that
    ``_xl_rel_bias`` factorises."""
    half = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    inv_freq = torch.exp(half * (-math.log(10000.0) / dim))
    d = torch.arange(seq_len - 1, -seq_len, -1, dtype=torch.float32,
                     device=device)[:, None]
    ang = d * inv_freq[None, :]
    table = torch.zeros((2 * seq_len - 1, dim), dtype=torch.float32, device=device)
    table[:, 0::2] = torch.sin(ang)
    table[:, 1::2] = torch.cos(ang)
    return table.to(dtype)


def xl_attention_init(gen: torch.Generator, dim: int, num_heads: int, *,
                      dtype=torch.float32, device=None) -> dict:
    params = mha_init(gen, dim, num_heads, dtype=dtype, device=device)
    head_dim = dim // num_heads
    params["r_proj"] = linear_init(gen, dim, dim, bias=False, dtype=dtype,
                                   device=device)
    params["u_bias"] = torch.zeros((num_heads, head_dim), dtype=dtype, device=device)
    params["v_bias"] = torch.zeros((num_heads, head_dim), dtype=dtype, device=device)
    return params


def _xl_rel_bias(qv: torch.Tensor, w_r: torch.Tensor) -> torch.Tensor:
    """The relative-position term bd[b,h,i,j] = (q+v)[b,h,i] . r(i-j)[h] in
    the factorised form of the JAX package: the sinusoids of the signed
    distance split by the addition formula

        sin((i-j)w) = sin(iw)cos(jw) - cos(iw)sin(jw)
        cos((i-j)w) = cos(iw)cos(jw) + sin(iw)sin(jw)

    so with z = (q+v) routed back through the sin and cos input rows of the
    r-projection (z_s, z_c):

        a = z_s*sin_i + z_c*cos_i ;  b = z_c*sin_i - z_s*cos_i
        bd = a @ cos_j^T + b @ sin_j^T

    z, a and b are rounded to the model dtype where the JAX package rounds
    them; the table-and-skew form is the same function in exact arithmetic
    but not in rounding.

    qv: (B, H, T, Dh) = q + v_bias; w_r: the (E, D) r_proj weight, (in,
    out). Returns (B, H, T, T) fp32."""
    _, H, T, dh = qv.shape
    E = w_r.shape[0]
    dtype, dev = qv.dtype, qv.device
    inv_freq = torch.exp(torch.arange(0, E, 2, dtype=torch.float32, device=dev)
                         * (-math.log(10000.0) / E))                  # (E/2,)
    ang = torch.arange(T, dtype=torch.float32, device=dev)[:, None] * inv_freq[None, :]
    sin_p, cos_p = torch.sin(ang), torch.cos(ang)                      # (T, E/2)
    # r(d)[h] = rel(d) @ W_r split to heads; rel's even columns are sin, odd cos
    w_s = w_r[0::2].reshape(E // 2, H, dh).to(dtype).float()
    w_c = w_r[1::2].reshape(E // 2, H, dh).to(dtype).float()
    qf = qv.float()
    z_s = torch.einsum("bhid,khd->bhik", qf, w_s).to(dtype)
    z_c = torch.einsum("bhid,khd->bhik", qf, w_c).to(dtype)
    si, ci = sin_p.to(dtype), cos_p.to(dtype)
    a = z_s * si + z_c * ci
    b = z_c * si - z_s * ci
    return (torch.matmul(a.float(), ci.float().T)
            + torch.matmul(b.float(), si.float().T))


def xl_self_attention(params: dict, x: torch.Tensor, num_heads: int, *,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits = ((q+u).k^T + (q+v).r(i-j)^T) / sqrt(dh), through ``_sdpa``
    as ``_sdpa(q + u, k, v, bias, extra_logits=bd * scale, scale=scale)``:
    u is added before the scaling, and the relative term is the post-scale
    additive logit."""
    D = x.shape[-1]
    dh = D // num_heads
    qp = params["q_proj"]
    num_heads = local_heads(qp, num_heads)
    q = _split_heads(linear(qp, x), num_heads)
    k = _split_heads(linear(params["k_proj"], x), num_heads)
    v = _split_heads(linear(params["v_proj"], x), num_heads)
    # with the projections split over "model": this rank's heads of the
    # replicated u, v biases and r-projection columns
    u = local_part(params["u_bias"], qp, 0).to(x.dtype)[None, :, None, :]
    vb = local_part(params["v_bias"], qp, 0).to(x.dtype)[None, :, None, :]
    bd = _xl_rel_bias(q + vb, local_part(params["r_proj"]["weight"], qp, 1))
    scale = 1.0 / math.sqrt(dh)
    out = _sdpa(q + u, k, v, bias, extra_logits=bd * scale, scale=scale)
    return linear(params["output_proj"], _merge_heads(out))


# ---------------------------------------------------------------------------
# KV-cached decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, H, T, Dh)
    v: torch.Tensor


class Int8KVCache(NamedTuple):
    """int8 row-quantized KV; scales are per (batch, head, position) absmax/127."""
    k: torch.Tensor        # (B, H, T, Dh) int8
    v: torch.Tensor
    k_scale: torch.Tensor  # (B, H, T) fp32
    v_scale: torch.Tensor


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., Dh) -> int8 rows + per-row fp32 scales; round half to even."""
    xf = x.float()
    s = torch.clamp_min(true_div(xf.abs().amax(dim=-1), 127.0), 1e-8)
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def _joint_softmax(q, k_t, logits, step: Union[int, torch.Tensor]):
    """Softmax over the history rows t < step of ``logits`` (B,H,1,T) jointly
    with the current row, whose logit comes from the unquantized ``k_t``.
    ``step`` is one int or a (B,) tensor, each row's own step. Returns
    (p_hist (B,H,1,T) with row ``step`` zeroed, p_cur (B,H,1))."""
    dh = q.shape[-1]
    t_max = logits.shape[-1]
    logit_cur = true_div((q.float() * k_t.float()).sum(-1), math.sqrt(dh))  # (B,H,1)
    t = torch.arange(t_max, device=q.device)[None, None, None, :]
    if isinstance(step, torch.Tensor):
        step = step.to(q.device).view(-1, 1, 1, 1)
    valid = t < step
    is_cur = t == step
    logits = torch.where(valid, logits,
                         torch.where(is_cur, logit_cur[..., None], -1e9))
    probs = torch.softmax(logits, dim=-1)
    p_hist = torch.where(is_cur, 0.0, probs)
    p_cur = torch.where(is_cur, probs, 0.0).sum(-1)                    # (B,H,1)
    return p_hist, p_cur


def self_attention_step_nocache(params: dict, x_t: torch.Tensor,
                                k_cache: torch.Tensor, v_cache: torch.Tensor,
                                step: Union[int, torch.Tensor], num_heads: int):
    """Causal decode attention that does not write the cache: history rows
    t < step come from the caches, the current token's K/V are used exactly.
    ``step`` is one int or a (B,) tensor of each row's step. Returns (y, k_t,
    v_t); the caller stores the current row."""
    dtype = x_t.dtype
    q = _split_heads(linear(params["q_proj"], x_t), num_heads)       # (B,H,1,Dh)
    k_t = _split_heads(linear(params["k_proj"], x_t), num_heads)
    v_t = _split_heads(linear(params["v_proj"], x_t), num_heads)
    dh = q.shape[-1]
    logits = true_div(torch.matmul(q.float(), k_cache.to(dtype).float()
                                   .transpose(-1, -2)), math.sqrt(dh))
    p_hist, p_cur = _joint_softmax(q, k_t, logits, step)
    out = torch.matmul(p_hist.to(dtype).float(), v_cache.to(dtype).float())
    out = (out + p_cur[..., None] * v_t.float()).to(dtype)
    y = linear(params["output_proj"], _merge_heads(out))
    return y, k_t, v_t


def self_attention_step_nocache_int8(params: dict, x_t: torch.Tensor,
                                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                                     k_scale: torch.Tensor, v_scale: torch.Tensor,
                                     step: int, num_heads: int):
    """int8-KV variant of :func:`self_attention_step_nocache`. Returns
    (y, kq, ks, vq, vs): the quantized current row for the caller to store."""
    dtype = x_t.dtype
    q = _split_heads(linear(params["q_proj"], x_t), num_heads)       # (B,H,1,Dh)
    k_t = _split_heads(linear(params["k_proj"], x_t), num_heads)
    v_t = _split_heads(linear(params["v_proj"], x_t), num_heads)
    kq, ks = quantize_kv_rows(k_t)
    vq, vs = quantize_kv_rows(v_t)
    dh = q.shape[-1]
    logits = torch.matmul(q.float(), k_cache.to(dtype).float().transpose(-1, -2))
    logits = true_div(logits * k_scale[:, :, None, :], math.sqrt(dh))
    p_hist, p_cur = _joint_softmax(q, k_t, logits, step)
    out = torch.matmul((p_hist * v_scale[:, :, None, :]).to(dtype).float(),
                       v_cache.to(dtype).float())
    out = (out + p_cur[..., None] * v_t.float()).to(dtype)
    y = linear(params["output_proj"], _merge_heads(out))
    return y, kq, ks, vq, vs


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., n) int4 values (n even) -> (..., n/2) int8, split-half packed:
    byte j holds value j in its low nibble and value j + n/2 in its high
    nibble. Packed in int32 (``hi * 16`` rather than a shift of a negative
    int8)."""
    n = q.shape[-1]
    if n % 2:
        raise ValueError(f"int4 packing needs an even last axis, got {n}")
    q = q.to(torch.int32)
    return ((q[..., :n // 2] & 0x0F) | (q[..., n // 2:] * 16)).to(torch.int8)


def quantize_kv_rows_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., Dh) -> packed int4 rows (..., Dh/2) int8 (``pack_int4``) +
    per-row fp32 scales absmax/7, round half to even."""
    xf = x.float()
    s = torch.clamp_min(true_div(xf.abs().amax(dim=-1), 7.0), 1e-8)
    return pack_int4(torch.round(xf / s[..., None]).clamp(-7, 7)), s


def unpack_int4(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed (..., Dh/2) int8 -> (lo, hi) int8 halves, each nibble sign
    extended (full row = concat([lo, hi], -1)). Computed in int32."""
    p = packed.to(torch.int32)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = torch.div(p, 16, rounding_mode="floor")
    return lo.to(torch.int8), hi.to(torch.int8)


def self_attention_step_nocache_int4(params: dict, x_t: torch.Tensor,
                                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                                     k_scale: torch.Tensor, v_scale: torch.Tensor,
                                     step: int, num_heads: int):
    """Packed-int4-KV variant of :func:`self_attention_step_nocache_int8`:
    caches are (B, H, T, Dh/2) split-half packed nibbles, and the contractions
    split into a low-half and a high-half product. Returns (y, kq4, ks, vq4,
    vs): the packed current row for the caller to store."""
    dtype = x_t.dtype
    q = _split_heads(linear(params["q_proj"], x_t), num_heads)       # (B,H,1,Dh)
    k_t = _split_heads(linear(params["k_proj"], x_t), num_heads)
    v_t = _split_heads(linear(params["v_proj"], x_t), num_heads)
    kq, ks = quantize_kv_rows_int4(k_t)
    vq, vs = quantize_kv_rows_int4(v_t)
    dh = q.shape[-1]
    qf = q.float()
    k_lo, k_hi = (k.to(dtype).float().transpose(-1, -2) for k in unpack_int4(k_cache))
    logits = (torch.matmul(qf[..., :dh // 2], k_lo)
              + torch.matmul(qf[..., dh // 2:], k_hi))
    logits = true_div(logits * k_scale[:, :, None, :], math.sqrt(dh))
    p_hist, p_cur = _joint_softmax(q, k_t, logits, step)
    pv = (p_hist * v_scale[:, :, None, :]).to(dtype).float()
    out = torch.cat([torch.matmul(pv, v.to(dtype).float())
                     for v in unpack_int4(v_cache)], dim=-1)
    out = (out + p_cur[..., None] * v_t.float()).to(dtype)
    y = linear(params["output_proj"], _merge_heads(out))
    return y, kq, ks, vq, vs


def cross_attention_precompute(params: dict, enc_out: torch.Tensor,
                               num_heads: int) -> KVCache:
    """Project the encoder output to K/V once; reused at every decode step."""
    k = _split_heads(linear(params["k_proj"], enc_out), num_heads)
    v = _split_heads(linear(params["v_proj"], enc_out), num_heads)
    return KVCache(k, v)


def cross_attention_precompute_int8(params: dict, enc_out: torch.Tensor,
                                    num_heads: int) -> Int8KVCache:
    kv = cross_attention_precompute(params, enc_out, num_heads)
    kq, ks = quantize_kv_rows(kv.k)
    vq, vs = quantize_kv_rows(kv.v)
    return Int8KVCache(kq, vq, ks, vs)


def cross_attention_step(params: dict, x_t: torch.Tensor, enc_kv: KVCache,
                         num_heads: int, *, bias: Optional[torch.Tensor] = None,
                         return_probs: bool = False):
    """Attention of ``x_t`` (B, T, D) over the projected encoder output;
    with ``return_probs`` it returns (y, the (B, H, T, S) fp32 attention
    probabilities), else y."""
    q = _split_heads(linear(params["q_proj"], x_t), num_heads)
    dh = q.shape[-1]
    logits = true_div(torch.matmul(q.float(), enc_kv.k.to(q.dtype).float()
                                   .transpose(-1, -2)), math.sqrt(dh))
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(q.dtype).float(), enc_kv.v.to(q.dtype).float())
    y = linear(params["output_proj"], _merge_heads(out.to(x_t.dtype)))
    return (y, probs) if return_probs else y


def cross_attention_step_int8(params: dict, x_t: torch.Tensor, enc_kv: Int8KVCache,
                              num_heads: int, *,
                              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    dtype = x_t.dtype
    q = _split_heads(linear(params["q_proj"], x_t), num_heads)
    dh = q.shape[-1]
    logits = torch.matmul(q.float(), enc_kv.k.to(dtype).float().transpose(-1, -2))
    logits = true_div(logits * enc_kv.k_scale[:, :, None, :], math.sqrt(dh))
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul((probs * enc_kv.v_scale[:, :, None, :]).to(dtype).float(),
                       enc_kv.v.to(dtype).float()).to(dtype)
    return linear(params["output_proj"], _merge_heads(out))
