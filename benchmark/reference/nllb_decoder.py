"""The NLLB dense_1b text decoder of SeamlessM4T v2, teacher-forced over
whole hypotheses: embeddings (the tied table, times sqrt(D), plus fairseq's
sinusoidal positions) and 24 pre-norm layers of causal self-attention,
cross-attention over the encoder output and a ReLU FFN, the final layer
norm and the tied vocabulary projection.

The configuration's int8 KV cache is worked out again: a beam step reads
the earlier positions' keys and values as int8 rows with one fp32 scale a
(head, position), max |row| / 127 rounded half to even, and its own
position's key and value as computed; the cross-attention keys and values
are int8 rows in the same way. A causal full pass over the hypothesis with
those rows gives every position's logits as the steps did."""

from __future__ import annotations

import math

import torch

from reference.nn import Quant, embed_tokens, heads, int8_rows, layer_norm, merge, project

NEG = -1e9


def _kv_int8(x: torch.Tensor):
    q, s = int8_rows(x, -1)
    return q, s


def _self_attention(qt: Quant, p: dict, z: torch.Tensor, H: int, int8_kv: bool):
    qh, kh, vh = (heads(qt.linear(p[n], n, z), H) for n in ("q_proj", "k_proj", "v_proj"))
    L, dh = z.shape[1], qh.shape[-1]
    i = torch.arange(L, device=z.device)
    hist = i[None, :] < i[:, None]
    diag = i[None, :] == i[:, None]
    qf = qh.float()
    if not int8_kv:
        logits = torch.matmul(qf, kh.float().transpose(-1, -2)) / math.sqrt(dh)
        logits = torch.where(hist | diag, logits, NEG)
        out = torch.matmul(torch.softmax(logits, -1), vh.float())
        return qt.linear(p["output_proj"], "output_proj", merge(out.to(z.dtype)))
    kq, ks = _kv_int8(kh)
    vq, vs = _kv_int8(vh)
    lh = torch.matmul(qf, kq.transpose(-1, -2)) * ks[:, :, None, :] / math.sqrt(dh)
    lc = (qf * kh.float()).sum(-1) / math.sqrt(dh)                   # (R, H, L)
    logits = torch.where(hist, lh, torch.where(diag, lc[..., None], NEG))
    probs = torch.softmax(logits, -1)
    ph = torch.where(hist, probs, 0.0)
    pc = torch.where(diag, probs, 0.0).sum(-1)
    out = torch.matmul(ph * vs[:, :, None, :], vq) + pc[..., None] * vh.float()
    return qt.linear(p["output_proj"], "output_proj", merge(out.to(z.dtype)))


def cross_kv(qt: Quant, layers: list, enc: torch.Tensor, H: int, int8_kv: bool) -> list:
    """Each layer's cross-attention keys and values of the (S, D) encoder
    output: int8 rows and scales, or fp rows."""
    out = []
    for lp in layers:
        p = lp["cross_attn"]
        k = heads(qt.linear(p["k_proj"], "k_proj", enc[None]), H)
        v = heads(qt.linear(p["v_proj"], "v_proj", enc[None]), H)
        out.append((_kv_int8(k), _kv_int8(v)) if int8_kv else (k, v))
    return out


def _cross_attention(qt: Quant, p: dict, z: torch.Tensor, kv, H: int, int8_kv: bool):
    qh = heads(qt.linear(p["q_proj"], "q_proj", z), H).float()
    dh = qh.shape[-1]
    if int8_kv:
        (kq, ks), (vq, vs) = kv
        logits = torch.matmul(qh, kq.transpose(-1, -2)) * ks[:, :, None, :] / math.sqrt(dh)
        out = torch.matmul(torch.softmax(logits, -1) * vs[:, :, None, :], vq)
    else:
        k, v = kv
        logits = torch.matmul(qh, k.float().transpose(-1, -2)) / math.sqrt(dh)
        out = torch.matmul(torch.softmax(logits, -1), v.float())
    return qt.linear(p["output_proj"], "output_proj", merge(out.to(z.dtype)))


def logits(qt: Quant, p: dict, dec: dict, tokens: torch.Tensor, kv: list,
           int8_kv: bool = True) -> torch.Tensor:
    """(R, L) token rows -> (R, L, V) fp32 logits of the next token at each
    position, over ``kv = cross_kv(...)``."""
    H = dec["num_heads"]
    x = embed_tokens(qt, p["embed"]["embedding"], tokens, dec["pad_idx"])
    for lp, lkv in zip(p["stack"]["layers"], kv):
        x = x + _self_attention(qt, lp["self_attn"], layer_norm(lp["self_attn_layer_norm"], x),
                                H, int8_kv)
        x = x + _cross_attention(qt, lp["cross_attn"],
                                 layer_norm(lp["cross_attn_layer_norm"], x), lkv, H, int8_kv)
        f = lp["ffn"]
        h = torch.relu(qt.linear(f["inner_proj"], "inner_proj", layer_norm(f["layer_norm"], x)))
        x = x + qt.linear(f["output_proj"], "output_proj", h)
    x = layer_norm(p["stack"]["layer_norm"], x)
    return project(qt, p["embed"]["embedding"], x)
