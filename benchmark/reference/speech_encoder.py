"""The w2v-BERT 2.0 speech encoder of SeamlessM4T v2 and SeamlessStreaming,
one utterance at a time, over its whole (unpadded) length:

- frames stacked two by two (80 -> 160 features), layer norm, projection;
- 24 conformer blocks: x += FFN/2; x += self-attention with Shaw's
  relative keys (distances clipped to [-64, 8]); x += the convolution module
  (pointwise to 2D, GLU, causal depthwise conv of 31, layer norm, swish,
  pointwise); x += FFN/2; layer norm. The streaming encoder attends in
  chunks of 8 frames, every chunk to the left;
- x += FFN/2 (ReLU), the intermediate FFN;
- the length adaptor: stride-8 GLU convs on the attention input and on the
  residual, self-attention, a ReLU FFN; the final layer norm.

``stream_dtype``: the streaming state's dtype. The incremental encoder keeps
each layer's keys and values and its output rows in it, so the attention
reads rounded keys and values and the adaptor runs in it."""

from __future__ import annotations

import math
from typing import Optional

import torch

from reference.nn import Quant, conv1d, glu, heads, layer_norm, merge, swish

NEG = -1e9


def _ffn(q: Quant, p: dict, x: torch.Tensor, act) -> torch.Tensor:
    h = act(q.linear(p["inner_proj"], "inner_proj", layer_norm(p["layer_norm"], x)))
    return q.linear(p["output_proj"], "output_proj", h)


def _attention_mask(T: int, chunk: Optional[int], device) -> torch.Tensor:
    i = torch.arange(T, device=device)
    if chunk is None:
        return torch.zeros((T, T), device=device)
    end = (i // chunk + 1) * chunk
    return torch.where(i[None, :] < end[:, None], 0.0, NEG)


def _shaw_attention(q: Quant, p: dict, x: torch.Tensor, c: dict, mask: torch.Tensor,
                    stream_dtype) -> torch.Tensor:
    H = c["num_heads"]
    qh = heads(q.linear(p["q_proj"], "q_proj", x), H)
    kh = heads(q.linear(p["k_proj"], "k_proj", x), H)
    vh = heads(q.linear(p["v_proj"], "v_proj", x), H)
    if stream_dtype is not None:
        kh, vh = kh.to(stream_dtype).to(x.dtype), vh.to(stream_dtype).to(x.dtype)
    T, dh = x.shape[1], qh.shape[-1]
    i = torch.arange(T, device=x.device)
    idx = (i[None, :] - i[:, None]).clamp(-c["shaw_max_left"], c["shaw_max_right"]) \
        + c["shaw_max_left"]
    table = p["rel_k_embed"]["embedding"].to(x.dtype).float()
    rel = torch.gather(torch.matmul(qh.float(), table.T), 3,
                       idx[None, None].expand(*qh.shape[:2], T, T))
    logits = (torch.matmul(qh.float(), kh.float().transpose(-1, -2)) + rel) / math.sqrt(dh)
    probs = torch.softmax(logits + mask, dim=-1)
    out = torch.matmul(probs.to(x.dtype).float(), vh.float()).to(x.dtype)
    return q.linear(p["output_proj"], "output_proj", merge(out))


def _conformer_block(q: Quant, p: dict, x: torch.Tensor, c: dict, mask, stream_dtype):
    x = x + 0.5 * _ffn(q, p["ffn1"], x, swish)
    x = x + _shaw_attention(q, p["self_attn"], layer_norm(p["self_attn_layer_norm"], x),
                            c, mask, stream_dtype)
    cv = p["conv"]
    h = glu(q.linear(cv["pointwise_conv1"], "pointwise_conv1", layer_norm(cv["layer_norm"], x)))
    K = c["depthwise_kernel_size"]
    h = conv1d(cv["depthwise_conv"], h, pad=(K - 1, 0), groups=c["dim"])
    h = swish(layer_norm(cv["norm"], h))
    x = x + q.linear(cv["pointwise_conv2"], "pointwise_conv2", h)
    x = x + 0.5 * _ffn(q, p["ffn2"], x, swish)
    return layer_norm(p["layer_norm"], x)


def _mha(q: Quant, p: dict, x: torch.Tensor, H: int) -> torch.Tensor:
    qh, kh, vh = (heads(q.linear(p[n], n, x), H) for n in ("q_proj", "k_proj", "v_proj"))
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    out = torch.matmul(torch.softmax(logits, -1).to(vh.dtype).float(), vh.float())
    return q.linear(p["output_proj"], "output_proj", merge(out.to(x.dtype)))


def adaptor_len(enc: dict, rows: int) -> int:
    k, s = enc["adaptor_kernel_size"], enc["adaptor_stride"]
    for _ in range(enc["adaptor_layers"]):
        rows = (rows + 2 * (k // 2) - k) // s + 1
    return rows


def conformer(q: Quant, p: dict, enc: dict, fbank: torch.Tensor,
              stream_dtype=None) -> torch.Tensor:
    """(T, 80) fbank -> (T // 2, D) rows after the intermediate FFN (in
    ``stream_dtype`` where given)."""
    c = enc["conformer"]
    T2 = fbank.shape[0] // enc["fbank_stride"]
    x = fbank[:T2 * enc["fbank_stride"]].reshape(1, T2, -1).float()
    fp = p["feature_projection"]
    x = q.linear(fp["projection"], "projection", layer_norm(fp["layer_norm"], x))
    mask = _attention_mask(T2, enc["chunk_size"], x.device)
    for layer in p["encoder"]:
        x = _conformer_block(q, layer, x, c, mask, stream_dtype)
    ff = p["intermediate_ffn"]
    h = torch.relu(q.linear(ff["inner_proj"], "inner_proj", x))
    x = x + 0.5 * q.linear(ff["output_proj"], "output_proj", h)
    return x[0] if stream_dtype is None else x[0].to(stream_dtype)


def adaptor(q: Quant, p: dict, enc: dict, rows: torch.Tensor) -> torch.Tensor:
    """(T, D) conformer rows -> (adaptor_len(T), D) encoder output, in the
    rows' dtype."""
    x = rows[None]
    k, s = enc["adaptor_kernel_size"], enc["adaptor_stride"]
    for lp in p["adaptor"]:
        res = glu(conv1d(lp["residual_conv"], layer_norm(lp["residual_layer_norm"], x),
                         stride=s, pad=(s // 2, s // 2)))
        h = glu(conv1d(lp["self_attn_conv"], layer_norm(lp["self_attn_layer_norm"], x),
                       stride=s, pad=(s // 2, s // 2)))
        x = _mha(q, lp["self_attn"], h, enc["num_adaptor_heads"]) + res
        x = x + _ffn(q, {"layer_norm": lp["ffn_layer_norm"], **lp["ffn"]}, x, torch.relu)
    assert x.shape[1] == adaptor_len(enc, rows.shape[0])
    return layer_norm(p["inner_layer_norm"], x)[0]


def encode(q: Quant, p: dict, enc: dict, fbank: torch.Tensor) -> torch.Tensor:
    """An utterance's fbank -> (S, D) encoder output."""
    return adaptor(q, p, enc, conformer(q, p, enc, fbank))
