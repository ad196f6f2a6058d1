"""ECAPA-TDNN prosody embedding (counterpart of
``seamless_communication_tpu/models/pretssel/ecapa_tdnn.py``; the arch:
channels [512 x 4, 1536], kernels [5, 3, 3, 3, 1], dilations [1, 2, 3, 4, 1],
attention 128, Res2Net scale 8, SE 128, global context, embedding 512,
80-mel input).

A TDNN block, three SE-Res2Net blocks, their outputs concatenated (MFA)
into a TDNN, attentive statistics pooling (mean || std, with the global
context), a layer norm, a 1x1 conv to the embedding and an L2
normalisation. Activations (B, T, C); every conv SAME-padded and dilated.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from seamless_communication_torch.ops.modules import (
    conv1d, conv1d_init, layer_norm, layer_norm_init,
)


class EcapaConfig(NamedTuple):
    channels: Sequence[int] = (512, 512, 512, 512, 1536)
    kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1)
    dilations: Sequence[int] = (1, 2, 3, 4, 1)
    attention_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128
    global_context: bool = True
    groups: Sequence[int] = (1, 1, 1, 1, 1)
    embed_dim: int = 512
    input_dim: int = 80


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _tdnn_init(gen, in_ch, out_ch, k, *, groups=1, **kw):
    return {"conv": conv1d_init(gen, in_ch, out_ch, k, groups=groups, **kw),
            "norm": layer_norm_init(out_ch, **kw)}


def ecapa_init(gen: torch.Generator, cfg: EcapaConfig, *, dtype=torch.float32,
               device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    ch = cfg.channels
    blocks = [_tdnn_init(gen, cfg.input_dim, ch[0], cfg.kernel_sizes[0],
                         groups=cfg.groups[0], **kw)]
    for i in range(1, len(ch) - 1):
        scale = cfg.res2net_scale
        b = {"tdnn1": _tdnn_init(gen, ch[i - 1], ch[i], 1, **kw),
             "res2net": {"blocks": [_tdnn_init(gen, ch[i] // scale, ch[i] // scale,
                                               cfg.kernel_sizes[i], **kw)
                                    for _ in range(scale - 1)]},
             "tdnn2": _tdnn_init(gen, ch[i], ch[i], 1, **kw),
             "se": {"conv1": conv1d_init(gen, ch[i], cfg.se_channels, 1, **kw),
                    "conv2": conv1d_init(gen, cfg.se_channels, ch[i], 1, **kw)}}
        if ch[i - 1] != ch[i]:
            b["shortcut"] = conv1d_init(gen, ch[i - 1], ch[i], 1, **kw)
        blocks.append(b)
    asp_in = ch[-1] * (3 if cfg.global_context else 1)
    return {"blocks": blocks,
            "mfa": _tdnn_init(gen, sum(ch[1:-1]), ch[-1], cfg.kernel_sizes[-1], **kw),
            "asp_tdnn": _tdnn_init(gen, asp_in, cfg.attention_channels, 1, **kw),
            "asp_conv": conv1d_init(gen, cfg.attention_channels, ch[-1], 1, **kw),
            "asp_norm": layer_norm_init(ch[-1] * 2, **kw),
            "fc": conv1d_init(gen, ch[-1] * 2, cfg.embed_dim, 1, **kw)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _tdnn(p, x, *, dilation=1, groups=1):
    h = torch.relu(conv1d(p["conv"], x, padding="SAME", dilation=dilation, groups=groups))
    return layer_norm(p["norm"], h, eps=1e-12)


def _res2net(p, x, scale, dilation):
    chunks = torch.chunk(x, scale, dim=-1)
    y = [chunks[0]]
    y_i = None
    for i in range(1, scale):
        y_i = _tdnn(p["blocks"][i - 1], chunks[i] if i == 1 else chunks[i] + y_i,
                    dilation=dilation)
        y.append(y_i)
    return torch.cat(y, dim=-1)


def _se(p, x, mask):
    """Squeeze-excitation: the masked mean over time gates the channels."""
    if mask is not None:
        m = mask[..., None].to(x.dtype)
        s = (x * m).sum(dim=1, keepdim=True) / m.sum(dim=1, keepdim=True).clamp_min(1.0)
    else:
        s = x.mean(dim=1, keepdim=True)
    s = torch.relu(conv1d(p["conv1"], s, padding="SAME"))
    s = torch.sigmoid(conv1d(p["conv2"], s, padding="SAME"))
    return s * x


def _stats(x, w, eps=1e-12):
    """Weighted mean and std over time: x (B, T, C), w (B, T, 1) weights
    summing to 1; the variance clipped at ``eps``."""
    mean = (w * x).sum(dim=1)
    var = (w * (x - mean[:, None, :]).square()).sum(dim=1)
    return mean, torch.sqrt(var.clamp_min(eps))


def ecapa_forward(params: dict, x: torch.Tensor, cfg: EcapaConfig, *,
                  padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, input_dim) features -> (B, embed_dim) L2-normalised embedding;
    ``padding_mask`` (B, T) True on real frames."""
    feats = []
    h = _tdnn(params["blocks"][0], x, dilation=cfg.dilations[0], groups=cfg.groups[0])
    for i in range(1, len(cfg.channels) - 1):
        p = params["blocks"][i]
        residual = h if "shortcut" not in p else conv1d(p["shortcut"], h, padding="SAME")
        z = _tdnn(p["tdnn1"], h)
        z = _res2net(p["res2net"], z, cfg.res2net_scale, cfg.dilations[i])
        z = _tdnn(p["tdnn2"], z)
        z = _se(p["se"], z, padding_mask)
        h = z + residual
        feats.append(h)
    h = _tdnn(params["mfa"], torch.cat(feats, dim=-1), dilation=cfg.dilations[-1])

    # attentive statistics pooling; masked frames get -inf before the softmax
    B, T, _ = h.shape
    m = (padding_mask[..., None].to(h.dtype) if padding_mask is not None
         else torch.ones((B, T, 1), dtype=h.dtype, device=h.device))
    total = m.sum(dim=1, keepdim=True)
    if cfg.global_context:
        gmean, gstd = _stats(h, m / total)
        attn_in = torch.cat([h, gmean[:, None].expand_as(h), gstd[:, None].expand_as(h)],
                            dim=-1)
    else:
        attn_in = h
    a = _tdnn(params["asp_tdnn"], attn_in)
    a = conv1d(params["asp_conv"], torch.tanh(a), padding="SAME")
    a = torch.where(m > 0, a, -torch.inf)
    mean, std = _stats(h, torch.softmax(a, dim=1))
    pooled = layer_norm(params["asp_norm"], torch.cat([mean, std], dim=-1)[:, None, :],
                        eps=1e-12)
    emb = conv1d(params["fc"], pooled, padding="SAME")[:, 0]
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp_min(1e-12)
