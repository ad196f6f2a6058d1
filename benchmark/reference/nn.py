"""Layers of the reference over the raw weight tree (keys as the
checkpoint lays them out: a linear's ``weight`` is (in, out), a conv's
(kernel, in / groups, out)).

Arithmetic, as the configurations state it: products accumulate in fp32
and return the activations' dtype; layer norms take fp32 statistics. The
int8 weight-only scheme: each selected linear's weight is rounded (half to
even) to int8 with one fp32 scale per output column, max |w| / 127, and
y = (x @ W8) * scale + b; the tied embedding gets one scale per row, which
the vocabulary projection reuses per logit."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


_FP32_SWITCHES = (("cuda", "matmul"), ("cudnn", "conv"), ("cudnn", "rnn"))


def fp32_switches() -> dict:
    """The precision each of torch's float32 switches runs float32 work in:
    cuBLAS products ("cuda.matmul"), cuDNN convolutions and RNNs; "ieee"
    is full float32, anything else ("tf32", "bf16") a lower precision.
    Read through the ``fp32_precision`` settings (a "none" inherits from
    the level above), or through the older ``allow_tf32`` flags where the
    installed torch has no such settings."""
    b = torch.backends
    if not hasattr(b.cuda.matmul, "fp32_precision"):
        mm = b.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest"
        return {"cuda.matmul": "tf32" if mm else "ieee",
                "cudnn.conv": "tf32" if b.cudnn.allow_tf32 else "ieee",
                "cudnn.rnn": "tf32" if b.cudnn.allow_tf32 else "ieee"}
    out = {}
    for mod, op in _FP32_SWITCHES:
        chain = (getattr(getattr(b, mod), op).fp32_precision,
                 getattr(getattr(b, mod), "fp32_precision", "none"),
                 getattr(b, "fp32_precision", "none"))
        out[f"{mod}.{op}"] = next((v for v in chain if v != "none"), "ieee")
    return out


def set_tf32(on: bool) -> None:
    """Every switch of ``fp32_switches`` to TF32 (``on``) or full float32."""
    b = torch.backends
    if not hasattr(b.cuda.matmul, "fp32_precision"):
        b.cuda.matmul.allow_tf32 = on
        b.cudnn.allow_tf32 = on
        torch.set_float32_matmul_precision("high" if on else "highest")
        return
    for mod, op in _FP32_SWITCHES:
        getattr(getattr(b, mod), op).fp32_precision = "tf32" if on else "ieee"


def int8_rows(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 along ``dim``: (values as fp32 integers, fp32 scales
    max |x| / 127 with ``dim`` removed), rounded half to even."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=dim) / torch.tensor(127.0, device=x.device), 1e-8)
    q = torch.round(xf / s.unsqueeze(dim)).clamp(-127, 127)
    return q, s


class Quant:
    """Which linears are int8: those whose parent key is in ``names`` and
    whose weight (times the number of layers in its stack) holds at least
    ``min_size`` values; ``None`` for none."""

    def __init__(self, spec: Optional[dict]):
        self.names = tuple(spec["linears"]) if spec else ()
        self.min_size = spec["min_size"] if spec else 0
        self._cache: dict = {}

    def linear(self, p: dict, name: str, x: torch.Tensor, stack: int = 1) -> torch.Tensor:
        w, b = p["weight"], p.get("bias")
        if name in self.names and w.numel() * stack >= self.min_size:
            key = id(w)
            if key not in self._cache:
                self._cache[key] = int8_rows(w, 0)
            q, s = self._cache[key]
            y = torch.matmul(x.float(), q) * s
        else:
            y = torch.matmul(x.float(), w.float())
        if b is not None:
            y = y + b.float()
        return y.to(x.dtype)

    def table_is_int8(self, table: torch.Tensor) -> bool:
        return bool(self.names) and table.numel() >= self.min_size

    def embedding_rows(self, table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        key = id(table)
        if key not in self._cache:
            self._cache[key] = int8_rows(table, 1)
        return self._cache[key]


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def conv1d(p: dict, x: torch.Tensor, *, stride: int = 1, pad: Sequence[int] = (0, 0),
           groups: int = 1) -> torch.Tensor:
    """(B, T, C) input, (kernel, in / groups, out) weight."""
    w = p["weight"].to(x.dtype)
    y = F.conv1d(F.pad(x.transpose(1, 2), tuple(pad)), w.permute(2, 1, 0), stride=stride,
                 groups=groups).transpose(1, 2)
    if p.get("bias") is not None:
        y = y + p["bias"].to(y.dtype)
    return y.to(x.dtype)


def glu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, D / H)"""
    B, T, D = x.shape
    return x.reshape(B, T, n, D // n).transpose(1, 2)


def merge(x: torch.Tensor) -> torch.Tensor:
    B, H, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, H * d)


def sinusoids(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """fairseq's table: [sin | cos] halves, inverse frequencies
    10000^(-i / (dim / 2 - 1))."""
    half = dim // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=positions.device)
                    * (-math.log(10000.0) / (half - 1)))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def embed_tokens(quant: Quant, table: torch.Tensor, tokens: torch.Tensor,
                 pad_idx: int) -> torch.Tensor:
    """Rows of the tied table times sqrt(dim), plus sinusoidal positions
    starting at pad_idx + 1 (fairseq): (R, L, D), fp32 from an int8 table
    (its rows times their scales), else in the table's dtype."""
    D = table.shape[1]
    pos = torch.arange(tokens.shape[1], device=tokens.device) + pad_idx + 1
    if quant.table_is_int8(table):
        q, s = quant.embedding_rows(table)
        e = q[tokens] * s[tokens][..., None] * math.sqrt(D)
    else:
        e = table[tokens] * torch.tensor(math.sqrt(D), dtype=table.dtype,
                                         device=table.device)
    return e + sinusoids(pos, D)[None].to(e.dtype)


def project(quant: Quant, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits through the tied table: (x @ Q^T) * row scale for an
    int8 table."""
    if not quant.table_is_int8(table):
        return torch.matmul(x.float(), table.to(x.dtype).float().T)
    q, s = quant.embedding_rows(table)
    return torch.matmul(x.float(), q.T) * s
