"""Sinusoidal positional encodings (counterpart of the sinusoidal part of
``seamless_communication_tpu/ops/positional.py``): fairseq [sin | cos] halves
with inverse frequency ``exp(-log(10000) * i / (half - 1))`` and fairseq's
padding-aware positions, which start at ``padding_idx + 1``."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch


def _sin_cos(steps: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    inv_freq = torch.exp(torch.arange(half, dtype=torch.float32, device=steps.device)
                         * (-math.log(10000.0) / (half - 1)))
    ang = steps.to(torch.float32)[:, None] * inv_freq[None, :]
    table = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    if dim % 2 == 1:
        table = torch.cat([table, table.new_zeros((table.shape[0], 1))], dim=1)
    return table


def sinusoidal_positions(num_positions: int, dim: int, *,
                         padding_idx: Optional[int] = None, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """(num_positions, dim) table of positions 0..num_positions-1; the row
    ``padding_idx`` is zero."""
    table = _sin_cos(torch.arange(num_positions, device=device), dim)
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return table.to(dtype)


def apply_sinusoidal_pos(x: torch.Tensor, *,
                         padding_mask: Optional[torch.Tensor] = None,
                         padding_idx: int = 1,
                         start_step: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Add sinusoidal positions to (B, T, D) embeddings: valid step ``t`` gets
    position ``padding_idx + 1 + start_step + t``. ``start_step`` is one int
    for every row or a (B,) tensor, a start for each row."""
    B, T, D = x.shape
    steps = torch.arange(T, device=x.device)
    if isinstance(start_step, torch.Tensor):
        steps = steps[None, :] + start_step.to(x.device)[:, None]        # (B, T)
    else:
        steps = steps + start_step
    steps = steps + padding_idx + 1
    pos = _sin_cos(steps.reshape(-1), D).reshape(*steps.shape, D)
    pos = torch.where((steps == padding_idx)[..., None], 0.0, pos).to(x.dtype)
    if padding_mask is not None:
        pos = pos * padding_mask[..., None].to(x.dtype)
    return x + pos
