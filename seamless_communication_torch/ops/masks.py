"""Padding and attention masks (counterpart of
``seamless_communication_tpu/ops/masks.py``): boolean masks are True where a
position is valid; attention masks are additive fp32 biases."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # finite large negative: no NaN from (-inf) - (-inf) in softmax


def lengths_to_padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool mask, True where valid."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def causal_mask(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(length, length) additive bias: 0 on and below the diagonal, NEG_INF
    above."""
    i = torch.arange(length, device=device)
    return torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF).to(dtype)


def padding_bias(key_mask: Optional[torch.Tensor], dtype=torch.float32
                 ) -> Optional[torch.Tensor]:
    """(B, S) bool key mask -> (B, 1, 1, S) additive bias for attention logits."""
    if key_mask is None:
        return None
    return torch.where(key_mask[:, None, None, :], 0.0, NEG_INF).to(dtype)


def combine_masks(*biases: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Sum of additive attention biases, Nones ignored."""
    out = None
    for b in biases:
        if b is not None:
            out = b if out is None else out + b
    return out


def apply_padding_mask(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the padded steps of (B, T, D) activations given a (B, T) bool mask."""
    if mask is None:
        return x
    return x * mask[..., None].to(x.dtype)
