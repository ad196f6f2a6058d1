"""Stable top-k, shared by the beam search and the vocabulary kernels'
wrappers: ties rank the lower index first, as ``jax.lax.top_k`` does
(``torch.topk`` does not promise it)."""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
