"""FiLM conditioning (counterpart of
``seamless_communication_tpu/models/unity/film.py``):
y = (s_gamma * gamma + 1) * x + s_beta * beta, with [gamma | beta] = proj(cond)."""

from __future__ import annotations

import torch

from seamless_communication_torch.ops.modules import linear, linear_init


def film_init(gen: torch.Generator, cond_dim: int, embed_dim: int, *,
              dtype=torch.float32, device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {"proj": linear_init(gen, cond_dim, 2 * embed_dim, **kw),
            "s_gamma": torch.ones((1,), **kw),
            "s_beta": torch.ones((1,), **kw)}


def film(params: dict, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """x (B, T, H); cond (B, 1, C), broadcast over time. An fp32 condition
    over bf16 hidden states gives fp32, as in the JAX package."""
    gamma, beta = torch.chunk(linear(params["proj"], cond), 2, dim=-1)
    gamma = params["s_gamma"].to(x.dtype) * gamma
    beta = params["s_beta"].to(x.dtype) * beta
    return (gamma + 1.0) * x + beta
