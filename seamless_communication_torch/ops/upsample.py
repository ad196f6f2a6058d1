"""Duration-based upsampling at a fixed output length (counterpart of
``hard_upsample`` and ``gaussian_upsample`` in
``seamless_communication_tpu/ops/upsample.py``).

The output has the static length ``max_out_len`` and a validity mask, as in
the JAX package, so the two packages' outputs have the same shapes: output
slot j reads source index i(j) = #{k : ends[k] <= j}, ends = cumsum(durations).
"""

from __future__ import annotations

from typing import Optional

import torch


def hard_upsample(x: torch.Tensor, durations: torch.Tensor, max_out_len: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Repeat each time step of ``x`` (B, T, D) by its integer duration (B, T).

    Returns (out (B, max_out_len, D) with the slots past the total zeroed,
    out_lengths (B,) int32, the uncapped totals)."""
    ends = torch.cumsum(durations.to(torch.int64), dim=1)            # (B, T)
    total = ends[:, -1]
    j = torch.arange(max_out_len, device=x.device)
    idx = (ends[:, None, :] <= j[None, :, None]).sum(dim=-1)         # (B, U)
    idx = idx.clamp(0, x.shape[1] - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    valid = j[None, :] < total[:, None]
    return out * valid[..., None].to(x.dtype), total.to(torch.int32)


def gaussian_upsample(x: torch.Tensor, durations: torch.Tensor, max_out_len: int, *,
                      delta: float = 0.1, src_mask: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Soft upsampling by durations (PRETSSEL's variance adaptor):
    out_j = sum_i softmax_i(-delta (j - c_i)^2) x_i over the 0-based output
    positions j, with c_i = cumsum(d)_i - d_i / 2 the durations' midpoints,
    all in fp32.

    ``src_mask`` (B, T), True on real positions, masks padded sources only:
    a real source of duration 0 (the expressive EOS unit) still gets weight.
    Without it, the sources of positive duration. Masked energies are -1e9,
    not -inf, as in the JAX package. Returns (out (B, max_out_len, D), the
    slots past the total zeroed, totals (B,) int32)."""
    d32 = durations.float()
    ends = torch.cumsum(d32, dim=1)
    centers = ends - 0.5 * d32                                       # (B, T)
    total = ends[:, -1]
    j = torch.arange(max_out_len, dtype=torch.float32, device=x.device)
    energy = -delta * (j[None, :, None] - centers[:, None, :]) ** 2  # (B, U, T)
    valid_src = durations > 0 if src_mask is None else src_mask
    energy = torch.where(valid_src[:, None, :], energy, -1e9)
    w = torch.softmax(energy, dim=-1)
    out = torch.einsum("but,btd->bud", w.to(x.dtype), x)
    valid = j[None, :] < total[:, None]
    return out * valid[..., None].to(x.dtype), total.to(torch.int32)
