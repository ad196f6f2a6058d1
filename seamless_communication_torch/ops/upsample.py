"""Duration-based upsampling at a fixed output length (counterpart of
``hard_upsample`` in ``seamless_communication_tpu/ops/upsample.py``).

The output has the static length ``max_out_len`` and a validity mask, as in
the JAX package, so the two packages' outputs have the same shapes: output
slot j reads source index i(j) = #{k : ends[k] <= j}, ends = cumsum(durations).
"""

from __future__ import annotations

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
