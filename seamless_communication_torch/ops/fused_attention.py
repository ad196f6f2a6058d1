"""The fused-attention option (counterpart of
``seamless_communication_tpu/ops/fused_attention.py``): full-sequence
attention through the flash-attention kernel K6
(``ops/kernels/flash_attention.py``) instead of the plain matmul + softmax.

``try_flash`` adapts the ``_sdpa(q, k, v, bias, extra_logits, scale)``
contract to the kernel, as the JAX package adapts it to its library kernel:

- q, k and v of mixed dtypes are promoted to the widest (fp32 queries of
  the int8 EMMA decoder over the incremental encoder's bf16 keys and
  values), as the plain path's product promotes them; the output comes
  back in v's dtype;
- q is scaled first, in q's dtype (the kernel adds no scale), so
  ``logits = q*scale @ k^T + extra_logits + bias``;
- a pure key-padding bias (B, 1, 1, Tk) with no ``extra_logits`` becomes
  key segment ids (``bias > -1e8``), with no ``ab`` at all;
- anything else additive (the Shaw or XL relative-position logits, causal
  and padding biases) is folded into one (B, H, Tq, Tk) ``ab`` in q's dtype:
  extra in fp32, plus bias in fp32, then the cast.

The JAX wrapper pads Tq and Tk to multiples of 128 for its TPU kernel and
segment-masks the padded keys; K6 masks ragged tails itself, which is the
same function, so nothing is padded here.

Under autograd the call is differentiable as JAX's ``custom_vjp`` is: K6
forward, then K6b and K6c backward (``FlashAttention``). The gradient of
``ab`` flows back through the cast to q's dtype and the broadcast into
``extra_logits``: that is how the Shaw ``rel_k_embed`` and the XL
relative-position parameters get theirs; q's flows through the scale.

``SEAMLESS_FUSED_ATTN``: ``0`` (the default, as in the JAX package), ``1``,
or ``auto``, which turns the option on for tensors on the card (the JAX
package's "TPU backends only"). It is read at every call.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from seamless_communication_torch.ops.kernels.flash_attention import flash_attention, padded_bias

_MASK_THRESHOLD = -1e8   # biases at or below this mean "masked"


def enabled(x: torch.Tensor) -> bool:
    """Whether ``SEAMLESS_FUSED_ATTN`` turns the option on for tensors like
    ``x``."""
    mode = os.environ.get("SEAMLESS_FUSED_ATTN", "0").lower()
    if mode in ("0", "off", "false"):
        return False
    if mode in ("1", "on", "true"):
        return True
    return x.is_cuda


def try_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], extra_logits: Optional[torch.Tensor],
              scale: float) -> Optional[torch.Tensor]:
    """Flash attention for ``_sdpa(q, k, v, bias, extra_logits, scale)``.

    Returns the (B, H, Tq, Dh) output in v's dtype, or None where the fused
    path is not taken: the option is off, q is not a 4-d float32 or bfloat16
    tensor, a sequence is shorter than 128, or the bias is not of rank 4.
    The choice depends on the option, shapes and dtype only; on the card an
    eligible call launches K6 (and, in the backward, K6b and K6c) or
    raises."""
    if not enabled(q):
        return None
    if q.dim() != 4 or q.dtype not in (torch.bfloat16, torch.float32):
        return None
    B, H, Tq, _ = q.shape
    Tk = k.shape[2]
    if min(Tq, Tk) < 128:
        return None
    if bias is not None and bias.dim() != 4:
        return None

    out_dtype = v.dtype
    dtype = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = (x.to(dtype) for x in (q, k, v))

    kv_valid = None
    if (bias is not None and extra_logits is None
            and bias.shape[1] == 1 and bias.shape[2] == 1):
        # pure key padding -> segment ids, no ab
        kv_valid = bias[:, 0, 0, :] > _MASK_THRESHOLD               # (B', Tk)
        bias = None

    ab = None
    if extra_logits is not None or bias is not None:
        abf = None if extra_logits is None else extra_logits.float()
        if bias is not None:
            abf = bias.float() if abf is None else abf + bias.float()
        # one materialisation, into rows padded to 16 bytes (the kernels'
        # TMA loads); the kernels read the [..., :Tk] view
        ab = padded_bias(abf.broadcast_to((B, H, Tq, Tk)), q.dtype)

    q_seg = kv_seg = None
    if kv_valid is not None:
        kv_seg = kv_valid.broadcast_to((B, Tk)).to(torch.int32).contiguous()
        q_seg = torch.ones((B, Tq), dtype=torch.int32, device=q.device)
    qs = (q * scale).to(q.dtype)
    return flash_attention(qs, k, v, ab, q_seg, kv_seg).to(out_dtype)
