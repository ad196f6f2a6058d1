"""Flash attention with an additive bias and segment ids (kernel K6), the
full-sequence attention of the fused-attention option
(``ops/fused_attention.py``).

    out = softmax_fp32(qs @ k^T + ab + segmask) @ v

- ``qs`` (B, H, Tq, Dh) is q already scaled, in q's dtype; k, v (B, H, Tk,
  Dh) in the same dtype, float32 or bfloat16.
- ``ab``: an optional (B, H, Tq, Tk) additive bias in q's dtype.
- ``segmask`` adds ``MASK_VALUE`` (-0.7 * float32 max, the library's
  ``DEFAULT_MASK_VALUE``) wherever ``q_seg[b, i] != kv_seg[b, j]``.
- The probabilities are cast to v's dtype before the value product, which
  accumulates in fp32; the output is in v's dtype.

CUDA kernel ``csrc/flash_attention.cu``, which replaces the TPU kernel the
JAX package reaches through ``seamless_communication_tpu/ops/
fused_attention.py:54`` (``try_flash``, JAX 0.9.0's Pallas flash attention).
For tensors on the card the wrapper launches it; for tensors on the CPU it
computes ``_reference``, the plain PyTorch version of the same function,
which is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from seamless_communication_torch.ops.kernels import launch_counts

KERNEL = "flash_attention"
MASK_VALUE = float(np.float32(-0.7 * float(np.finfo(np.float32).max)))
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,       # fp32 outside the tensor cores
              torch.bfloat16: 989e12}     # bf16 dense tensor cores


def _reference(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               ab: Optional[torch.Tensor] = None, q_seg: Optional[torch.Tensor] = None,
               kv_seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the logits materialized, the same contract."""
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if ab is not None:
        logits = logits + ab.float()
    if q_seg is not None:
        same = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        logits = logits + torch.where(same, 0.0, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


_functions: dict = {}


def _function():
    """The C entry point, built and loaded at first use, and the library's
    ``cuda_error_string``."""
    if KERNEL not in _functions:
        from seamless_communication_torch.ops.kernels import build

        lib = build.load("flash_attention")
        fn = lib.flash_attention
        # ctypes would pass a Python int as a 32-bit int and cut the pointers
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, p, p, p, p, p] + [ll] * 9 + [i] * 5 + [ctypes.c_float,
                                                                   p, p]
        fn.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _functions[KERNEL] = (fn, lib.cuda_error_string)
    return _functions[KERNEL]


def _check(qs, k, v, ab, q_seg, kv_seg) -> None:
    """Raise on what the kernel does not take."""
    if qs.dtype not in _DTYPE_CODES:
        raise TypeError(f"{KERNEL}: dtype {qs.dtype} is not float32 or bfloat16")
    if qs.dim() != 4:
        raise ValueError(f"{KERNEL}: q is {tuple(qs.shape)}, expected (B, H, Tq, Dh)")
    B, H, Tq, Dh = qs.shape
    Tk = k.shape[2] if k.dim() == 4 else -1
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head dim {Dh} not in {HEAD_DIMS}")
    if Tq < 1 or Tk < 1:
        raise ValueError(f"{KERNEL}: empty sequence (Tq {Tq}, Tk {Tk})")
    if (q_seg is None) != (kv_seg is None):
        raise ValueError(f"{KERNEL}: give both segment id arrays or neither")
    for name, x, shape, dtype in (
            ("k", k, (B, H, Tk, Dh), qs.dtype), ("v", v, (B, H, Tk, Dh), qs.dtype),
            ("ab", ab, (B, H, Tq, Tk), qs.dtype), ("q_seg", q_seg, (B, Tq), torch.int32),
            ("kv_seg", kv_seg, (B, Tk), torch.int32)):
        if x is None:
            continue
        if x.device != qs.device:
            raise ValueError(f"{KERNEL}: {name} is on {x.device}, q on {qs.device}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{KERNEL}: {name} is {tuple(x.shape)} {x.dtype}, "
                             f"expected {shape} {dtype}")
    for name, x in (("q", qs), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{KERNEL}: the last dimension of {name} is not "
                             "contiguous")
    for name, x in (("ab", ab), ("q_seg", q_seg), ("kv_seg", kv_seg)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} is not contiguous")


def _launch(qs, k, v, ab, q_seg, kv_seg) -> torch.Tensor:
    _check(qs, k, v, ab, q_seg, kv_seg)
    B, H, Tq, Dh = qs.shape
    Tk = k.shape[2]
    out = torch.empty((B, H, Tq, Dh), dtype=qs.dtype, device=qs.device)
    fn, error_string = _function()

    def ptr(x):
        return None if x is None else x.data_ptr()

    strides = [s for x in (qs, k, v) for s in x.stride()[:3]]
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        err = fn(_DTYPE_CODES[qs.dtype], qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                 ptr(ab), ptr(q_seg), ptr(kv_seg), *strides, B, H, Tq, Tk, Dh,
                 MASK_VALUE, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed: {error_string(err).decode()} "
                           f"({err})")
    launch_counts[KERNEL] += 1
    return out


def flash_attention(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ab: Optional[torch.Tensor] = None,
                    q_seg: Optional[torch.Tensor] = None,
                    kv_seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax_fp32(qs @ k^T + ab + segmask) @ v`` -> (B, H, Tq, Dh) in v's
    dtype (see the module). q, k and v may be strided views whose last
    dimension is contiguous (heads split from (B, T, D) activations); ``ab``,
    ``q_seg`` (B, Tq) and ``kv_seg`` (B, Tk) int32 are contiguous.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises."""
    if qs.device.type == "cpu":
        return _reference(qs, k, v, ab, q_seg, kv_seg)
    if qs.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {qs.device}")
    return _launch(qs, k, v, ab, q_seg, kv_seg)


def unmasked_pairs(B: int, H: int, Tq: int, Tk: int,
                   ab: Optional[torch.Tensor] = None,
                   q_seg: Optional[torch.Tensor] = None,
                   kv_seg: Optional[torch.Tensor] = None) -> int:
    """How many of the B*H*Tq*Tk logits these inputs leave unmasked: not at
    or below -1e8 in ``ab`` and of equal segment ids. A masked logit's
    probability is exactly 0 beside any unmasked one of its row, so the
    function needs the products of the unmasked pairs only."""
    keep = torch.ones((1, 1, 1, 1), dtype=torch.bool)
    if ab is not None:
        keep = ab.detach().float().cpu() > -1e8
    if q_seg is not None:
        same = q_seg.cpu()[:, None, :, None] == kv_seg.cpu()[:, None, None, :]
        keep = keep & same
    return int(keep.expand(B, H, Tq, Tk).sum())


def bound(B: int, H: int, Tq: int, Tk: int, Dh: int, dtype: torch.dtype,
          has_ab: bool, has_seg: bool, pairs: Optional[int] = None
          ) -> tuple[float, str]:
    """The least time (ms) the card could take for the function, and what
    bounds it: the larger of the bytes it must move (q, k, v and the
    segment ids read once, ``out`` written once, ``ab`` read once) over the
    memory rate and its flops over the peak rate for the dtype (fp32
    outside the tensor cores; bf16 dense tensor cores): 4*Dh a logit that
    ``pairs`` counts (``unmasked_pairs``; by default all B*H*Tq*Tk)."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * H * Tq * Dh + 2 * B * H * Tk * Dh) * elem
    if has_ab:
        nbytes += B * H * Tq * Tk * elem
    if has_seg:
        nbytes += 4 * B * (Tq + Tk)
    pairs = B * H * Tq * Tk if pairs is None else pairs
    bytes_s = nbytes / HBM_BYTES_PER_S
    flops_s = 4 * pairs * Dh / PEAK_FLOPS[dtype]
    return max(bytes_s, flops_s) * 1e3, "bytes" if bytes_s >= flops_s else "operations"
