"""Fused beam-gather + int8 KV-row insert + causal decode attention.

One decode step of int8-KV self-attention for one layer: gather the
(B,H,T,Dh) int8 caches and their (B,H,T) scales by the beam origin ``src``,
attend over the history rows t < step plus the unquantized current row, and
write the current row, quantized, at ``step``.

``fused_decode_self_attention_int8`` launches the CUDA kernel
``csrc/decode_attention.cu`` for tensors on the card, which replaces the TPU
kernel ``seamless_communication_tpu/ops/kernels/decode_attention.py:75``. For
tensors on the CPU it computes ``_reference``, the plain PyTorch version of
the same function, which is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from seamless_communication_torch.ops.attention import quantize_kv_rows
from seamless_communication_torch.ops.kernels import launch_counts
from seamless_communication_torch.ops.modules import true_div

NEG = -1e9
KERNEL = "decode_attention_int8"
MAX_HEAD_DIM = 256
MAX_CACHE_LEN = 8192          # logits live in 4 bytes of shared memory per row
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _reference(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step: int, src):
    """Plain PyTorch version. q/k_t/v_t (B,H,Dh); caches (B,H,T,Dh) int8;
    scales (B,H,T) f32; ``src`` (B,) beam origins; ``step`` a host int.
    Returns (out (B,H,Dh), new_k, new_v, new_k_scale, new_v_scale)."""
    dtype = q.dtype
    T = k_cache.shape[2]
    dh = q.shape[-1]
    src = src.long()
    k_cache, v_cache = k_cache[src], v_cache[src]
    k_scale, v_scale = k_scale[src], v_scale[src]

    logits = torch.einsum("bhd,bhtd->bht", q.float(), k_cache.to(dtype).float())
    logits = true_div(logits * k_scale, math.sqrt(dh))
    lcur = true_div((q.float() * k_t.float()).sum(-1), math.sqrt(dh))
    valid = torch.arange(T, device=q.device)[None, None, :] < step
    logits = torch.where(valid, logits, NEG)
    m = torch.maximum(logits.amax(dim=-1), lcur)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    pc = torch.exp(lcur - m)
    den = p.sum(dim=-1) + pc
    out = torch.einsum("bht,bhtd->bhd", (p * v_scale).to(dtype).float(),
                       v_cache.to(dtype).float())
    out = (out + pc[..., None] * v_t.float()) / den[..., None]

    # the gathered buffers are fresh copies: writing row `step` is safe
    kq, ks = quantize_kv_rows(k_t)
    vq, vs = quantize_kv_rows(v_t)
    k_cache[:, :, step] = kq
    v_cache[:, :, step] = vq
    k_scale[:, :, step] = ks
    v_scale[:, :, step] = vs
    return out.to(dtype), k_cache, v_cache, k_scale, v_scale


def _library():
    from seamless_communication_torch.ops.kernels import build

    lib = build.load("decode_attention")
    # ctypes would pass a Python int as a 32-bit int and cut the pointers
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_int8.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                          ctypes.c_float, p, p, p, p, p, p]
    lib.decode_attention_int8.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step, src):
    B, H, T, Dh = k_cache.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{KERNEL}: q dtype {q.dtype} is not float32 or bfloat16")
    for name, x, shape, dtype in (
            ("q", q, (B, H, Dh), q.dtype), ("k_t", k_t, (B, H, Dh), q.dtype),
            ("v_t", v_t, (B, H, Dh), q.dtype),
            ("k_cache", k_cache, (B, H, T, Dh), torch.int8),
            ("v_cache", v_cache, (B, H, T, Dh), torch.int8),
            ("k_scale", k_scale, (B, H, T), torch.float32),
            ("v_scale", v_scale, (B, H, T), torch.float32),
            ("src", src, (B,), torch.int32)):
        if x.device != q.device:
            raise ValueError(f"{KERNEL}: {name} is on {x.device}, q on {q.device}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{KERNEL}: {name} is {tuple(x.shape)} {x.dtype}, "
                             f"expected {shape} {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} is not contiguous")
    if Dh % 16 or Dh > MAX_HEAD_DIM:
        raise ValueError(f"{KERNEL}: head dim {Dh} must be a multiple of 16, "
                         f"at most {MAX_HEAD_DIM}")
    if T > MAX_CACHE_LEN:
        raise ValueError(f"{KERNEL}: cache length {T} exceeds {MAX_CACHE_LEN}")
    if not 0 <= step < T:
        raise ValueError(f"{KERNEL}: step {step} outside [0, {T})")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{KERNEL}: int8 caches must be 16-byte aligned")


def _launch(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step: int, src):
    _check(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step, src)
    B, H, T, Dh = k_cache.shape
    out = torch.empty_like(q)
    new_k, new_v = torch.empty_like(k_cache), torch.empty_like(v_cache)
    new_ks, new_vs = torch.empty_like(k_scale), torch.empty_like(v_scale)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_int8(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), src.data_ptr(), B, H, T, Dh, int(step),
            math.sqrt(Dh), out.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
            new_ks.data_ptr(), new_vs.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    launch_counts[KERNEL] += 1
    return out, new_k, new_v, new_ks, new_vs


def fused_decode_self_attention_int8(q, k_t, v_t, k_cache, v_cache, k_scale,
                                     v_scale, step: int, src):
    """Fused gather + insert + attend decode step over an int8 KV cache.

    q/k_t/v_t: (B,H,Dh) projected current-token tensors (float32 or
    bfloat16); caches (B,H,T,Dh) int8 with (B,H,T) f32 row scales; ``src``
    (B,) int32 beam origins applied to the caches; ``step`` the current
    position, a host int. Returns (out (B,H,Dh), new_k, new_v, new_k_scale,
    new_v_scale) in new buffers.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    if q.device.type == "cpu":
        return _reference(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step, src)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {q.device}")
    return _launch(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step, src)


def bound_bytes(B: int, H: int, T: int, Dh: int, *, n_src: int, elem: int) -> int:
    """Bytes the function must move, each input read once and each output
    written once: the cache rows and scales of the ``n_src`` distinct source
    beams, q/k_t/v_t (``elem`` bytes a value) and src in; the B new caches,
    scales and out back."""
    row = 2 * Dh + 2 * 4                       # k and v int8 rows + 2 scales
    reads = n_src * H * T * row + 3 * B * H * Dh * elem + 4 * B
    writes = B * H * T * row + B * H * Dh * elem
    return reads + writes
