"""Fused beam-gather + KV-row insert + causal decode attention, over an int8
or a packed-int4 KV cache.

One decode step of quantized-KV self-attention for one layer: gather the
caches and their (B,H,T) scales by the beam origin ``src``, attend over the
history rows t < step plus the unquantized current row, and write the current
row, quantized, at ``step``.

- ``fused_decode_self_attention_int8``: (B,H,T,Dh) int8 caches, scales
  absmax/127. CUDA kernel ``csrc/decode_attention.cu``, which replaces the TPU
  kernel ``seamless_communication_tpu/ops/kernels/decode_attention.py:75``.
- ``fused_decode_self_attention_int4``: (B,H,T,Dh/2) caches of split-half
  packed nibbles (byte j = value j low | value j+Dh/2 high), scales absmax/7.
  CUDA kernel ``csrc/decode_attention_int4.cu``, which replaces the TPU kernel
  ``seamless_communication_tpu/ops/kernels/decode_attention.py:267``.
  All three kernels split the rows of a (b, h) over a thread-block cluster;
  the host chooses the split (:func:`split_plan`).
- ``indexed_decode_self_attention_int8``: the lazy beam reorder. The int8
  caches are never permuted: a (B, T) ``row_src`` table says which physical
  slot holds row t of logical beam b, attention reads through it, and only
  ``out`` is returned (the caller writes the new row). CUDA kernel
  ``csrc/decode_attention_indexed.cu`` (K1's design, the rows gathered
  through the table), which replaces the TPU kernel
  ``seamless_communication_tpu/ops/kernels/decode_attention.py:534``.

For tensors on the card a wrapper launches its kernel; for tensors on the CPU
it computes ``_reference`` / ``_reference_int4`` / ``_indexed_reference``,
the plain PyTorch version of the same function, which is also what the kernel
is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from seamless_communication_torch.ops.attention import (
    quantize_kv_rows, quantize_kv_rows_int4, unpack_int4,
)
from seamless_communication_torch.ops.kernels import launch_counts
from seamless_communication_torch.ops.modules import true_div

NEG = -1e9
KERNEL = "decode_attention_int8"
KERNEL_INT4 = "decode_attention_int4"
KERNEL_INDEXED = "decode_attention_indexed"
MAX_HEAD_DIM = 256
MAX_CACHE_LEN = 8192          # a block keeps 8 (K5: 12) bytes of shared memory a row
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# kernel -> (source in csrc/, row bytes per head-dim value, vector load bytes)
_KERNELS = {KERNEL: ("decode_attention", 1.0, 16),
            KERNEL_INT4: ("decode_attention_int4", 0.5, 8),
            KERNEL_INDEXED: ("decode_attention_indexed", 1.0, 16)}


# The split of K1's, K2's and K5's rows (csrc/decode_attention.cuh, which checks
# the same limits): a (b, h) is split over a cluster of up to MAX_CLUSTER
# blocks until the grid holds TARGET_BLOCKS (two for each of the H100's 132
# SMs) or a slice would fall under MIN_SLICE_ROWS rows; a slice streams
# through a ring of at most MAX_STAGES tiles of at most TILE_BYTES.
MAX_CLUSTER = 8
TARGET_BLOCKS = 2 * 132
MIN_SLICE_ROWS = 32
TILE_BYTES = 16 * 1024
MAX_STAGES = 16
SLOT_ALIGN = 128
SMEM_BUDGET = 200 * 1024      # dynamic shared memory of a block, of 227 KB


@dataclass(frozen=True)
class SplitPlan:
    """How K1, K2 and K5 split the T rows of one (b, h): block ``r`` of a
    cluster of ``cluster`` owns rows [r * slice_rows, min(T, (r + 1) *
    slice_rows)), copied in tiles of ``tile_rows`` rows through a ring of
    ``stages`` slots; ``smem_bytes`` is the block's dynamic shared memory."""

    cluster: int
    slice_rows: int
    tile_rows: int
    stages: int
    smem_bytes: int

    def slices(self, T: int) -> list[range]:
        return [range(min(T, r * self.slice_rows), min(T, (r + 1) * self.slice_rows))
                for r in range(self.cluster)]


@functools.lru_cache(maxsize=None)
def split_plan(B: int, H: int, T: int, Dh: int, bits: int,
               cluster: int | None = None, indexed: bool = False) -> SplitPlan:
    """The split of a (B, H, T, Dh) cache of ``bits``-bit values (8 or 4)
    for K1/K2, or (``indexed``) for K5, whose block also keeps its rows'
    slots (4 bytes a row). ``cluster`` forces the cluster size (1, 2, 4 or
    8)."""
    row = Dh * bits // 8
    if cluster is None:
        cluster = 1
        while (cluster < MAX_CLUSTER and B * H * cluster < TARGET_BLOCKS
               and T >= 2 * cluster * MIN_SLICE_ROWS):
            cluster *= 2
    if cluster not in (1, 2, 4, 8):
        raise ValueError(f"cluster size {cluster} is not 1, 2, 4 or 8")
    slice_rows = -(-T // cluster)
    tile_rows = min(slice_rows, TILE_BYTES // row)
    slot = -(-tile_rows * row // SLOT_ALIGN) * SLOT_ALIGN
    scales = (3 if indexed else 2) * 4 * slice_rows
    stages = min(2 * -(-slice_rows // tile_rows), MAX_STAGES,
                 (SMEM_BUDGET - scales) // slot)
    return SplitPlan(cluster, slice_rows, tile_rows, stages, stages * slot + scales)


def _softmax_parts(logits, lcur, step: int):
    """fp32 softmax of the history ``logits`` (B,H,T) masked to t < step,
    jointly with the current row's logit ``lcur`` (B,H). Returns (p (B,H,T),
    pc (B,H), den (B,H))."""
    T = logits.shape[-1]
    valid = torch.arange(T, device=logits.device)[None, None, :] < step
    logits = torch.where(valid, logits, NEG)
    m = torch.maximum(logits.amax(dim=-1), lcur)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    pc = torch.exp(lcur - m)
    return p, pc, p.sum(dim=-1) + pc


def _reference(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step: int, src):
    """Plain PyTorch version. q/k_t/v_t (B,H,Dh); caches (B,H,T,Dh) int8;
    scales (B,H,T) f32; ``src`` (B,) beam origins; ``step`` a host int.
    Returns (out (B,H,Dh), new_k, new_v, new_k_scale, new_v_scale)."""
    dtype = q.dtype
    dh = q.shape[-1]
    src = src.long()
    k_cache, v_cache = k_cache[src], v_cache[src]
    k_scale, v_scale = k_scale[src], v_scale[src]

    logits = torch.einsum("bhd,bhtd->bht", q.float(), k_cache.to(dtype).float())
    logits = true_div(logits * k_scale, math.sqrt(dh))
    lcur = true_div((q.float() * k_t.float()).sum(-1), math.sqrt(dh))
    p, pc, den = _softmax_parts(logits, lcur, step)
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


def _reference_int4(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step: int,
                    src):
    """Plain PyTorch version of the packed-int4 step: as :func:`_reference`
    with (B,H,T,Dh/2) caches. The logits are a low-half plus a high-half
    product; the value contraction writes the two output halves."""
    dtype = q.dtype
    dh = q.shape[-1]
    src = src.long()
    k_cache, v_cache = k_cache[src], v_cache[src]
    k_scale, v_scale = k_scale[src], v_scale[src]

    qf = q.float()
    k_lo, k_hi = (k.to(dtype).float() for k in unpack_int4(k_cache))
    logits = (torch.einsum("bhd,bhtd->bht", qf[..., :dh // 2], k_lo)
              + torch.einsum("bhd,bhtd->bht", qf[..., dh // 2:], k_hi))
    logits = true_div(logits * k_scale, math.sqrt(dh))
    lcur = true_div((qf * k_t.float()).sum(-1), math.sqrt(dh))
    p, pc, den = _softmax_parts(logits, lcur, step)
    pv = (p * v_scale).to(dtype).float()
    out = torch.cat([torch.einsum("bht,bhtd->bhd", pv, v.to(dtype).float())
                     for v in unpack_int4(v_cache)], dim=-1)
    out = (out + pc[..., None] * v_t.float()) / den[..., None]

    kq, ks = quantize_kv_rows_int4(k_t)
    vq, vs = quantize_kv_rows_int4(v_t)
    k_cache[:, :, step] = kq
    v_cache[:, :, step] = vq
    k_scale[:, :, step] = ks
    v_scale[:, :, step] = vs
    return out.to(dtype), k_cache, v_cache, k_scale, v_scale


def gather_rows(x: torch.Tensor, row_src: torch.Tensor) -> torch.Tensor:
    """Row t of logical beam b taken from physical slot ``row_src[b, t]``:
    ``x`` (B, H, T, ...) per-slot rows, ``row_src`` (B, T)."""
    B, H, T = x.shape[:3]
    heads = torch.arange(H, device=x.device)[None, :, None]
    pos = torch.arange(T, device=x.device)[None, None, :]
    return x[row_src.long()[:, None, :], heads, pos]


def _indexed_reference(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, row_src,
                       step: int):
    """Plain PyTorch version of the lazy-reorder step: row t of logical beam
    b is read from physical slot ``row_src[b, t]``, then the arithmetic of
    :func:`_reference`. q/k_t/v_t (B,H,Dh); caches (B,H,T,Dh) int8, scales
    (B,H,T) f32, neither written; ``row_src`` (B,T) int32; ``step`` a host
    int. Returns out (B,H,Dh)."""
    dtype = q.dtype
    dh = q.shape[-1]
    kc, vc, ks, vs = (gather_rows(x, row_src) for x in (k_cache, v_cache, k_scale, v_scale))

    logits = torch.einsum("bhd,bhtd->bht", q.float(), kc.to(dtype).float())
    logits = true_div(logits * ks, math.sqrt(dh))
    lcur = true_div((q.float() * k_t.float()).sum(-1), math.sqrt(dh))
    p, pc, den = _softmax_parts(logits, lcur, step)
    out = torch.einsum("bht,bhtd->bhd", (p * vs).to(dtype).float(),
                       vc.to(dtype).float())
    out = (out + pc[..., None] * v_t.float()) / den[..., None]
    return out.to(dtype)


_functions: dict = {}


def _function(kernel: str):
    """The C entry point of ``kernel``'s library, built and loaded at first
    use, and the library's ``cuda_error_string``."""
    if kernel not in _functions:
        from seamless_communication_torch.ops.kernels import build

        lib = build.load(_KERNELS[kernel][0])
        fn = getattr(lib, kernel)
        # ctypes would pass a Python int as a 32-bit int and cut the pointers
        p, i = ctypes.c_void_p, ctypes.c_int
        if kernel == KERNEL_INDEXED:
            fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                           i, i, i, i, p, p]
        else:
            fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                           i, i, i, i, p, p, p, p, p, p]
        fn.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _functions[kernel] = (fn, lib.cuda_error_string)
    return _functions[kernel]


def _check(kernel, q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step, src):
    """Raise on what the kernel does not take. ``src`` is the (B,) beam
    origins, or for the indexed kernel the (B, T) ``row_src`` table."""
    _, row_per_dim, vector = _KERNELS[kernel]
    B, H, T = k_cache.shape[:3]
    Dh = q.shape[-1]
    row = int(Dh * row_per_dim)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel}: q dtype {q.dtype} is not float32 or bfloat16")
    src_shape = (B, T) if kernel == KERNEL_INDEXED else (B,)
    for name, x, shape, dtype in (
            ("q", q, (B, H, Dh), q.dtype), ("k_t", k_t, (B, H, Dh), q.dtype),
            ("v_t", v_t, (B, H, Dh), q.dtype),
            ("k_cache", k_cache, (B, H, T, row), torch.int8),
            ("v_cache", v_cache, (B, H, T, row), torch.int8),
            ("k_scale", k_scale, (B, H, T), torch.float32),
            ("v_scale", v_scale, (B, H, T), torch.float32),
            ("src", src, src_shape, torch.int32)):
        if x.device != q.device:
            raise ValueError(f"{kernel}: {name} is on {x.device}, q on {q.device}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{kernel}: {name} is {tuple(x.shape)} {x.dtype}, "
                             f"expected {shape} {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    if Dh % 16 or Dh > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head dim {Dh} must be a multiple of 16, "
                         f"at most {MAX_HEAD_DIM}")
    if T > MAX_CACHE_LEN:
        raise ValueError(f"{kernel}: cache length {T} exceeds {MAX_CACHE_LEN}")
    if not 0 <= step < T:
        raise ValueError(f"{kernel}: step {step} outside [0, {T})")
    if k_cache.data_ptr() % vector or v_cache.data_ptr() % vector:
        raise ValueError(f"{kernel}: caches must be {vector}-byte aligned")


def _launch(kernel, q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step: int, src,
            cluster: int | None = None):
    """K1 or K2 on the card; ``cluster`` forces the cluster size of
    :func:`split_plan`."""
    _check(kernel, q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step, src)
    B, H, T = k_cache.shape[:3]
    Dh = q.shape[-1]
    plan = split_plan(B, H, T, Dh, 4 if kernel == KERNEL_INT4 else 8, cluster)
    out = torch.empty_like(q)
    new_k, new_v = torch.empty_like(k_cache), torch.empty_like(v_cache)
    new_ks, new_vs = torch.empty_like(k_scale), torch.empty_like(v_scale)
    fn, error_string = _function(kernel)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
                 v_scale.data_ptr(), src.data_ptr(), B, H, T, Dh, int(step),
                 math.sqrt(Dh), plan.cluster, plan.slice_rows, plan.tile_rows,
                 plan.stages, out.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
                 new_ks.data_ptr(), new_vs.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{error_string(err).decode()} ({err})")
    launch_counts[kernel] += 1
    return out, new_k, new_v, new_ks, new_vs


def _launch_indexed(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, row_src,
                    step: int, cluster: int | None = None):
    """K5 on the card; ``cluster`` forces the cluster size of
    :func:`split_plan`."""
    _check(KERNEL_INDEXED, q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step,
           row_src)
    B, H, T = k_cache.shape[:3]
    Dh = q.shape[-1]
    plan = split_plan(B, H, T, Dh, 8, cluster, indexed=True)
    out = torch.empty_like(q)
    fn, error_string = _function(KERNEL_INDEXED)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
                 v_scale.data_ptr(), row_src.data_ptr(), B, H, T, Dh, int(step),
                 math.sqrt(Dh), plan.cluster, plan.slice_rows, plan.tile_rows,
                 plan.stages, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{KERNEL_INDEXED} launch failed: "
                           f"{error_string(err).decode()} ({err})")
    launch_counts[KERNEL_INDEXED] += 1
    return out


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
    return _launch(KERNEL, q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step, src)


def fused_decode_self_attention_int4(q, k_t, v_t, k_cache, v_cache, k_scale,
                                     v_scale, step: int, src):
    """The same contract as :func:`fused_decode_self_attention_int8` over
    (B,H,T,Dh/2) packed-int4 caches: half the cache bytes of int8."""
    if q.device.type == "cpu":
        return _reference_int4(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale,
                               step, src)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL_INT4}: no kernel for device {q.device}")
    return _launch(KERNEL_INT4, q, k_t, v_t, k_cache, v_cache, k_scale, v_scale,
                   step, src)


def indexed_decode_self_attention_int8(q, k_t, v_t, k_cache, v_cache, k_scale,
                                       v_scale, row_src, step: int):
    """Decode attention of the lazy beam reorder over an int8 KV cache.

    q/k_t/v_t: (B,H,Dh) current-token tensors (float32 or bfloat16); caches
    (B,H,T,Dh) int8 with (B,H,T) f32 scales, never permuted and not written
    here; ``row_src`` (B,T) int32 maps (logical beam, position) to the
    physical slot that wrote the row; ``step`` the current position, a host
    int. Reads only rows t < step. Returns out (B,H,Dh); the caller writes
    the quantized new row at [b, :, step] and keeps ``row_src``.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises.
    """
    if q.device.type == "cpu":
        return _indexed_reference(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale,
                                  row_src, step)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL_INDEXED}: no kernel for device {q.device}")
    return _launch_indexed(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, row_src,
                           step)


def bound_bytes(B: int, H: int, T: int, Dh: int, *, n_src: int, elem: int,
                bits: int = 8) -> int:
    """Bytes the function must move, each input read once and each output
    written once: the cache rows and scales of the ``n_src`` distinct source
    beams, q/k_t/v_t (``elem`` bytes a value) and src in; the B new caches,
    scales and out back. ``bits`` 8 or 4: bits per cached value."""
    row = 2 * Dh * bits // 8 + 2 * 4           # k and v rows + 2 scales
    reads = n_src * H * T * row + 3 * B * H * Dh * elem + 4 * B
    writes = B * H * T * row + B * H * Dh * elem
    return reads + writes


def indexed_bound_bytes(row_src, step: int, H: int, Dh: int, *, elem: int) -> int:
    """Bytes the lazy-reorder function must move for this ``row_src`` (B,T)
    and ``step``: each distinct (slot, position) row that some beam reads at
    t < step (k and v rows and their two scales, over the H heads) once, the
    table's columns t < step, and q/k_t/v_t in; ``out`` back. No cache is
    written."""
    B = row_src.shape[0]
    hist = row_src[:, :step].long()
    pos = torch.arange(step, device=hist.device)[None, :]
    rows = int(torch.unique(hist * step + pos).numel()) if step else 0
    reads = rows * H * (2 * Dh + 2 * 4) + 4 * B * step + 3 * B * H * Dh * elem
    return reads + B * H * Dh * elem
