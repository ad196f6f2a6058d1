"""Flash attention with an additive bias and segment ids (kernel K6), the
full-sequence attention of the fused-attention option
(``ops/fused_attention.py``).

    out = softmax_fp32(qs @ k^T + ab + segmask) @ v

- ``qs`` (B, H, Tq, Dh) is q already scaled, in q's dtype; k, v (B, H, Tk,
  Dh) in the same dtype, float32 or bfloat16; Dh one of ``HEAD_DIMS`` (the
  backward's ``BWD_HEAD_DIMS`` lack 80, the XLSR encoder's, which no path
  trains).
- ``ab``: an optional (B, H, Tq, Tk) additive bias in q's dtype, its last
  dimension contiguous and its rows 16-byte aligned: a ``[..., :Tk]`` view
  of a buffer whose rows are padded to a multiple of 8 elements
  (``empty_bias``), since the bf16 kernels read it by TMA.
- ``segmask`` adds ``MASK_VALUE`` (-0.7 * float32 max, the library's
  ``DEFAULT_MASK_VALUE``) wherever ``q_seg[b, i] != kv_seg[b, j]``.
- The probabilities are cast to v's dtype before the value product, which
  accumulates in fp32; the output is in v's dtype.

CUDA kernel ``csrc/flash_attention.cu`` (bf16: wgmma tensor-core products
fed by TMA; fp32: register-blocked SIMT FMAs fed by TMA, 64- or 32-row
blocks as ``fp32_block_rows`` chooses, the key tiles of
``skippable_tiles_fwd`` left out under segment ids), which replaces the TPU
kernel the
JAX package reaches through ``seamless_communication_tpu/ops/
fused_attention.py:54`` (``try_flash``, JAX 0.9.0's Pallas flash attention).
For tensors on the card the wrapper launches it; for tensors on the CPU it
computes ``_reference``, the plain PyTorch version of the same function,
which is also what the kernel is held against on the card.

The gradient (``FlashAttention``, a ``torch.autograd.Function``, the
counterpart of the library's ``custom_vjp``): the forward also keeps each
row's softmax maximum ``m`` and denominator ``l`` (fp32, (B, H, Tq)), and
the backward is two kernels of ``csrc/flash_attention_bwd.cu``, K6b (dK,
dV; the library's ``_flash_attention_bwd_dkv``) and K6c (dQ and the bias
gradient dS; ``_flash_attention_bwd_dq``), held against ``_reference_bwd``.
K6c (both dtypes) and fp32 K6b leave out the (row tile, key tile) pairs of
``skippable_tiles``, whose products are exact zeros; fp32 K6b and K6c are
register-blocked SIMT kernels fed by TMA, with 64- or 32-key (-row) blocks
as ``fp32_block_rows`` chooses. The bias gradient comes back as a
``[..., :Tk]`` view of rows padded to 8 elements.
``flash_attention`` goes through the Function only where autograd needs it,
so an inference call computes no residuals.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from seamless_communication_torch.ops.kernels import launch_counts

KERNEL = "flash_attention"
KERNEL_DKV = "flash_attention_bwd_dkv"    # K6b
KERNEL_DQ = "flash_attention_bwd_dq"      # K6c
MASK_VALUE = float(np.float32(-0.7 * float(np.finfo(np.float32).max)))
HEAD_DIMS = (16, 32, 64, 80, 128)        # K6 (80: the XLSR2-1B encoder's)
BWD_HEAD_DIMS = (16, 32, 64, 128)        # K6b and K6c
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,       # fp32 outside the tensor cores
              torch.bfloat16: 989e12}     # bf16 dense tensor cores


def _logits(qs: torch.Tensor, k: torch.Tensor, ab: Optional[torch.Tensor],
            q_seg: Optional[torch.Tensor], kv_seg: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """fp32 ``qs @ k^T + ab + segmask``, (B, H, Tq, Tk)."""
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if ab is not None:
        logits = logits + ab.float()
    if q_seg is not None:
        same = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        logits = logits + torch.where(same, 0.0, MASK_VALUE)
    return logits


def _reference_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ab: Optional[torch.Tensor] = None,
                   q_seg: Optional[torch.Tensor] = None,
                   kv_seg: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, the logits materialized, the same contract:
    ``out`` and the residuals of the backward, each row's maximum logit
    ``m`` and ``l = sum exp(logits - m)``, fp32 (B, H, Tq)."""
    logits = _logits(qs, k, ab, q_seg, kv_seg)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
    m = logits.amax(dim=-1)
    l = torch.exp(logits - m[..., None]).sum(dim=-1)
    return out, m, l


def _reference(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               ab: Optional[torch.Tensor] = None, q_seg: Optional[torch.Tensor] = None,
               kv_seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version's ``out`` alone."""
    return _reference_fwd(qs, k, v, ab, q_seg, kv_seg)[0]


def _reference_bwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ab: Optional[torch.Tensor], q_seg: Optional[torch.Tensor],
                   kv_seg: Optional[torch.Tensor], o: torch.Tensor, m: torch.Tensor,
                   l: torch.Tensor, do: torch.Tensor, part: str = "all"
                   ) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                              Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain PyTorch version of the backward, step by step as the library's
    kernels compute it (``_flash_attention_bwd`` :254-316, the dkv body
    :796-940 and the dq body :1146-1286), every product in fp32:

    di = sum_d o*dO; p = exp(s - m) * (1 / l) with s the forward's logits
    (0 where m is -inf, a row of -inf logits); dV = p^T dO with p cast to
    dO's dtype; dP = dO v^T; dS = (dP - di) * p; dK = dS^T qs with dS cast
    to dO's dtype; dQ = dS k with dS cast to k's dtype; dab = dS in ab's
    dtype. Returns (dq, dk, dv, dab), dab None without ``ab``.

    ``part``: "all", or the function of one kernel alone, the others' results
    None: "dkv" (K6b: dk, dv) or "dq" (K6c: dq, dab)."""
    f32 = torch.float32
    s = _logits(qs, k, ab, q_seg, kv_seg)
    live = m != float("-inf")
    p = torch.exp(s - torch.where(live, m, 0.0)[..., None]) * (1.0 / l)[..., None]
    p = torch.where(live[..., None], p, 0.0)
    di = (o.to(f32) * do.to(f32)).sum(dim=-1)
    dp = torch.matmul(do.to(f32), v.to(f32).transpose(-1, -2))
    ds = (dp - di[..., None]) * p
    dq = dk = dv = dab = None
    if part in ("all", "dkv"):
        dv = torch.matmul(p.to(do.dtype).to(f32).transpose(-1, -2), do.to(f32)).to(v.dtype)
        dk = torch.matmul(ds.to(do.dtype).to(f32).transpose(-1, -2), qs.to(f32)).to(k.dtype)
    if part in ("all", "dq"):
        dq = torch.matmul(ds.to(k.dtype).to(f32), k.to(f32)).to(qs.dtype)
        dab = None if ab is None else ds.to(ab.dtype)
    return dq, dk, dv, dab


_functions: dict = {}

# ctypes would pass a Python int as a 32-bit int and cut the pointers
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C entry points: (library, argument types)
_ENTRY = {
    KERNEL: ("flash_attention",
             [_I] + [_P] * 6 + [_LL] * 10 + [_I] * 6 + [ctypes.c_float] + [_P] * 4),
    KERNEL_DKV: ("flash_attention_bwd",
                 [_I] + [_P] * 10 + [_LL] * 10 + [_I] * 5 + [ctypes.c_float, _I] + [_P] * 3),
    KERNEL_DQ: ("flash_attention_bwd",
                [_I] + [_P] * 10 + [_LL] * 10 + [_I] * 5 + [ctypes.c_float, _I] + [_P] * 2
                + [_LL, _P]),
}


def _function(name: str = KERNEL):
    """The C entry point ``name``, built and loaded at first use, and its
    library's ``cuda_error_string``."""
    if name not in _functions:
        from seamless_communication_torch.ops.kernels import build

        source, argtypes = _ENTRY[name]
        lib = build.load(source)
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
        lib.cuda_error_string.argtypes = [_I]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _functions[name] = (fn, lib.cuda_error_string)
    return _functions[name]


def empty_bias(B: int, H: int, Tq: int, Tk: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    """An uninitialised (B, H, Tq, Tk) bias as the kernels take it: the
    ``[..., :Tk]`` view of a buffer whose rows are padded to a multiple of 8
    elements, so that each row starts 16-byte aligned (TMA's rule for the
    bf16 kernels' tile loads). Fill it in place: no second copy is made."""
    padded = -(-Tk // 8) * 8
    return torch.empty((B, H, Tq, padded), dtype=dtype, device=device)[..., :Tk]


class _PaddedBias(torch.autograd.Function):
    """``ab`` in ``dtype`` in the rows of ``empty_bias``, one copy. The
    gradient goes back as it comes, cast to ``ab``'s dtype: no zero-filled
    padded buffer and no slice of it, as an in-place copy into the buffer
    would record."""

    @staticmethod
    def forward(ctx, ab: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ctx.in_dtype = ab.dtype
        return empty_bias(*ab.shape, dtype, ab.device).copy_(ab)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.to(ctx.in_dtype), None


def padded_bias(ab: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A (B, H, Tq, Tk) bias (a broadcast view will do) materialised once in
    ``dtype`` into the rows of ``empty_bias``, differentiable."""
    return _PaddedBias.apply(ab, dtype)


def _row_stride(ab: Optional[torch.Tensor]) -> int:
    return 0 if ab is None else ab.stride(2)


def _check(qs, k, v, ab, q_seg, kv_seg, head_dims: tuple = HEAD_DIMS,
           name: str = KERNEL) -> None:
    """Raise on what the kernel ``name`` (its head dims ``head_dims``)
    does not take."""
    if qs.dtype not in _DTYPE_CODES:
        raise TypeError(f"{KERNEL}: dtype {qs.dtype} is not float32 or bfloat16")
    if qs.dim() != 4:
        raise ValueError(f"{KERNEL}: q is {tuple(qs.shape)}, expected (B, H, Tq, Dh)")
    B, H, Tq, Dh = qs.shape
    Tk = k.shape[2] if k.dim() == 4 else -1
    if Dh not in head_dims:
        raise ValueError(f"{name}: head dim {Dh} not in {head_dims}")
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
    for name, x in (("q_seg", q_seg), ("kv_seg", kv_seg)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} is not contiguous")
    elem = torch.finfo(qs.dtype).bits // 8
    # TMA: 16-byte aligned bases and strides (a dimension of extent 1 has its
    # coordinate at 0, its stride unread)
    for name, x in (("q", qs), ("k", k), ("v", v)):
        if x.data_ptr() % 16 or any(
                s * elem % 16 for n, s in zip(x.shape[:3], x.stride()[:3]) if n > 1):
            raise ValueError(f"{KERNEL}: {name} has strides {x.stride()}: the kernels "
                             "take 16-byte multiples and 16-byte aligned bases")
    if ab is not None:
        rs = ab.stride(2)
        if (ab.stride() != (H * Tq * rs, Tq * rs, rs, 1) or rs * elem % 16
                or ab.data_ptr() % 16):
            raise ValueError(f"{KERNEL}: ab has strides {ab.stride()}: its rows must be "
                             "16-byte aligned, as in a [..., :Tk] view of a buffer "
                             "whose rows are padded to 8 elements (empty_bias)")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _raise_on(err: int, name: str, error_string) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: {error_string(err).decode()} ({err})")


NUM_SMS = 132                  # an H100 SXM's streaming multiprocessors


def fp32_block_rows(B: int, H: int, T: int) -> int:
    """Rows of a block of the fp32 kernels: query rows of K6 and K6c, keys
    of K6b, of T: 64, or 32 where 64-row blocks (one a SM: the ring takes
    most of its shared memory) would fill at most half of the card's SMs
    (the 4 s encoder and the re-decode)."""
    return 32 if B * H * -(-T // 64) * 2 <= NUM_SMS else 64


SMEM_PER_BLOCK = 232448        # an H100's shared memory for one block (227 KB)
_SMEM_BUDGET = 227 * 1024 - 2048   # the fp32 kernels' dynamic share of it


def fp32_bwd_shape(part: str, Dh: int, block: int) -> tuple[int, int]:
    """(dynamic shared memory bytes, ring stages) of fp32 K6b (``part="dkv"``,
    ``block`` keys a block) or K6c (``"dq"``, ``block`` query rows), as
    ``csrc/flash_attention_bwd.cu`` (``f32::DkvShape``, ``f32::DqShape``)
    computes them: the fixed tiles, the p / dS tiles and as many stages of
    the ring (at most 4) as the rest of the budget holds. The library's
    ``flash_attention_bwd_f32_shape`` reports the kernels' own, which
    ``chip_smoke.py`` holds this to."""
    if part == "dkv":
        BQ = 64 if Dh <= 64 else 32                 # query rows of a tile
        gk = block // 2
        fixed = 2 * block * Dh * 4                  # K, V
        p_bytes = 2 * 3 * BQ * (gk + gk // 4) * 4    # each group's p, p, dS
        stage = 2 * BQ * Dh * 4 + BQ * block * 4 + 1024
    else:
        BK = 64 if Dh <= 64 else 32                 # keys of a tile
        fixed = 2 * block * Dh * 4                  # Q, dO
        p_bytes = 2 * 2 * (block // 2) * (BK + 8) * 4   # each group's p / dS, two buffers
        stage = 2 * BK * Dh * 4 + block * BK * 4 + 1024
    stages = min(4, (_SMEM_BUDGET - (1024 + fixed + p_bytes + 8 * 9)) // stage)
    return 1024 + fixed + stages * stage + p_bytes + 8 * (2 * stages + 1), stages


def _launch(qs, k, v, ab, q_seg, kv_seg, residuals: bool = False,
            block_rows: Optional[int] = None
            ) -> tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K6 -> (out, m, l); m and l are None unless ``residuals``.
    ``block_rows`` forces the fp32 kernel's block rows (32 or 64)."""
    _check(qs, k, v, ab, q_seg, kv_seg)
    B, H, Tq, Dh = qs.shape
    Tk = k.shape[2]
    out = torch.empty((B, H, Tq, Dh), dtype=qs.dtype, device=qs.device)
    m = l = None
    if residuals:
        m = torch.empty((B, H, Tq), dtype=torch.float32, device=qs.device)
        l = torch.empty_like(m)
    fn, error_string = _function(KERNEL)
    strides = [s for x in (qs, k, v) for s in x.stride()[:3]]
    rows = 64
    if qs.dtype == torch.float32:
        rows = block_rows or fp32_block_rows(B, H, Tq)
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        err = fn(_DTYPE_CODES[qs.dtype], qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                 _ptr(ab), _ptr(q_seg), _ptr(kv_seg), *strides, _row_stride(ab), B, H,
                 Tq, Tk, Dh, rows, MASK_VALUE, out.data_ptr(), _ptr(m), _ptr(l), stream)
    _raise_on(err, KERNEL, error_string)
    launch_counts[KERNEL] += 1
    return out, m, l


class _BwdArgs(NamedTuple):
    """The C arguments the two backward kernels share, and the tensors they
    point into (kept alive with them)."""
    common: tuple
    keep: tuple
    shapes: tuple         # (B, H, Tq, Tk, Dh)


def _bwd_args(qs, k, v, ab, q_seg, kv_seg, o, m, l, do) -> _BwdArgs:
    _check(qs, k, v, ab, q_seg, kv_seg, BWD_HEAD_DIMS, KERNEL_DKV)
    B, H, Tq, Dh = qs.shape
    Tk = k.shape[2]
    for name, x, dtype in (("o", o, qs.dtype), ("do", do, qs.dtype),
                           ("m", m, torch.float32), ("l", l, torch.float32)):
        want = (B, H, Tq, Dh) if name in ("o", "do") else (B, H, Tq)
        if tuple(x.shape) != want or x.dtype != dtype or x.device != qs.device:
            raise ValueError(f"{KERNEL_DKV}: {name} is {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}, expected {want} {dtype} on {qs.device}")
    do, m, l = do.contiguous(), m.contiguous(), l.contiguous()
    # the one reduction the library computes outside its kernels (:273-275)
    di = (o.float() * do.float()).sum(dim=-1).contiguous()
    strides = [s for x in (qs, k, v) for s in x.stride()[:3]]
    common = (_DTYPE_CODES[qs.dtype], qs.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ab),
              _ptr(q_seg), _ptr(kv_seg), do.data_ptr(), m.data_ptr(), l.data_ptr(),
              di.data_ptr(), *strides, _row_stride(ab), B, H, Tq, Tk, Dh, MASK_VALUE)
    return _BwdArgs(common, (qs, k, v, ab, q_seg, kv_seg, do, m, l, di),
                    (B, H, Tq, Tk, Dh))


def _launch_one(name: str, args: _BwdArgs, out0: torch.Tensor,
                out1: Optional[torch.Tensor], block: Optional[int] = None) -> None:
    """One backward kernel: K6b (``KERNEL_DKV``) into dk, dv or K6c
    (``KERNEL_DQ``) into dq and dab (None: no bias gradient; else rows
    16-byte aligned, as ``empty_bias`` makes them). ``block`` forces the
    fp32 kernel's keys (K6b) or query rows (K6c) of a block, 64 or 32;
    by default ``fp32_block_rows`` chooses."""
    fn, error_string = _function(name)
    device = out0.device
    B, H, Tq, Tk, _ = args.shapes
    if block is None:
        block = fp32_block_rows(B, H, Tk if name == KERNEL_DKV else Tq)
    outs = (block, out0.data_ptr(), _ptr(out1))
    if name == KERNEL_DQ:
        if out1 is not None and (out1.stride(-1) != 1 or out1.stride(2) * out1.element_size() % 16
                                 or out1.data_ptr() % 16):
            raise ValueError(f"{name}: dab has strides {out1.stride()}: its rows must be "
                             "16-byte aligned (empty_bias)")
        outs += (_row_stride(out1),)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(fn(*args.common, *outs, stream), name, error_string)
    launch_counts[name] += 1


def _launch_bwd(qs, k, v, ab, q_seg, kv_seg, o, m, l, do, need_dab: bool):
    """K6b then K6c -> (dq, dk, dv, dab); dab None unless ``need_dab``."""
    args = _bwd_args(qs, k, v, ab, q_seg, kv_seg, o, m, l, do)
    B, H, Tq, Tk, Dh = args.shapes
    dq = torch.empty((B, H, Tq, Dh), dtype=qs.dtype, device=qs.device)
    dk = torch.empty((B, H, Tk, Dh), dtype=qs.dtype, device=qs.device)
    dv = torch.empty_like(dk)
    # dab in rows padded to 8 elements (16-byte aligned), handed on as the
    # [..., :Tk] view
    dab = (empty_bias(B, H, Tq, Tk, qs.dtype, qs.device)
           if need_dab and ab is not None else None)
    _launch_one(KERNEL_DKV, args, dk, dv)
    _launch_one(KERNEL_DQ, args, dq, dab)
    return dq, dk, dv, dab


def _forward(qs, k, v, ab, q_seg, kv_seg, residuals: bool):
    """(out, m, l) on the tensors' device: the plain version on the CPU, K6
    on the card. m and l are None unless ``residuals``."""
    if qs.device.type == "cpu":
        out, m, l = _reference_fwd(qs, k, v, ab, q_seg, kv_seg)
        return (out, m, l) if residuals else (out, None, None)
    if qs.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {qs.device}")
    return _launch(qs, k, v, ab, q_seg, kv_seg, residuals)


def flash_attention_bwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        ab: Optional[torch.Tensor], q_seg: Optional[torch.Tensor],
                        kv_seg: Optional[torch.Tensor], o: torch.Tensor, m: torch.Tensor,
                        l: torch.Tensor, do: torch.Tensor, *, need_dab: bool = True):
    """The backward of ``flash_attention`` from its residuals ``o``, ``m``,
    ``l`` and the output gradient ``do`` -> (dq, dk, dv, dab) in q's dtype
    (dq with respect to ``qs``; dab None without ``ab`` or unless
    ``need_dab``). CPU tensors take ``_reference_bwd``; CUDA tensors launch
    K6b and K6c, and anything they do not take raises."""
    if qs.device.type == "cpu":
        dq, dk, dv, dab = _reference_bwd(qs, k, v, ab, q_seg, kv_seg, o, m, l, do)
        return dq, dk, dv, dab if need_dab else None
    if qs.device.type != "cuda":
        raise ValueError(f"{KERNEL_DKV}: no kernel for device {qs.device}")
    return _launch_bwd(qs, k, v, ab, q_seg, kv_seg, o, m, l, do, need_dab)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient (the library's ``custom_vjp``):
    K6 forward and K6b + K6c backward on the card, the plain versions on the
    CPU. The forward keeps ``qs, k, v, ab, q_seg, kv_seg, out, m, l`` for the
    backward. Gradients flow to qs, k, v and, where it requires one, ab;
    never to the segment ids."""

    @staticmethod
    def forward(ctx, qs, k, v, ab, q_seg, kv_seg):
        out, m, l = _forward(qs, k, v, ab, q_seg, kv_seg, residuals=True)
        ctx.save_for_backward(qs, k, v, ab, q_seg, kv_seg, out, m, l)
        return out

    @staticmethod
    def backward(ctx, do):
        qs, k, v, ab, q_seg, kv_seg, out, m, l = ctx.saved_tensors
        need_dab = ab is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dab = flash_attention_bwd(qs, k, v, ab, q_seg, kv_seg, out, m, l,
                                              do, need_dab=need_dab)
        return dq, dk, dv, dab, None, None


def flash_attention(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ab: Optional[torch.Tensor] = None,
                    q_seg: Optional[torch.Tensor] = None,
                    kv_seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax_fp32(qs @ k^T + ab + segmask) @ v`` -> (B, H, Tq, Dh) in v's
    dtype (see the module). q, k and v may be strided views whose last
    dimension is contiguous (heads split from (B, T, D) activations); ``ab``,
    ``q_seg`` (B, Tq) and ``kv_seg`` (B, Tk) int32 are contiguous.

    Where autograd records (grad mode on and an input that requires grad)
    the call goes through ``FlashAttention``, which keeps the residuals of
    the backward; otherwise it computes ``out`` alone (inference, and
    ``torch.inference_mode``). CPU tensors take the plain versions; CUDA
    tensors launch the kernels, and anything the kernels do not take
    raises."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in (qs, k, v, ab)):
        return FlashAttention.apply(qs, k, v, ab, q_seg, kv_seg)
    return _forward(qs, k, v, ab, q_seg, kv_seg, residuals=False)[0]


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


SKIP_ROWS = SKIP_KEYS = 64     # the row and key tiles of the rules (K6b, K6c, fp32 K6)
SKIP_MAX_KEY_TILES = 512       # key tiles past these are always taken


def skippable_tiles(m: torch.Tensor, q_seg: Optional[torch.Tensor],
                    kv_seg: Optional[torch.Tensor], Tk: int) -> torch.Tensor:
    """The (row tile, key tile) pairs that K6c (both dtypes) and fp32 K6b
    leave out, a bool tensor (B, H, ceil(Tq / 64), ceil(Tk / 64)); their
    kernels' predicate is this one (a block of 32 rows or keys takes the
    decision of the 64 x 64 pair that holds it). A pair is skipped when

    - the tile's keys (those below Tk) all have segment ids outside [min,
      max] of the row tile's rows' (those below Tq), so every one is masked
      for every row; and
    - every row of the tile has m > ``MASK_VALUE`` / 2, an unmasked key
      somewhere (K6's residual ``m`` (B, H, Tq)).

    Then each logit of the pair is below -0.35 * float32 max after the
    subtraction of m, so p = exp(.) is exactly 0 and so are dS, dab and the
    pair's share of dQ: leaving it out changes no bit. A row whose keys are
    all masked has m at the mask level and a p that is not 0 (the library
    averages every key), so its tiles are all taken. Nor does leaving it
    out change a bit of K6b's sums over the rows or K6c's over the keys:
    its terms are exact zeros. Without segment ids nothing is skipped; key
    tiles from ``SKIP_MAX_KEY_TILES`` on are always taken."""
    B, H, Tq = m.shape
    nr, nk = -(-Tq // SKIP_ROWS), -(-Tk // SKIP_KEYS)
    if q_seg is None:
        return torch.zeros((B, H, nr, nk), dtype=torch.bool)
    q_seg, kv_seg, m = q_seg.cpu(), kv_seg.cpu(), m.cpu()
    big = torch.iinfo(torch.int32).max
    rows = torch.nn.functional.pad(q_seg.long(), (0, nr * SKIP_ROWS - Tq))
    valid = (torch.arange(nr * SKIP_ROWS) < Tq).view(1, nr, SKIP_ROWS)
    rows = rows.view(B, nr, SKIP_ROWS)
    rmin = torch.where(valid, rows, big).amin(dim=-1)                    # (B, nr)
    rmax = torch.where(valid, rows, -big - 1).amax(dim=-1)
    keys = torch.nn.functional.pad(kv_seg.long(), (0, nk * SKIP_KEYS - Tk))
    kvalid = torch.arange(nk * SKIP_KEYS) < Tk
    inside = (kvalid & (keys[:, None, :] >= rmin[..., None])
              & (keys[:, None, :] <= rmax[..., None]))                   # (B, nr, nk*64)
    live = inside.view(B, nr, nk, SKIP_KEYS).any(dim=-1)
    at_mask = ~(m > MASK_VALUE / 2)                                        # (B, H, Tq)
    at_mask = torch.nn.functional.pad(at_mask, (0, nr * SKIP_ROWS - Tq))
    at_mask = at_mask.view(B, H, nr, SKIP_ROWS).any(dim=-1)               # (B, H, nr)
    skip = ~live[:, None] & ~at_mask[..., None]
    skip[..., SKIP_MAX_KEY_TILES:] = False
    return skip


def skippable_tiles_fwd(q_seg: Optional[torch.Tensor], kv_seg: Optional[torch.Tensor],
                        Tq: int, Tk: int, ab: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The (row tile, key tile) pairs of 64 x 64 that the fp32 forward K6
    leaves out, a bool tensor (B, ceil(Tq / 64), ceil(Tk / 64)); its
    kernel's predicate is this one. Unlike ``skippable_tiles`` it has no
    residual ``m`` to consult. A pair is skipped when

    - the tile's keys (those below Tk) all have segment ids outside [min,
      max] of the row tile's rows' (those below Tq), so every one is masked
      for every row; and
    - every row of the row tile has its own segment among the keys below
      Tk, so it ends with an unmasked maximum.

    Then a skipped pair's logits are below -0.35 * float32 max after the
    subtraction of that maximum: their p are exactly 0, or, if the pair came
    before the maximum, its terms are scaled by exp(mask - m) = 0. Leaving
    it out changes no bit of out, m or l. A row whose keys are all masked
    (the softmax's uniform average) makes its row tile take every key tile.
    Nothing is skipped without segment ids or with ``ab`` (whose -inf or
    -1e9 entries could leave a row without an unmasked maximum); key tiles
    from ``SKIP_MAX_KEY_TILES`` on are always taken."""
    nr, nk = -(-Tq // SKIP_ROWS), -(-Tk // SKIP_KEYS)
    if q_seg is None or ab is not None:
        B = q_seg.shape[0] if q_seg is not None else ab.shape[0] if ab is not None else 1
        return torch.zeros((B, nr, nk), dtype=torch.bool)
    q_seg, kv_seg = q_seg.cpu().long(), kv_seg.cpu().long()
    B = q_seg.shape[0]
    big = torch.iinfo(torch.int32).max
    valid = (torch.arange(nr * SKIP_ROWS) < Tq).view(1, nr, SKIP_ROWS)
    rows = torch.nn.functional.pad(q_seg, (0, nr * SKIP_ROWS - Tq)).view(B, nr, SKIP_ROWS)
    rmin = torch.where(valid, rows, big).amin(dim=-1)                    # (B, nr)
    rmax = torch.where(valid, rows, -big - 1).amax(dim=-1)
    keys = torch.nn.functional.pad(kv_seg, (0, nk * SKIP_KEYS - Tk))
    kvalid = torch.arange(nk * SKIP_KEYS) < Tk
    inside = (kvalid & (keys[:, None, :] >= rmin[..., None])
              & (keys[:, None, :] <= rmax[..., None]))                   # (B, nr, nk*64)
    live = inside.view(B, nr, nk, SKIP_KEYS).any(dim=-1)
    matched = (q_seg[:, :, None] == kv_seg[:, None, :]).any(dim=-1)      # (B, Tq)
    matched = torch.nn.functional.pad(matched, (0, nr * SKIP_ROWS - Tq), value=True)
    all_matched = matched.view(B, nr, SKIP_ROWS).all(dim=-1)             # (B, nr)
    skip = ~live & all_matched[..., None]
    skip[..., SKIP_MAX_KEY_TILES:] = False
    return skip


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


def bound_bwd(B: int, H: int, Tq: int, Tk: int, Dh: int, dtype: torch.dtype,
              has_ab: bool, has_seg: bool, pairs: Optional[int] = None,
              has_dab: Optional[bool] = None, part: str = "all") -> tuple[float, str]:
    """The least time (ms) the card could take for the backward, and what
    bounds it: the larger of the bytes it must move over the memory rate and
    its flops over the peak rate for the dtype, counting ``pairs`` logits
    (by default all B*H*Tq*Tk). ``has_dab`` (default ``has_ab``): the bias
    needs a gradient.

    ``part="all"``, the backward as a whole: 10*Dh flops a pair (the
    recomputed logits, dV, dP, dK and dQ); q, k, v, o, dO, m, l, ``ab`` and
    the segment ids read once, dq, dk, dv and dab written once.
    ``part="dkv"`` (K6b's function alone): 8*Dh (logits, dP, dV, dK); q, k,
    v, dO, m, l, di, ``ab`` and the segment ids read, dk and dv written.
    ``part="dq"`` (K6c's): 6*Dh (logits, dP, dQ); the same reads, dq and
    dab written."""
    elem = torch.finfo(dtype).bits // 8
    has_dab = has_ab if has_dab is None else has_dab
    q_rows, k_rows, rows = B * H * Tq * Dh, B * H * Tk * Dh, B * H * Tq
    ab_bytes = B * H * Tq * Tk * elem
    flops_per_dh = {"all": 10, "dkv": 8, "dq": 6}[part]
    if part == "all":
        nbytes = (4 * q_rows + 4 * k_rows) * elem + 2 * 4 * rows
        nbytes += ab_bytes * (int(has_ab) + int(has_dab))
    else:
        nbytes = (2 * q_rows + 2 * k_rows) * elem + 3 * 4 * rows + ab_bytes * int(has_ab)
        nbytes += (2 * k_rows * elem if part == "dkv"
                   else q_rows * elem + ab_bytes * int(has_dab))
    if has_seg:
        nbytes += 4 * B * (Tq + Tk)
    pairs = B * H * Tq * Tk if pairs is None else pairs
    bytes_s = nbytes / HBM_BYTES_PER_S
    flops_s = flops_per_dh * pairs * Dh / PEAK_FLOPS[dtype]
    return max(bytes_s, flops_s) * 1e3, "bytes" if bytes_s >= flops_s else "operations"
