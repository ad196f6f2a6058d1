"""The least bytes and operations of the kernels' functions, frozen copies
of the program's ``bound_bytes`` (``ops/kernels/decode_attention.py``) and
``bound`` (``ops/kernels/flash_attention.py``), the latter with the fp32
peak of ``peaks.py``."""

from __future__ import annotations

from counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def k1_bytes(B: int, H: int, T: int, Dh: int, *, n_src: int, elem: int,
             bits: int = 8) -> int:
    """K1 (int8-KV decode attention with the beam gather): each input read
    once and each output written once: the cache rows and scales of the
    ``n_src`` distinct source beams, q/k_t/v_t (``elem`` bytes a value) and
    src in; the B new caches, scales and out back."""
    row = 2 * Dh * bits // 8 + 2 * 4
    reads = n_src * H * T * row + 3 * B * H * Dh * elem + 4 * B
    writes = B * H * T * row + B * H * Dh * elem
    return reads + writes


def k1_bound_s(B: int, H: int, T: int, Dh: int, *, n_src: int, elem: int) -> float:
    """K1's least time: the larger of its bytes over the memory rate and its
    operations (4 * Dh a cached row: the logit and the weighted value) over
    the fp32 peak."""
    ops = 4 * B * H * T * Dh
    return max(k1_bytes(B, H, T, Dh, n_src=n_src, elem=elem) / HBM_BYTES_PER_S,
               ops / PEAK_FLOPS["float32"])


def k6_bound_s(B: int, H: int, Tq: int, Tk: int, Dh: int, dtype: str, *,
               has_ab: bool, has_seg: bool, pairs: int) -> float:
    """K6 (flash attention forward): the larger of its bytes (q, k, v, the
    segment ids and ``ab`` read once, ``out`` written once) over the memory
    rate and 4 * Dh operations an unmasked pair over the dtype's peak."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * B * H * Tq * Dh + 2 * B * H * Tk * Dh) * elem
    if has_ab:
        nbytes += B * H * Tq * Tk * elem
    if has_seg:
        nbytes += 4 * B * (Tq + Tk)
    return max(nbytes / HBM_BYTES_PER_S, 4 * pairs * Dh / PEAK_FLOPS[dtype])
