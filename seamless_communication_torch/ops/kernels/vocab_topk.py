"""Fused int8 tied-vocabulary projection + per-row top-k + logsumexp.

One beam-search step's vocabulary work: logits = (x @ Q_int8^T) * row_scale
over the (V, D) int8 tied table, their logsumexp, and the k largest logits
with their ids. The full-vocabulary step widens the whole table to fp32,
runs a log-softmax over (N, V) and sorts it; these functions read the int8
table once and return only

  top_vals (N, k) raw fp32 logits, top_idx (N, k) int32, logz (N,) fp32,

so ``top_vals - logz[:, None]`` are the exact log-probabilities of the top-k
tokens. Ties go to the lowest vocabulary id, as ``jax.lax.top_k`` does.

- ``int8_vocab_topk_v2``: CUDA kernel ``csrc/vocab_topk.cu``
  ``vocab_topk_v2``, which replaces the TPU kernel ``_kernel_v2`` of
  ``seamless_communication_tpu/ops/kernels/vocab_topk.py:170``. The kernel
  writes the (N, V) logits and, per 128-row tile, each x row's (max, Σexp);
  the wrapper combines the tiles' stats into the logsumexp, picks the k tiles
  with the largest maxima (every top-k element lies in one of them), and takes
  the top k of their k·128 columns.
- ``int8_vocab_topk``: CUDA kernel ``vocab_topk``, which replaces the TPU
  kernel ``_kernel`` of the same file (:45). The kernel also selects each
  tile's top k itself and writes no logits; the wrapper takes the top k of the
  tiles' candidates.

For tensors on the card a wrapper launches its kernel; for tensors on the CPU
it computes ``_reference``, the plain PyTorch version of the same function,
which is also what the kernels are held against on the card. Every selection
here is ``ops/topk.py top_k``, a stable sort, so ties rank as in JAX.
"""

from __future__ import annotations

import ctypes

import torch

from seamless_communication_torch.ops.kernels import launch_counts
from seamless_communication_torch.ops.topk import top_k

NEG = -1e30
TILE = 128                    # vocabulary rows per CUDA block (= block-max width)
KERNEL = "vocab_topk_v2"
KERNEL_V1 = "vocab_topk"
MAX_DIM = 10240               # x rows are staged in 40 KB of shared memory
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _reference(x, table, row_scale, k: int):
    """Plain PyTorch version: the full (N, V) fp32 logits, their logsumexp
    and a stable top-k. Returns (top_vals (N, k) f32, top_idx (N, k) i32,
    logz (N,) f32)."""
    logits = torch.matmul(x.float(), table.to(x.dtype).float().T)
    logits = logits * row_scale[None, :]
    logz = torch.logsumexp(logits, dim=-1)
    vals, idx = top_k(logits, k)
    return vals, idx.to(torch.int32), logz


def float_vocab_topk(x, table, k: int):
    """The same function over an unquantized (V, D) tied table (unit row
    scales), in plain PyTorch on every device, as the JAX package computes
    the candidate step of a model whose embedding is not int8."""
    ones = torch.ones((table.shape[0],), dtype=torch.float32, device=table.device)
    return _reference(x, table, ones, k)


def _logz(tile_max, tile_se):
    """Stable combine of per-tile (max, Σexp) of shape (G, N) -> (N,)."""
    m, se = tile_max.T, tile_se.T
    big = m.amax(dim=1)
    return big + torch.log(torch.sum(se * torch.exp(m - big[:, None]), dim=1))


def _combine_v2(logits, tile_max, tile_se, k: int):
    """The v2 kernel's outputs -> (top_vals, top_idx, logz). ``logits`` (N,
    G*128) with NEG in the padded tail; ``tile_max``/``tile_se`` (G, N). A
    tile is one 128-column block, so the tile maxima are the block maxima."""
    N = logits.shape[0]
    kb = min(k, tile_max.shape[0])
    _, blk = top_k(tile_max.T, kb)                       # (N, kb) block ids
    # ascending blocks: the final stable top-k then resolves equal values to
    # the lowest vocabulary id
    blk, _ = torch.sort(blk, dim=-1)
    cand_idx = (blk[..., None] * TILE + torch.arange(TILE, device=blk.device)
                ).reshape(N, kb * TILE)
    cand = torch.gather(logits, 1, cand_idx)
    top_vals, sel = top_k(cand, k)
    top_idx = torch.gather(cand_idx, 1, sel).to(torch.int32)
    return top_vals, top_idx, _logz(tile_max, tile_se)


def _combine_v1(vals, idx, tile_max, tile_se, k: int):
    """The v1 kernel's per-tile candidates (G, N, k) -> (top_vals, top_idx,
    logz): the top k of the G·k candidates, tile-major, so that equal values
    keep the lowest vocabulary id."""
    N = vals.shape[1]
    flat_vals = vals.transpose(0, 1).reshape(N, -1)
    flat_idx = idx.transpose(0, 1).reshape(N, -1)
    top_vals, sel = top_k(flat_vals, k)
    return top_vals, torch.gather(flat_idx, 1, sel), _logz(tile_max, tile_se)


def _tiles_reference(x, table, row_scale, k: int):
    """Plain PyTorch version of what the two kernels write: (logits (N,
    G*128) with NEG past V, per-tile top-k values and ids (G, N, k), tile
    max and Σexp (G, N)). Lets the CPU tests hold the wrappers' combine steps
    to ``_reference``."""
    V = table.shape[0]
    G = -(-V // TILE)
    logits = torch.matmul(x.float(), table.to(x.dtype).float().T) * row_scale[None, :]
    logits = torch.nn.functional.pad(logits, (0, G * TILE - V), value=NEG)
    tiles = logits.reshape(x.shape[0], G, TILE).transpose(0, 1)      # (G, N, 128)
    valid = (torch.arange(G * TILE, device=x.device) < V).reshape(G, 1, TILE)
    m = tiles.amax(dim=-1)
    se = torch.where(valid, torch.exp(tiles - m[..., None]), 0.0).sum(dim=-1)
    tv, ti = top_k(tiles, k)
    ti = ti + torch.arange(G, device=x.device)[:, None, None] * TILE
    return logits, tv, ti.to(torch.int32), m, se


_functions: dict = {}


def _function(kernel: str):
    """The C entry point of ``kernel`` in ``csrc/vocab_topk.cu``, built and
    loaded at first use, and the library's ``cuda_error_string``."""
    if kernel not in _functions:
        from seamless_communication_torch.ops.kernels import build

        lib = build.load("vocab_topk")
        fn = getattr(lib, kernel)
        # ctypes would pass a Python int as a 32-bit int and cut the pointers
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i, p, p, p, i, i, i, p, p, p] if kernel == KERNEL
                       else [i, p, p, p, i, i, i, i, p, p, p, p]) + [p]
        fn.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _functions[kernel] = (fn, lib.cuda_error_string)
    return _functions[kernel]


def _check(kernel, x, table, row_scale, k):
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{kernel}: x must be (N, D) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    (N, D), V = x.shape, table.shape[0]
    for name, t, shape, dtype in (("table", table, (V, D), torch.int8),
                                  ("row_scale", row_scale, (V,), torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
    for name, t in (("x", x), ("table", table), ("row_scale", row_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    if N == 0 or D % 16 or D > MAX_DIM:
        raise ValueError(f"{kernel}: need N >= 1 and D a multiple of 16 up to "
                         f"{MAX_DIM}, got N={N}, D={D}")
    if table.data_ptr() % 16:
        raise ValueError(f"{kernel}: the table must be 16-byte aligned")
    limit = TILE if kernel == KERNEL_V1 else V
    if not 1 <= k <= limit:
        raise ValueError(f"{kernel}: k={k} outside [1, {limit}]")


def _raise_on(kernel, err, error_string):
    if err:
        raise RuntimeError(f"{kernel} launch failed: {error_string(err).decode()} ({err})")


def _launch_v2(x, table, row_scale, k: int):
    _check(KERNEL, x, table, row_scale, k)
    (N, D), V = x.shape, table.shape[0]
    G = -(-V // TILE)
    logits = torch.empty((N, G * TILE), dtype=torch.float32, device=x.device)
    tile_max = torch.empty((G, N), dtype=torch.float32, device=x.device)
    tile_se = torch.empty_like(tile_max)
    fn, error_string = _function(KERNEL)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), table.data_ptr(),
                 row_scale.data_ptr(), N, D, V, logits.data_ptr(), tile_max.data_ptr(),
                 tile_se.data_ptr(), stream)
    _raise_on(KERNEL, err, error_string)
    launch_counts[KERNEL] += 1
    return logits, tile_max, tile_se


def _launch_v1(x, table, row_scale, k: int):
    _check(KERNEL_V1, x, table, row_scale, k)
    (N, D), V = x.shape, table.shape[0]
    G = -(-V // TILE)
    vals = torch.empty((G, N, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((G, N, k), dtype=torch.int32, device=x.device)
    tile_max = torch.empty((G, N), dtype=torch.float32, device=x.device)
    tile_se = torch.empty_like(tile_max)
    fn, error_string = _function(KERNEL_V1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), table.data_ptr(),
                 row_scale.data_ptr(), N, D, V, k, vals.data_ptr(), idx.data_ptr(),
                 tile_max.data_ptr(), tile_se.data_ptr(), stream)
    _raise_on(KERNEL_V1, err, error_string)
    launch_counts[KERNEL_V1] += 1
    return vals, idx, tile_max, tile_se


def int8_vocab_topk_v2(x, table_i8, row_scale, k: int):
    """x (N, D) float32 or bfloat16, table (V, D) int8, row_scale (V,) f32 ->
    (top_vals (N, k) raw fp32 logits, top_idx (N, k) int32, logz (N,) fp32).

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch a call), and anything the kernel does not take raises."""
    if x.device.type == "cpu":
        return _reference(x, table_i8, row_scale, k)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {x.device}")
    return _combine_v2(*_launch_v2(x, table_i8, row_scale, k), k)


def int8_vocab_topk(x, table_i8, row_scale, k: int):
    """The same contract as :func:`int8_vocab_topk_v2`, through the kernel
    that selects each tile's top k itself (k at most 128)."""
    if x.device.type == "cpu":
        return _reference(x, table_i8, row_scale, k)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL_V1}: no kernel for device {x.device}")
    return _combine_v1(*_launch_v1(x, table_i8, row_scale, k), k)


def bound_bytes(N: int, D: int, V: int, k: int, *, elem: int) -> int:
    """Bytes the function must move, each input read once and each output
    written once: the int8 table, its row scales and x in; the top-k values
    and ids and logz out. The same for both kernels: what one of them writes
    between its launch and the selection is not the function's."""
    return V * D + 4 * V + N * D * elem + N * k * 8 + 4 * N
