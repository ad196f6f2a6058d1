"""Fused int8 tied-vocabulary projection + per-row top-k + logsumexp.

One beam-search step's vocabulary work: logits = (x @ Q_int8^T) * row_scale
over the (V, D) int8 tied table, their logsumexp, and the k largest logits
with their ids. The full-vocabulary step widens the whole table to fp32,
runs a log-softmax over (N, V) and sorts it; these functions read the int8
table once and return only

  top_vals (N, k) raw fp32 logits, top_idx (N, k) int32, logz (N,) fp32,

so ``top_vals - logz[:, None]`` are the exact log-probabilities of the top-k
tokens. Ties go to the lowest vocabulary id, as ``jax.lax.top_k`` does.

- ``int8_vocab_topk_v2`` (K3b): CUDA kernels ``csrc/vocab_topk.cu``
  ``vocab_topk_v2`` and ``vocab_topk_v2_select``, which replace the TPU
  kernel ``_kernel_v2`` of ``seamless_communication_tpu/ops/kernels/
  vocab_topk.py:170`` and the selection XLA runs after it. Two launches a
  call: the first streams the table, a block a range of 128-row tiles
  (``stream_bounds``), and writes each block's k best (value, id) and its
  (max, Σexp) per x row; the second merges them into the top k and the
  logsumexp. k is at most ``MAX_K``.
- ``int8_vocab_topk`` (K3a): CUDA kernels ``vocab_topk`` and
  ``vocab_topk_v2_select``, which replace the TPU kernel ``_kernel`` of the
  same file (:45) and the selection XLA runs after it. Two launches a call:
  K3b's stream, whose blocks take runs of whole K3a tiles of ``tile`` rows
  and write each tile's k best (value, id) and (max, Σexp) per x row
  (``tile_bounds``), then K3b's selection over those lists. The default
  tile fills the stream's grid (``fill_tile``).

For tensors on the card a wrapper launches its kernels; for tensors on the
CPU it computes ``_reference``, the plain PyTorch version of the same
function, which is also what the kernels are held against on the card.
``_tiles_reference`` is the plain version of what K3a's and K3b's first
launch write, ``_select_reference`` of their second. Every selection here
is ``ops/topk.py top_k``, a stable sort, so ties rank as in JAX.
"""

from __future__ import annotations

import ctypes

import torch

from seamless_communication_torch.ops.kernels import launch_counts
from seamless_communication_torch.ops.topk import top_k

NEG = -1e30                   # the TPU kernel's logit of a tile row past V
NO_ID = 2 ** 31 - 1           # the id of an empty entry of a list
TILE = 128                    # vocabulary rows of a stream tile
KERNEL = "vocab_topk_v2"      # K3b, both launches
KERNEL_V1 = "vocab_topk"      # K3a, both launches
MAX_DIM = 16384               # x rows are staged in 64 KB of shared memory
MAX_K = 128                   # the largest k the kernels take
MAX_LISTS = 2048              # the most lists the selection merges
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


def stream_bounds(V: int, G: int) -> list:
    """The table rows of K3b's G stream blocks: block g takes the 128-row
    tiles [g T / G, (g + 1) T / G) of the T = ceil(V / 128), so its rows are
    [bounds[g], bounds[g + 1])."""
    T = -(-V // TILE)
    return [min(g * T // G * TILE, V) for g in range(G + 1)]


def tile_bounds(V: int, tile: int) -> list:
    """The table rows of K3a's tiles: [0, tile, 2 tile, ..., V], the last
    tile cut at V; tile g's lists are rows [bounds[g], bounds[g + 1])."""
    return list(range(0, V, tile)) + [V]


def fill_tile(V: int, G: int) -> int:
    """K3a's default tile over a stream grid of G blocks: the least multiple
    of 128 of which at most G tiles cover V, so that each block takes one
    tile, as many rows as a K3b block's range (a K3a tile's lists restart
    empty, and a block of several tiles pays for refilling them each
    time)."""
    tiles = -(-V // TILE)
    return TILE * -(-tiles // G)


def _tiles_reference(x, table, row_scale, k: int, bounds=None):
    """Plain PyTorch version of what a first launch writes: for each range of
    table rows [bounds[g], bounds[g + 1]) (default: 128-row tiles, the last
    running past V as the TPU kernel's do, its rows past V at NEG), each x
    row's k best (value, id) in (value descending, id ascending) order,
    padded with (-inf, ``NO_ID``) where the range holds fewer than k rows, and the
    range's max and Σexp (over rows below V). Returns (vals (G, N, k) f32,
    ids (G, N, k) i32, max (G, N) f32, Σexp (G, N) f32)."""
    V = table.shape[0]
    if bounds is None:
        bounds = list(range(0, -(-V // TILE) * TILE + 1, TILE))
    logits = torch.matmul(x.float(), table.to(x.dtype).float().T) * row_scale[None, :]
    vals, ids, maxes, sums = [], [], [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = logits[:, lo:min(hi, V)]
        if hi > V:
            part = torch.nn.functional.pad(part, (0, hi - V), value=NEG)
        m = part.amax(dim=-1)
        sums.append(torch.exp(logits[:, lo:min(hi, V)] - m[:, None]).sum(dim=-1))
        maxes.append(m)
        kk = min(k, hi - lo)
        tv, ti = top_k(part, kk)
        tv = torch.nn.functional.pad(tv, (0, k - kk), value=float("-inf"))
        ti = torch.nn.functional.pad(ti + lo, (0, k - kk), value=NO_ID)
        vals.append(tv)
        ids.append(ti.to(torch.int32))
    return torch.stack(vals), torch.stack(ids), torch.stack(maxes), torch.stack(sums)


def _logz(tile_max, tile_se):
    """Stable combine of per-range (max, Σexp) of shape (G, N) -> (N,)."""
    m, se = tile_max.T, tile_se.T
    big = m.amax(dim=1)
    return big + torch.log(torch.sum(se * torch.exp(m - big[:, None]), dim=1))


def _select_reference(vals, idx, tile_max, tile_se, k: int):
    """Plain PyTorch version of the second launch of K3b and K3a: the
    ranges' candidates (G, N, k), each list sorted ->
    (top_vals, top_idx, logz): the top k of the G·k candidates taken
    range-major, so that equal values keep the lowest vocabulary id."""
    N = vals.shape[1]
    flat_vals = vals.transpose(0, 1).reshape(N, -1)
    flat_idx = idx.transpose(0, 1).reshape(N, -1)
    top_vals, sel = top_k(flat_vals, k)
    return top_vals, torch.gather(flat_idx, 1, sel), _logz(tile_max, tile_se)


_functions: dict = {}


# the C entry points of csrc/vocab_topk.cu: argument types (ctypes would
# pass a Python int as a 32-bit int and cut the pointers)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {"vocab_topk_v2_grid": [_I] * 4,
          KERNEL: [_I] + [_P] * 3 + [_I] * 5 + [_P] * 5,
          "vocab_topk_v2_select": [_I] * 3 + [_P] * 8,
          KERNEL_V1: [_I] + [_P] * 3 + [_I] * 6 + [_P] * 5}
_grids: dict = {}


def _function(name: str):
    """The C entry point ``name`` of ``csrc/vocab_topk.cu``, built and
    loaded at first use, and the library's ``cuda_error_string``."""
    if name not in _functions:
        from seamless_communication_torch.ops.kernels import build

        lib = build.load("vocab_topk")
        fn = getattr(lib, name)
        fn.argtypes = _ENTRY[name]
        fn.restype = _I
        lib.cuda_error_string.argtypes = [_I]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _functions[name] = (fn, lib.cuda_error_string)
    return _functions[name]


def _check(kernel, x, table, row_scale, k, tile=None):
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
    if tile is not None and (tile < TILE or tile % TILE or -(-V // tile) > MAX_LISTS):
        raise ValueError(f"{kernel}: tile={tile} must be a multiple of {TILE} with at "
                         f"most {MAX_LISTS} tiles over V={V}")
    limit = min(V, MAX_K, tile or MAX_K)
    if not 1 <= k <= limit:
        raise ValueError(f"{kernel}: k={k} outside [1, {limit}]")


def _raise_on(kernel, err, error_string):
    if err:
        raise RuntimeError(f"{kernel} launch failed: {error_string(err).decode()} ({err})")


def _stream_grid(N: int, D: int, V: int, k: int) -> int:
    """Blocks of K3b's first launch at these sizes: as many as fit on the
    card at once (the kernel's occupancy), at most one a tile."""
    key = (N, D, V, k, torch.cuda.current_device())
    if key not in _grids:
        fn, error_string = _function("vocab_topk_v2_grid")
        G = fn(N, D, V, k)
        _raise_on("vocab_topk_v2_grid", max(-G, 0), error_string)
        _grids[key] = G
    return _grids[key]


def _launch_stream(x, table, row_scale, k: int, tile=None):
    """The first launch: K3b's (``tile`` None) -> (vals (G, N, k), ids (G,
    N, k), max (G, N), Σexp (G, N)) of the G blocks of ``stream_bounds(V,
    G)``; K3a's -> the same of the tiles of ``tile_bounds(V, tile)``, over
    a grid of at most K3b's blocks and one a tile."""
    kernel = KERNEL if tile is None else KERNEL_V1
    _check(kernel, x, table, row_scale, k, tile)
    (N, D), V = x.shape, table.shape[0]
    with torch.cuda.device(x.device):
        G = _stream_grid(N, D, V, k)
        L = G if tile is None else len(tile_bounds(V, tile)) - 1
        vals = torch.empty((L, N, k), dtype=torch.float32, device=x.device)
        ids = torch.empty((L, N, k), dtype=torch.int32, device=x.device)
        bmax = torch.empty((L, N), dtype=torch.float32, device=x.device)
        bse = torch.empty_like(bmax)
        fn, error_string = _function(kernel)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (vals.data_ptr(), ids.data_ptr(), bmax.data_ptr(), bse.data_ptr(), stream)
        head = (_DTYPE_CODES[x.dtype], x.data_ptr(), table.data_ptr(),
                row_scale.data_ptr(), N, D, V, k)
        err = (fn(*head, G, *ptrs) if tile is None
               else fn(*head, tile, min(G, L), *ptrs))
    _raise_on(kernel, err, error_string)
    launch_counts[kernel] += 1
    return vals, ids, bmax, bse


def _launch_select(vals, ids, bmax, bse, k: int, kernel: str = KERNEL):
    """The second launch of K3b (of K3a: ``kernel=KERNEL_V1``, the count it
    adds to): the lists and stats -> (top_vals, top_idx, logz)."""
    G, N, _ = vals.shape
    dev = vals.device
    top_vals = torch.empty((N, k), dtype=torch.float32, device=dev)
    top_idx = torch.empty((N, k), dtype=torch.int32, device=dev)
    logz = torch.empty((N,), dtype=torch.float32, device=dev)
    fn, error_string = _function("vocab_topk_v2_select")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(N, G, k, vals.data_ptr(), ids.data_ptr(), bmax.data_ptr(),
                 bse.data_ptr(), top_vals.data_ptr(), top_idx.data_ptr(),
                 logz.data_ptr(), stream)
    _raise_on("vocab_topk_v2_select", err, error_string)
    launch_counts[kernel] += 1
    return top_vals, top_idx, logz


def int8_vocab_topk_v2(x, table_i8, row_scale, k: int):
    """x (N, D) float32 or bfloat16, table (V, D) int8, row_scale (V,) f32 ->
    (top_vals (N, k) raw fp32 logits, top_idx (N, k) int32, logz (N,) fp32).

    CPU tensors take the plain version; CUDA tensors launch the two kernels
    (the stream, then the selection), and anything they do not take
    raises. k is at most ``MAX_K``."""
    if x.device.type == "cpu":
        return _reference(x, table_i8, row_scale, k)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: no kernel for device {x.device}")
    return _launch_select(*_launch_stream(x, table_i8, row_scale, k), k)


def int8_vocab_topk(x, table_i8, row_scale, k: int, *, tile=None):
    """The same contract as :func:`int8_vocab_topk_v2`, through lists of
    each tile of ``tile`` rows (a multiple of 128, at least k; at most
    ``MAX_LISTS`` tiles), as the TPU kernel's ``tile``. None: on the card,
    ``fill_tile`` of the stream's grid at these sizes."""
    if x.device.type == "cpu":
        return _reference(x, table_i8, row_scale, k)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL_V1}: no kernel for device {x.device}")
    if tile is None:
        _check(KERNEL_V1, x, table_i8, row_scale, k)
        with torch.cuda.device(x.device):
            tile = fill_tile(table_i8.shape[0], _stream_grid(*x.shape, table_i8.shape[0], k))
    lists = _launch_stream(x, table_i8, row_scale, k, tile)
    return _launch_select(*lists, k, kernel=KERNEL_V1)


def bound_bytes(N: int, D: int, V: int, k: int, *, elem: int) -> int:
    """Bytes the function must move, each input read once and each output
    written once: the int8 table, its row scales and x in; the top-k values
    and ids and logz out. The same for both kernels: what one of them writes
    between its launch and the selection is not the function's."""
    return V * D + 4 * V + N * D * elem + N * k * 8 + 4 * N
