"""The fp32 flash-attention backward's tile skipping and block heights, on
the CPU (the port's ``ops/kernels/flash_attention.py``):

- fp32 K6b leaves out, for its keys, the row tiles of ``skippable_tiles``:
  for each key tile, the plain ``_reference_bwd(part="dkv")`` over the rows
  of the tiles it takes gives that tile's dk and dv bit for bit as the
  backward over every row does, in fp32 and bf16 (the dK/dV counterpart of
  ``test_skipped_tiles_change_no_bit`` in test_torch_flash_attention_bwd.py),
  and the result is held to the JAX package's library reference backward.
- The block heights of fp32 K6b (keys) and K6c (query rows),
  ``fp32_block_rows``: every key and row is owned by exactly one block, each
  block lies within one 64 x 64 tile of the skip rule, and each kernel's
  shared memory (``fp32_bwd_shape``) fits one block of the card with a ring
  of at least two stages, for T in 1..2048 and every head dim.
The kernels against their plain versions run only where there is a card
(test_torch_flash_attention_bwd.py ``test_kernels_match_plain_backward_on_card``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as lib

from seamless_communication_torch.ops.kernels import flash_attention as tfl

from tests.test_torch_flash_attention_bwd import DTYPES, SKIP_CASES, _skip_inputs


def _cast(x, dtype):
    return x if x is None or not x.is_floating_point() else x.to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(SKIP_CASES))
def test_skipped_row_tiles_change_no_bit_of_dk_dv(case, dtype):
    """For each key tile, ``_reference_bwd(part="dkv")`` with the rows of its
    skipped tiles dropped gives the tile's dk and dv bit for bit: a skipped
    pair's p and dS are exact zeros, so leaving its rows out of the sums, as
    fp32 K6b does, changes nothing."""
    _, tdt, _ = DTYPES[dtype]
    qs, k, v, ab, q_seg, kv_seg, do = (_cast(x, tdt) for x in _skip_inputs(case))
    out, m, l = tfl._reference_fwd(qs, k, v, ab, q_seg, kv_seg)
    _, dk, dv, _ = tfl._reference_bwd(qs, k, v, ab, q_seg, kv_seg, out, m, l, do, part="dkv")
    skip = tfl.skippable_tiles(m, q_seg, kv_seg, k.shape[2])
    Tq, Tk = qs.shape[2], k.shape[2]
    dropped = 0
    for h in range(qs.shape[1]):
        for kt in range(skip.shape[3]):
            keys = slice(64 * kt, min(64 * kt + 64, Tk))
            keep = torch.tensor([i for i in range(Tq) if not skip[0, h, i // 64, kt]],
                                dtype=torch.long)
            dropped += Tq - len(keep)
            if not len(keep):       # every row skipped: the tile's sums are exact zeros
                assert not dk[0, h, keys].any() and not dv[0, h, keys].any()
                continue
            rows = lambda x: None if x is None else x[:, :, keep]
            part = tfl._reference_bwd(rows(qs), k, v, rows(ab), q_seg[:, keep], kv_seg,
                                      rows(out), rows(m), rows(l), rows(do), part="dkv")
            assert torch.equal(part[1][0, h, keys], dk[0, h, keys]), (h, kt, "dk")
            assert torch.equal(part[2][0, h, keys], dv[0, h, keys]), (h, kt, "dv")
    assert dropped > 0


@pytest.mark.parametrize("case", list(SKIP_CASES))
def test_dropped_rows_match_library_reference(case):
    """dk and dv with each key tile's skipped rows dropped, against the
    library's ``mha_reference_bwd`` over every row (fed the library
    reference forward's residuals), fp32 within 1e-5 * (1 + |ref|)."""
    qs, k, v, ab, q_seg, kv_seg, do = _skip_inputs(case)
    j = lambda x: None if x is None else jnp.asarray(x.numpy())
    seg = lib.SegmentIds(q=j(q_seg), kv=j(kv_seg))
    o, l, m = lib.mha_reference_no_custom_vjp(j(qs), j(k), j(v), j(ab), seg,
                                              save_residuals=True)
    _, want_dk, want_dv, _ = lib.mha_reference_bwd(j(qs), j(k), j(v), j(ab), seg, o, l, m,
                                                   j(do))
    out, m_t, l_t = (torch.as_tensor(np.array(x)) for x in (o, m, l))
    skip = tfl.skippable_tiles(m_t, q_seg, kv_seg, k.shape[2])
    Tq, Tk = qs.shape[2], k.shape[2]
    got_dk, got_dv = torch.empty_like(k), torch.empty_like(v)
    for h in range(qs.shape[1]):
        for kt in range(skip.shape[3]):
            keys = slice(64 * kt, min(64 * kt + 64, Tk))
            keep = torch.tensor([i for i in range(Tq) if not skip[0, h, i // 64, kt]],
                                dtype=torch.long)
            if not len(keep):
                got_dk[0, h, keys] = got_dv[0, h, keys] = 0.0
                continue
            rows = lambda x: None if x is None else x[:, :, keep]
            part = tfl._reference_bwd(rows(qs), k, v, rows(ab), q_seg[:, keep], kv_seg,
                                      rows(out), rows(m_t), rows(l_t), rows(do), part="dkv")
            got_dk[0, h, keys] = part[1][0, h, keys]
            got_dv[0, h, keys] = part[2][0, h, keys]
    for name, g, w in (("dk", got_dk, want_dk), ("dv", got_dv, want_dv)):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w)
        assert (err <= 1e-5 * (1 + np.abs(w))).all(), f"{name}: max err {err.max():.3g}"


@pytest.mark.parametrize("Dh", tfl.BWD_HEAD_DIMS)
def test_block_plans_own_every_key_and_row_once(Dh):
    """fp32 K6b's key blocks and K6c's row blocks (``fp32_block_rows`` of Tk
    and Tq) for T in 1..2048: each key (row) lies in exactly one block, a
    block lies within one 64-key (64-row) tile of the skip rule, and the
    kernel's shared memory (``fp32_bwd_shape``) fits one block of the card
    (227 KB, less the kernels' static arrays) with a ring of at least two
    stages."""
    for part in ("dkv", "dq"):
        for block in (32, 64):
            smem, stages = tfl.fp32_bwd_shape(part, Dh, block)
            assert stages >= 2 and smem <= tfl.SMEM_PER_BLOCK - 1024, (part, block)
    for B, H in ((1, 16), (2, 3), (2, 16)):
        for T in range(1, 2049):
            block = tfl.fp32_block_rows(B, H, T)
            assert block in (32, 64)
            n_blocks = -(-T // block)           # the kernels' grid
            owned = np.zeros(T, int)
            for i in range(n_blocks):
                owned[i * block:(i + 1) * block] += 1
                assert i * block // 64 == min(i * block + block, T) - 1 >> 6
            assert (owned == 1).all(), (B, H, T)
            # 32 only where 64-row blocks would fill at most half of the SMs
            assert (block == 32) == (B * H * -(-T // 64) * 2 <= tfl.NUM_SMS)
