"""The fp32 flash-attention forward's tile skipping (``skippable_tiles_fwd``
of the port's ``ops/kernels/flash_attention.py``, the predicate of fp32 K6)
and its choice of block height (``fp32_block_rows``), on the CPU.

- The rule marks a (64-row tile, 64-key tile) pair only where every key of
  the tile is masked for every row of the tile and every row has an
  unmasked key somewhere; a row whose keys are all masked makes its row
  tile take every key tile; nothing is skipped without segment ids or with
  ``ab``.
- Exactness: for each row tile, the plain forward ``_reference_fwd`` over
  the keys of the tiles it takes gives that tile's rows of ``out``, ``m``
  and ``l`` bit for bit as the forward over every key does, in fp32 and
  bf16: leaving the tiles out, as the kernel does, changes nothing. Cases:
  key padding (Tq != Tk, ragged tails), several segments, a row of a
  segment no key has, padded rows in a segment of their own.
- The whole forward with the rule's tiles dropped is held to the JAX
  package's library flash attention (interpret mode, via ``try_flash``'s
  segment-id path) within 1e-5.
The kernel against its plain version runs only where there is a card.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax._src import config as jax_config

from seamless_communication_tpu.ops import fused_attention as jfa
from seamless_communication_torch.ops.kernels import flash_attention as tfl
from seamless_communication_torch.ops.kernels import launch_counts


@contextlib.contextmanager
def pallas_interpret():
    """Pallas kernels traced within run in JAX's HLO interpreter (as in
    tests/test_torch_flash_attention.py)."""
    switch = jax_config.pallas_tpu_interpret_mode_context_manager
    prev = switch.swap_local(True)
    try:
        yield
    finally:
        switch.set_local(prev)


def _segments(case: str):
    """(Tq, Tk, q_seg (Tq,), kv_seg (Tk,)) numpy int32 of a case."""
    if case == "key padding":
        # the NAR T2U's FFT layers: every row in segment 1, keys past 70 padding
        Tq, Tk = 130, 200
        return Tq, Tk, np.ones(Tq), (np.arange(Tk) < 70).astype(int)
    if case == "several segments":
        return 130, 200, np.repeat([1, 2, 3], [64, 64, 2]), np.repeat([1, 2, 3], [64, 64, 72])
    if case == "all-masked row":
        # row 129 in segment 9, which no key has
        return 130, 200, np.repeat([1, 2, 3, 9], [64, 64, 1, 1]), np.repeat([1, 2, 3],
                                                                             [64, 64, 72])
    if case == "padded rows":
        # rows past 150 and keys past 90 are padding, in segment 0
        Tq, Tk = 200, 230
        return Tq, Tk, (np.arange(Tq) < 150).astype(int), (np.arange(Tk) < 90).astype(int)
    raise KeyError(case)


# the rule's pairs (row tile, key tile) that are skipped
SKIPPED = {
    "key padding": [[False, False, True, True]] * 3,
    "several segments": [[False, True, True, True], [True, False, True, True],
                         [True, True, False, False]],
    "all-masked row": [[False, True, True, True], [True, False, True, True],
                       [False, False, False, False]],
    # row tile 2 (rows 128-191) holds rows of both segments: nothing skipped;
    # row tile 3 (rows 192-199) is padding alone, in segment 0, which every
    # padding key has
    "padded rows": [[False, False, True, True], [False, False, True, True],
                    [False, False, False, False], [True, False, False, False]],
}


def _inputs(case: str, dtype=torch.float32):
    """torch (qs, k, v, q_seg, kv_seg) of a case: B=1, H=2, Dh=16."""
    Tq, Tk, q_seg, kv_seg = _segments(case)
    rng = np.random.default_rng(list(SKIPPED).index(case))
    qs = torch.as_tensor(rng.standard_normal((1, 2, Tq, 16)) * 0.25, dtype=torch.float32)
    k, v = (torch.as_tensor(rng.standard_normal((1, 2, Tk, 16)), dtype=torch.float32)
            for _ in range(2))
    segs = [torch.as_tensor(x[None], dtype=torch.int32) for x in (q_seg, kv_seg)]
    return (qs.to(dtype), k.to(dtype), v.to(dtype), *segs)


@pytest.mark.parametrize("case", list(SKIPPED))
def test_rule_marks_the_masked_tiles(case):
    qs, k, v, q_seg, kv_seg = _inputs(case)
    skip = tfl.skippable_tiles_fwd(q_seg, kv_seg, qs.shape[2], k.shape[2])
    want = torch.tensor(SKIPPED[case])
    assert skip.shape == (1,) + want.shape
    assert torch.equal(skip[0], want)


def test_rule_skips_nothing_without_segments_or_with_ab():
    qs, k, v, q_seg, kv_seg = _inputs("several segments")
    Tq, Tk = qs.shape[2], k.shape[2]
    assert not tfl.skippable_tiles_fwd(None, None, Tq, Tk).any()
    ab = torch.zeros((1, 2, Tq, Tk))
    assert not tfl.skippable_tiles_fwd(q_seg, kv_seg, Tq, Tk, ab).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(SKIPPED))
def test_dropped_tiles_change_no_bit(case, dtype):
    """Each row tile's out, m and l from the keys of the tiles it takes
    equal the full forward's bit for bit."""
    qs, k, v, q_seg, kv_seg = _inputs(case, dtype)
    out, m, l = tfl._reference_fwd(qs, k, v, None, q_seg, kv_seg)
    Tq, Tk = qs.shape[2], k.shape[2]
    skip = tfl.skippable_tiles_fwd(q_seg, kv_seg, Tq, Tk)[0]
    for rt in range(skip.shape[0]):
        rows = slice(64 * rt, min(64 * rt + 64, Tq))
        keep = torch.tensor([j for j in range(Tk) if not skip[rt, j // 64]])
        got = tfl._reference_fwd(qs[:, :, rows], k[:, :, keep], v[:, :, keep], None,
                                 q_seg[:, rows], kv_seg[:, keep])
        for name, g, w in zip(("out", "m", "l"), got, (out, m, l)):
            assert torch.equal(g, w[:, :, rows]), (case, rt, name)


@pytest.fixture
def fused_on(monkeypatch):
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", "1")


def test_dropped_tiles_match_jax_library_kernel(fused_on):
    """The forward over the rule's tiles alone, each row tile on its own,
    against the JAX package's ``try_flash`` (its library kernel in interpret
    mode; key padding as segment ids) within 1e-5: the NAR T2U's FFT shape
    cut to B=1, H=2, T=256 with 50 valid keys, where the rule takes one key
    tile of four."""
    rng = np.random.default_rng(7)
    T, Dh, valid = 256, 16, 50
    q, k, v = (rng.standard_normal((1, 2, T, Dh)).astype(np.float32) for _ in range(3))
    pad = np.where(np.arange(T) < valid, 0.0, -1e9).astype(np.float32)[None, None, None]
    with pallas_interpret():
        want = np.asarray(jfa.try_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(pad), None, 0.25))
    qs = torch.as_tensor(q) * 0.25
    kt, vt = torch.as_tensor(k), torch.as_tensor(v)
    q_seg = torch.ones((1, T), dtype=torch.int32)
    kv_seg = torch.as_tensor((np.arange(T) < valid)[None], dtype=torch.int32)
    skip = tfl.skippable_tiles_fwd(q_seg, kv_seg, T, T)[0]
    assert int(skip.sum()) == 4 * 3
    got = torch.empty_like(qs)
    for rt in range(4):
        rows = slice(64 * rt, 64 * rt + 64)
        keep = torch.tensor([j for j in range(T) if not skip[rt, j // 64]])
        got[:, :, rows] = tfl._reference_fwd(qs[:, :, rows], kt[:, :, keep], vt[:, :, keep],
                                             None, q_seg[:, rows], kv_seg[:, keep])[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_block_rows():
    """64-row blocks where they fill the card (the 10 s encoder, the FFT
    layers, the train steps' attentions), 32 where 64-row blocks would fill
    at most half of its 132 SMs (the 4 s encoder, the re-decode)."""
    assert tfl.fp32_block_rows(1, 16, 512) == 64
    assert tfl.fp32_block_rows(1, 16, 2048) == 64
    assert tfl.fp32_block_rows(2, 16, 500) == 64
    assert tfl.fp32_block_rows(1, 16, 256) == 32
    assert tfl.fp32_block_rows(1, 16, 128) == 32
    assert tfl.fp32_block_rows(2, 3, 200) == 32


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("case", list(SKIPPED))
def test_kernel_matches_plain_version_on_card(case, rows):
    """fp32 K6 on the card, which leaves out the rule's tiles, against its
    plain version within 1e-5, bit-equal with and without residuals, at
    each block height."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [x.cuda() for x in _inputs(case)]
    args = (*args[:3], None, *args[3:])
    before = launch_counts["flash_attention"]
    out = tfl._launch(*args, block_rows=rows)[0]
    res, m, l = tfl._launch(*args, residuals=True, block_rows=rows)
    assert launch_counts["flash_attention"] == before + 2
    want, m_ref, l_ref = tfl._reference_fwd(*args)
    assert torch.equal(out, res)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_ref, rtol=1e-5, atol=1e-5)
