"""How K1 and K2 split a (b, h) over a thread-block cluster (``split_plan``
of the port's ``ops/kernels/decode_attention.py``), on the CPU.

- The plan: every row 0..T-1 owned by exactly one block's slice, the ring's
  tiles covering each slice, and the plan within the limits that
  ``csrc/decode_attention.cuh`` checks (cluster 1, 2, 4 or 8, at most
  MAX_STAGES tiles of at most TILE_BYTES, dynamic shared memory within the
  budget, which leaves room for the kernel's static shared memory in the
  227 KB a block may have).
- The split-and-merge the kernels compute, written out in plain PyTorch
  (``split_merge`` below): each slice's logits and max, the cluster's max,
  each slice's weights and partial sums, added in rank order. Held against
  the port's ``_reference`` / ``_reference_int4`` and the JAX package's
  ``_reference`` / ``_reference_int4`` within 2e-5 (fp32 summation order);
  the two packages' new caches bit-equal.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seamless_communication_tpu.ops.kernels import decode_attention as jda
from seamless_communication_torch.ops.attention import unpack_int4
from seamless_communication_torch.ops.kernels import decode_attention as tda
from seamless_communication_torch.ops.modules import true_div

STATIC_SMEM = 16 * 1024      # over the kernel's static shared memory (15 KB, ptxas)
BLOCK_SMEM = 227 * 1024      # shared memory a block may have on an H100


@pytest.mark.parametrize("T", [1, 16, 127, 320, 1000, 8192])
@pytest.mark.parametrize("bits", [8, 4])
def test_every_row_is_owned_by_one_slice(T, bits):
    for Dh in range(16, 257, 16):
        for B, H in ((1, 4), (1, 16), (5, 16), (10, 16), (40, 16)):
            for cluster in (None, 1, 2, 4, 8):
                plan = tda.split_plan(B, H, T, Dh, bits, cluster)
                owner = np.zeros(T, int)
                for rows in plan.slices(T):
                    owner[rows.start:rows.stop] += 1
                    assert len(rows) <= plan.slice_rows
                assert (owner == 1).all(), (B, H, T, Dh, plan)
                assert len(plan.slices(T)) == plan.cluster


@pytest.mark.parametrize("T", [1, 16, 127, 320, 1000, 8192])
@pytest.mark.parametrize("bits", [8, 4])
def test_plan_fits_the_kernel_limits(T, bits):
    for Dh in range(16, 257, 16):
        row = Dh * bits // 8
        for B, H in ((1, 4), (1, 16), (5, 16), (10, 16), (40, 16)):
            for cluster in (None, 1, 2, 4, 8):
                plan = tda.split_plan(B, H, T, Dh, bits, cluster)
                assert plan.cluster in (1, 2, 4, 8)
                assert plan.slice_rows * plan.cluster >= T
                assert 1 <= plan.tile_rows <= plan.slice_rows
                assert plan.tile_rows * row <= tda.TILE_BYTES or plan.tile_rows == 1
                assert 1 <= plan.stages <= tda.MAX_STAGES
                slot = -(-plan.tile_rows * row // tda.SLOT_ALIGN) * tda.SLOT_ALIGN
                # the ring, then a k-scale (logit, weight) and a v-scale row
                assert plan.smem_bytes == plan.stages * slot + 8 * plan.slice_rows
                assert plan.smem_bytes <= tda.SMEM_BUDGET
                assert plan.smem_bytes + STATIC_SMEM <= BLOCK_SMEM
                # a slice that fits the ring has every tile in flight at once
                tiles = 2 * -(-plan.slice_rows // plan.tile_rows)
                if tiles <= tda.MAX_STAGES and tiles * slot + 8 * plan.slice_rows <= tda.SMEM_BUDGET:
                    assert plan.stages == tiles


def test_cluster_choice():
    """The host splits a (b, h) until the grid holds two blocks an SM or a
    slice would fall under 32 rows: 4 blocks at the main path's beam 5 x 16
    heads, 8 for one hypothesis, 2 at beam 10, none for a short cache."""
    assert tda.split_plan(5, 16, 320, 64, 8).cluster == 4
    assert tda.split_plan(1, 16, 320, 64, 8).cluster == 8
    assert tda.split_plan(10, 16, 320, 64, 8).cluster == 2
    assert tda.split_plan(40, 16, 320, 64, 8).cluster == 1
    assert tda.split_plan(5, 16, 63, 64, 8).cluster == 1
    assert tda.split_plan(5, 16, 127, 64, 4).cluster == 2
    with pytest.raises(ValueError):
        tda.split_plan(5, 16, 320, 64, 8, cluster=3)


def split_merge(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, step, src, plan, bits):
    """The kernels' arithmetic in plain PyTorch: a slice's raw logits
    (q . k) * k_scale and their max, divided by sqrt(Dh) (a correctly
    rounded division keeps the order); the max over the slices and the
    current row; each slice's weights round_dtype(exp(l - m) * v_scale), its
    denominator and value sums; the slices' sums added in rank order."""
    dtype, Dh = q.dtype, q.shape[-1]
    T = k_cache.shape[2]
    src = src.long()
    kc, vc = k_cache[src], v_cache[src]
    ks, vs = k_scale[src], v_scale[src]
    if bits == 4:
        kc, vc = (torch.cat(unpack_int4(x), dim=-1) for x in (kc, vc))
    qf = q.float()
    lcur = true_div((qf * k_t.float()).sum(-1), math.sqrt(Dh))
    parts = []
    for rows in plan.slices(T):
        att = range(rows.start, min(rows.stop, step))
        raw = torch.einsum("bhd,bhtd->bht", qf, kc[:, :, att].float()) * ks[:, :, att]
        m = (true_div(raw.amax(-1), math.sqrt(Dh)) if len(att)
             else torch.full(lcur.shape, -math.inf))
        parts.append((att, raw, m))
    m = torch.stack([pm for _, _, pm in parts]).amax(0)
    m = torch.maximum(torch.clamp_min(m, tda.NEG), lcur)
    den = torch.zeros_like(lcur)
    acc = torch.zeros_like(qf)
    for att, raw, _ in parts:
        p = torch.exp(true_div(raw, math.sqrt(Dh)) - m[..., None])
        w = (p * vs[:, :, att]).to(dtype).float()
        den = den + p.sum(-1)
        acc = acc + torch.einsum("bht,bhtd->bhd", w, vc[:, :, att].float())
    pc = torch.exp(lcur - m)
    return ((acc + pc[..., None] * v_t.float()) / (den + pc)[..., None]).to(dtype)


def _inputs(rng, bits, B=5, H=4, T=48, Dh=16):
    row = Dh if bits == 8 else Dh // 2
    return dict(
        q=rng.standard_normal((B, H, Dh)).astype(np.float32),
        kt=rng.standard_normal((B, H, Dh)).astype(np.float32),
        vt=rng.standard_normal((B, H, Dh)).astype(np.float32),
        kc=rng.integers(-127 if bits == 8 else -128, 128, (B, H, T, row)).astype(np.int8),
        vc=rng.integers(-127 if bits == 8 else -128, 128, (B, H, T, row)).astype(np.int8),
        ks=(rng.random((B, H, T)) * 0.1 + 0.01).astype(np.float32),
        vs=(rng.random((B, H, T)) * 0.1 + 0.01).astype(np.float32),
        src=np.array([3, 0, 3, 1, 1][:B], np.int32),
    )


NAMES = ("q", "kt", "vt", "kc", "vc", "ks", "vs")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("T", [48, 127])
def test_split_merge_matches_the_plain_versions(bits, cluster, T):
    """Every step at the slice boundaries and a few others, each cluster
    size: the split-and-merge within 2e-5 of the port's plain version and of
    the JAX package's."""
    d = _inputs(np.random.default_rng(T + cluster + bits), bits, T=T)
    plan = tda.split_plan(5, 4, T, 16, bits, cluster)
    edges = {r.start for r in plan.slices(T)} | {r.stop - 1 for r in plan.slices(T) if len(r)}
    plain = tda._reference if bits == 8 else tda._reference_int4
    jplain = jda._reference if bits == 8 else jda._reference_int4
    for step in sorted({0, 1, T // 2, T - 1} | (edges & set(range(T)))):
        args = (*(torch.from_numpy(d[n]) for n in NAMES), step, torch.from_numpy(d["src"]))
        got = split_merge(*args, plan, bits)
        want = plain(*args)
        jwant = jplain(*(jnp.asarray(d[n]) for n in NAMES), jnp.int32(step),
                       jnp.asarray(d["src"]))
        torch.testing.assert_close(got, want[0], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant[0]), rtol=2e-5, atol=2e-5)
        for g, w in zip(want[1:3], jwant[1:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_merge_in_the_model_dtype(dtype):
    """In bf16 the weights round to bf16 where the plain version rounds
    them: the split-and-merge within bf16's tolerance of 1.6e-2."""
    d = _inputs(np.random.default_rng(11), 8, T=64)
    plan = tda.split_plan(5, 4, 64, 16, 8, 4)
    vecs = [torch.from_numpy(d[n]).to(dtype) for n in ("q", "kt", "vt")]
    rest = [torch.from_numpy(d[n]) for n in ("kc", "vc", "ks", "vs")]
    for step in (0, 16, 40, 63):
        args = (*vecs, *rest, step, torch.from_numpy(d["src"]))
        tol = 2e-5 if dtype == torch.float32 else 1.6e-2
        torch.testing.assert_close(split_merge(*args, plan, 8).float(),
                                   tda._reference(*args)[0].float(), rtol=tol, atol=tol)
