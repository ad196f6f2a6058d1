"""How K5, the lazy reorder's row-indexed decode attention, splits a (b, h)
over a thread-block cluster: K1's split (``split_plan(..., indexed=True)``
of the port's ``ops/kernels/decode_attention.py``), each row read from its
own slot ``row_src[b, t]``, on the CPU.

- The plan: K1's cluster and slices, the block's shared memory holding its
  rows' slots beside the scales, within the budget.
- The split-and-merge K5 computes, written out in plain PyTorch
  (``indexed_split_merge`` below): each slice's rows gathered through the
  table, its logits and max, the cluster's max, each slice's weights and
  partial sums, added in rank order. Held against the port's
  ``_indexed_reference`` and the JAX package's ``_indexed_reference``
  within 2e-5 (fp32 summation order), at every cluster size, on a uniform,
  a beam-history, an identity and a one-slot table; in bf16 within 1.6e-2.
The kernel against its plain version runs only where there is a card.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seamless_communication_tpu.ops.kernels import decode_attention as jda
from seamless_communication_torch.ops.kernels import decode_attention as tda
from seamless_communication_torch.ops.kernels import launch_counts
from seamless_communication_torch.ops.modules import true_div

NAMES = ("q", "kt", "vt", "kc", "vc", "ks", "vs")


def beam_history(B: int, T: int, rng) -> np.ndarray:
    """A (B, T) table as a beam search leaves it: at each step every beam
    continues a random earlier beam and owns its new row."""
    rs = np.tile(np.arange(B)[:, None], (1, T))
    for t in range(1, T):
        rs = rs[rng.integers(0, B, B)]
        rs[:, t] = np.arange(B)
    return rs


def tables(B: int, T: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"uniform": rng.integers(0, B, (B, T)), "beam history": beam_history(B, T, rng),
           "identity": np.tile(np.arange(B)[:, None], (1, T)),
           "single slot": np.full((B, T), B - 1)}
    return {k: v.astype(np.int32) for k, v in out.items()}


def _inputs(rng, B=5, H=4, T=48, Dh=16):
    return dict(
        q=rng.standard_normal((B, H, Dh)).astype(np.float32),
        kt=rng.standard_normal((B, H, Dh)).astype(np.float32),
        vt=rng.standard_normal((B, H, Dh)).astype(np.float32),
        kc=rng.integers(-127, 128, (B, H, T, Dh)).astype(np.int8),
        vc=rng.integers(-127, 128, (B, H, T, Dh)).astype(np.int8),
        ks=(rng.random((B, H, T)) * 0.1 + 0.01).astype(np.float32),
        vs=(rng.random((B, H, T)) * 0.1 + 0.01).astype(np.float32),
    )


def indexed_split_merge(q, k_t, v_t, k_cache, v_cache, k_scale, v_scale, row_src, step,
                        plan):
    """K5's arithmetic in plain PyTorch: each slice's rows gathered through
    ``row_src``, their raw logits (q . k) * k_scale and max, divided by
    sqrt(Dh) (a correctly rounded division keeps the order); the max over
    the slices and the current row; each slice's weights round_dtype(exp(l
    - m) * v_scale), denominator and value sums; the slices' sums added in
    rank order."""
    dtype, Dh = q.dtype, q.shape[-1]
    T = k_cache.shape[2]
    kc, vc, ks, vs = (tda.gather_rows(x, row_src) for x in (k_cache, v_cache, k_scale,
                                                              v_scale))
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


@pytest.mark.parametrize("T", [1, 127, 320, 8192])
def test_plan_keeps_the_rows_slots(T):
    """K5's plan is K1's split with 4 more bytes a row of shared memory (its
    rows' slots), within the same budget."""
    for Dh in (16, 64, 128, 256):
        for B, H in ((1, 16), (5, 16), (10, 16), (40, 16)):
            for cluster in (None, 1, 2, 4, 8):
                k1 = tda.split_plan(B, H, T, Dh, 8, cluster)
                k5 = tda.split_plan(B, H, T, Dh, 8, cluster, indexed=True)
                assert (k5.cluster, k5.slice_rows, k5.tile_rows) == (
                    k1.cluster, k1.slice_rows, k1.tile_rows)
                slot = -(-k5.tile_rows * Dh // tda.SLOT_ALIGN) * tda.SLOT_ALIGN
                assert k5.smem_bytes == k5.stages * slot + 12 * k5.slice_rows
                assert 1 <= k5.stages <= k1.stages
                assert k5.smem_bytes <= tda.SMEM_BUDGET


@pytest.mark.parametrize("table", ["uniform", "beam history", "identity", "single slot"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("T", [48, 127])
def test_split_merge_matches_the_plain_versions(table, cluster, T):
    """Every step at the slice boundaries and a few others: the indexed
    split-and-merge within 2e-5 of the port's plain version and of the JAX
    package's."""
    d = _inputs(np.random.default_rng(T + cluster), T=T)
    rs = tables(5, T, T)[table]
    plan = tda.split_plan(5, 4, T, 16, 8, cluster, indexed=True)
    edges = {r.start for r in plan.slices(T)} | {r.stop - 1 for r in plan.slices(T) if len(r)}
    for step in sorted({0, 1, T // 2, T - 1} | (edges & set(range(T)))):
        args = (*(torch.from_numpy(d[n]) for n in NAMES), torch.from_numpy(rs), step)
        got = indexed_split_merge(*args, plan)
        torch.testing.assert_close(got, tda._indexed_reference(*args), rtol=2e-5, atol=2e-5)
        jwant = jda._indexed_reference(*(jnp.asarray(d[n]) for n in NAMES), jnp.asarray(rs),
                                       step)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_merge_in_the_model_dtype(dtype):
    """In bf16 the weights round to bf16 where the plain version rounds
    them: the indexed split-and-merge within bf16's tolerance of 1.6e-2."""
    d = _inputs(np.random.default_rng(11), T=64)
    rs = torch.from_numpy(tables(5, 64, 3)["beam history"])
    plan = tda.split_plan(5, 4, 64, 16, 8, 4, indexed=True)
    vecs = [torch.from_numpy(d[n]).to(dtype) for n in ("q", "kt", "vt")]
    rest = [torch.from_numpy(d[n]) for n in ("kc", "vc", "ks", "vs")]
    tol = 2e-5 if dtype == torch.float32 else 1.6e-2
    for step in (0, 16, 40, 63):
        args = (*vecs, *rest, rs, step)
        torch.testing.assert_close(indexed_split_merge(*args, plan).float(),
                                   tda._indexed_reference(*args).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
def test_kernel_matches_plain_version_on_card(dtype, cluster):
    """K5 on the card against its plain version at the main-path shape
    (B=5, H=16, T=320, Dh=64), on every table, at each cluster size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(2)
    dt = getattr(torch, dtype)
    B, H, T, Dh = 5, 16, 320, 64
    dev = torch.device("cuda")
    vecs = [torch.as_tensor(rng.standard_normal((B, H, Dh)), device=dev).to(dt)
            for _ in range(3)]
    (kq, ks), (vq, vs) = (tda.quantize_kv_rows(torch.as_tensor(
        rng.standard_normal((B, H, T, Dh)), dtype=torch.float32, device=dev))
        for _ in range(2))
    tol = 2e-5 if dt == torch.float32 else 1.6e-2
    for name, rs in tables(B, T, 1).items():
        rs = torch.as_tensor(rs, device=dev)
        for step in (0, 1, 79, 200, T - 1):
            args = (*vecs, kq, vq, ks, vs, rs, step)
            before = launch_counts["decode_attention_indexed"]
            got = tda._launch_indexed(*args, cluster=cluster)
            assert launch_counts["decode_attention_indexed"] == before + 1
            torch.testing.assert_close(got.float(), tda._indexed_reference(*args).float(),
                                       rtol=tol, atol=tol, msg=f"{name} step {step}")
