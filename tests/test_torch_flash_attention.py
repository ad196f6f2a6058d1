"""The fused-attention option (kernel K6): the port's ``try_flash`` against
the JAX package's ``try_flash``, whose library Pallas flash-attention kernel
runs in JAX's interpret mode on the CPU (``pallas_interpret``), on the same
numpy inputs.

Cases: a pure key-padding bias (segment ids; one batch row shorter than 128
in a batch with Tk = 256, so whole key tiles are masked), Shaw-like
relative logits plus padding, a causal plus padding bias, the XL form (q+u,
its own scale, the relative term as post-scale logits), Tq != Tk, lengths
that are not multiples of 128, and head dims 16, 32, 64 and 128; fp32 within
1e-5 and bf16 within 1e-2. ``try_flash`` returns None in exactly the cases where JAX's does.
The CUDA kernel against its plain version runs only where there is a card."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax._src import config as jax_config

from seamless_communication_tpu.ops import fused_attention as jfa

from seamless_communication_torch.ops import attention as tattn
from seamless_communication_torch.ops import fused_attention as tfa
from seamless_communication_torch.ops.kernels import flash_attention as tfl
from seamless_communication_torch.ops.kernels import launch_counts

# (B, H, Tq, Tk, Dh, bias kind, scale)
CASES = {
    "key_padding": (2, 2, 256, 256, 16, "padding", 0.25),
    "shaw_extra_padding": (2, 2, 150, 150, 16, "extra+padding", 0.25),
    "causal_padding": (2, 2, 150, 150, 16, "causal+padding", 0.25),
    "xl_q_plus_u": (2, 2, 150, 150, 16, "xl", 0.25),
    "tq_ne_tk": (2, 2, 130, 200, 16, "padding", 0.25),
    "ragged_no_bias": (1, 2, 130, 130, 32, "none", 0.125),
    # the head dims the bf16 kernels specialise, with ragged tiles
    "dh64_extra_padding": (1, 2, 150, 150, 64, "extra+padding", 0.125),
    "dh128_padding": (1, 1, 130, 136, 128, "padding", 0.0884),
}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          # bf16 keeps 8 bits: 1e-2 relative, and 1e-2 absolute for outputs
          # near 0 (averages of unit-variance values)
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _inputs(case: str):
    """numpy q, k, v (fp32), bias, extra_logits and scale of a case."""
    B, H, Tq, Tk, Dh, kind, scale = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q = rng.standard_normal((B, H, Tq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, H, Tk, Dh)).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, Dh)).astype(np.float32)
    lens = np.array([Tk] + [100] * (B - 1))            # a row shorter than 128
    pad = np.where(np.arange(Tk)[None, :] < lens[:, None], 0.0, -1e9)
    pad = pad.astype(np.float32)[:, None, None, :]     # (B, 1, 1, Tk)
    bias = extra = None
    if kind == "padding":
        bias = pad
    elif kind == "extra+padding":
        bias, extra = pad, rng.standard_normal((B, H, Tq, Tk)).astype(np.float32)
    elif kind == "causal+padding":
        causal = np.where(np.arange(Tk)[None, :] <= np.arange(Tq)[:, None], 0.0, -1e9)
        bias = (causal[None, None] + pad).astype(np.float32)       # (B, 1, Tq, Tk)
    elif kind == "xl":
        u = rng.standard_normal((1, H, 1, Dh)).astype(np.float32)
        q = q + u
        bias, extra = pad, (rng.standard_normal((B, H, Tq, Tk)) * scale).astype(np.float32)
    return q, k, v, bias, extra, scale


@contextlib.contextmanager
def pallas_interpret():
    """Pallas kernels traced within run in JAX's HLO interpreter, as
    ``pallas_call(interpret=True)`` runs them in the JAX package's own tests:
    the library flash attention that ``try_flash`` calls takes no
    ``interpret`` argument, so the switch that
    ``pltpu.force_tpu_interpret_mode`` sets to its threaded TPU simulator is
    set to True instead (single-threaded XLA, no host callbacks)."""
    switch = jax_config.pallas_tpu_interpret_mode_context_manager
    prev = switch.swap_local(True)
    try:
        yield
    finally:
        switch.set_local(prev)


def _jax_flash(case, jdt):
    q, k, v, bias, extra, scale = _inputs(case)
    with pallas_interpret():
        out = jfa.try_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                            None if bias is None else jnp.asarray(bias),
                            None if extra is None else jnp.asarray(extra), scale)
    return np.asarray(jnp.asarray(out, jnp.float32))


def _torch_flash(case, tdt):
    q, k, v, bias, extra, scale = _inputs(case)
    t = lambda a, d=tdt: None if a is None else torch.as_tensor(a).to(d)
    return tfa.try_flash(t(q), t(k), t(v), t(bias, torch.float32),
                         t(extra, torch.float32), scale)


@pytest.fixture
def fused_on(monkeypatch):
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", "1")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_try_flash_matches_jax(fused_on, case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    want = _jax_flash(case, jdt)
    got = _torch_flash(case, tdt)
    assert got is not None and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["shaw_extra_padding", "causal_padding"])
def test_sdpa_takes_the_fused_path(fused_on, case):
    """Through ``_sdpa``: the fused path is the plain version of K6 on the
    CPU (no launch), within 1e-5 of the plain matmul + softmax; with the
    option off ``_sdpa`` is the plain path itself."""
    q, k, v, bias, extra, scale = _inputs(case)
    t = lambda a: None if a is None else torch.as_tensor(a)
    before = launch_counts["flash_attention"]
    fused = tattn._sdpa(t(q), t(k), t(v), t(bias), extra_logits=t(extra), scale=scale)
    np.testing.assert_array_equal(
        fused.numpy(), _torch_flash(case, torch.float32).numpy())
    assert launch_counts["flash_attention"] == before
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAMLESS_FUSED_ATTN", "0")
        plain = tattn._sdpa(t(q), t(k), t(v), t(bias), extra_logits=t(extra), scale=scale)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)


# (mode, q shape, k length, bias shape or None, dtype): JAX's eligibility
INELIGIBLE = {
    "option_off": ("0", (1, 2, 256, 16), 256, None, "float32"),
    "option_auto_on_cpu": ("auto", (1, 2, 256, 16), 256, None, "float32"),
    "short_q": ("1", (1, 2, 127, 16), 256, None, "float32"),
    "short_k": ("1", (1, 2, 256, 16), 100, (1, 1, 1, 100), "float32"),
    "rank3_bias": ("1", (1, 2, 256, 16), 256, (1, 256, 256), "float32"),
    "float16": ("1", (1, 2, 256, 16), 256, None, "float16"),
    "rank3_q": ("1", (2, 256, 16), 256, None, "float32"),
}


@pytest.mark.parametrize("case", list(INELIGIBLE))
def test_none_where_jax_returns_none(monkeypatch, case):
    mode, qshape, tk, bshape, dtype = INELIGIBLE[case]
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", mode)
    q = np.ones(qshape, np.float32)
    kv = np.ones(qshape[:-2] + (tk, qshape[-1]), np.float32)
    bias = None if bshape is None else np.zeros(bshape, np.float32)
    j = jfa.try_flash(jnp.asarray(q, dtype), jnp.asarray(kv, dtype), jnp.asarray(kv, dtype),
                      None if bias is None else jnp.asarray(bias), None, 0.25)
    tdt = getattr(torch, dtype)
    t = tfa.try_flash(torch.as_tensor(q).to(tdt), torch.as_tensor(kv).to(tdt),
                      torch.as_tensor(kv).to(tdt),
                      None if bias is None else torch.as_tensor(bias), None, 0.25)
    assert j is None and t is None


def test_bound_counts_the_function():
    """The bound of the v2-large encoder shape at 10 s: 1.02 GFLOP at the fp32
    rate (15.3 us) beats the ~24 MB of bytes; in bf16 the bytes bound it."""
    ms, by = tfl.bound(1, 16, 500, 500, 64, torch.float32, True, True)
    assert by == "operations" and abs(ms - 4 * 16 * 500 * 500 * 64 / 67e12 * 1e3) < 1e-12
    ms, by = tfl.bound(1, 16, 500, 500, 64, torch.bfloat16, True, False)
    nbytes = (2 * 16 * 500 * 64 * 2) * 2 + 16 * 500 * 500 * 2
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12


def test_bound_counts_unmasked_pairs():
    """Masked logits (ab at or below -1e8, unequal segments) need no product:
    a causal ab over 4 keys leaves 10 of 16; segment ids with 3 valid keys
    of 4 leave 12 of 16 in each of 2 heads."""
    causal = torch.triu(torch.full((4, 4), -1e9), diagonal=1)[None, None]
    assert tfl.unmasked_pairs(1, 1, 4, 4, ab=causal) == 10
    seg = torch.tensor([[1, 1, 1, 0]], dtype=torch.int32)
    assert tfl.unmasked_pairs(1, 2, 4, 4, q_seg=torch.ones_like(seg), kv_seg=seg) == 24
    full, _ = tfl.bound(1, 16, 2048, 2048, 64, torch.float32, False, True)
    part, _ = tfl.bound(1, 16, 2048, 2048, 64, torch.float32, False, True,
                        pairs=16 * 2048 * 636)
    assert abs(part / full - 636 / 2048) < 1e-12


def test_kernel_raises_on_what_it_does_not_take():
    """Checked before any launch: a head dim outside {16, 32, 64, 80, 128}, one
    segment array without the other."""
    x = torch.zeros((1, 1, 4, 24))
    with pytest.raises(ValueError, match="head dim"):
        tfl._check(x, x, x, None, None, None)
    x = torch.zeros((1, 1, 4, 16))
    seg = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="both segment"):
        tfl._check(x, x, x, None, seg, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_raises_on_a_misaligned_bias_row(dtype):
    """The kernels read ``ab``'s rows by their stride, and the bf16 kernels
    by TMA, which takes 16-byte aligned rows: a contiguous bias of 150 keys
    (300 or 600 bytes a row) raises, the same values in rows padded to 152
    (``empty_bias``) pass, and so does a contiguous bias of 152 keys."""
    x = torch.zeros((1, 2, 130, 16), dtype=dtype)
    kv = torch.zeros((1, 2, 150, 16), dtype=dtype)
    ab = torch.randn((1, 2, 130, 150)).to(dtype)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfl._check(x, kv, kv, ab, None, None)
    padded = tfl.empty_bias(1, 2, 130, 150, dtype, "cpu")
    padded.copy_(ab)
    assert padded.stride() == (2 * 130 * 152, 130 * 152, 152, 1)
    tfl._check(x, kv, kv, padded, None, None)
    kv152 = torch.zeros((1, 2, 152, 16), dtype=dtype)
    tfl._check(x, kv152, kv152, torch.zeros((1, 2, 130, 152), dtype=dtype), None, None)
    with pytest.raises(ValueError, match="16-byte aligned"):    # keys not contiguous
        tfl._check(x, kv152, kv152, torch.zeros((1, 2, 152, 130), dtype=dtype)
                   .transpose(2, 3), None, None)


@pytest.mark.parametrize("tk", [130, 150])
def test_try_flash_pads_the_bias_rows_in_its_one_copy(fused_on, monkeypatch, tk):
    """``try_flash`` hands the kernel an ``ab`` whose row stride is a
    multiple of 8 elements (16-byte rows for TMA), holding the values of the
    bias plus the extra logits: the [..., :Tk] view of the one buffer it
    materialises, no second copy."""
    seen = {}

    def capture(qs, k, v, ab, q_seg, kv_seg):
        seen["ab"] = ab
        return tfl._reference(qs, k, v, ab, q_seg, kv_seg)

    monkeypatch.setattr(tfa, "flash_attention", capture)
    rng = np.random.default_rng(tk)
    B, H, T, Dh = 2, 2, 140, 16
    q = torch.as_tensor(rng.standard_normal((B, H, T, Dh)), dtype=torch.float32)
    k, v = (torch.as_tensor(rng.standard_normal((B, H, tk, Dh)), dtype=torch.float32)
            for _ in range(2))
    bias = torch.as_tensor(np.where(np.arange(tk) < tk - 9, 0.0, -1e9),
                           dtype=torch.float32).expand(B, 1, T, tk)
    extra = torch.as_tensor(rng.standard_normal((B, H, T, tk)), dtype=torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        out = tfa.try_flash(q.to(dtype), k.to(dtype), v.to(dtype), bias, extra, 0.25)
        assert out is not None
        ab = seen["ab"]
        padded = -(-tk // 8) * 8
        assert ab.shape == (B, H, T, tk) and ab.dtype == dtype
        assert ab.stride() == (H * T * padded, T * padded, padded, 1)
        # the view's storage is the one padded buffer
        assert ab.untyped_storage().nbytes() == B * H * T * padded * ab.element_size()
        torch.testing.assert_close(ab, (extra + bias).to(dtype), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_bias_passes_its_gradient_straight_back(dtype):
    """``padded_bias`` (``try_flash``'s one copy of ``ab``) gives the padded
    rows' view, and its gradient goes back as it came, cast to the bias's
    dtype and summed over the broadcast heads, with no slice of a padded
    buffer in the graph."""
    rng = np.random.default_rng(3)
    bias = torch.as_tensor(rng.standard_normal((2, 1, 5, 130)), dtype=torch.float32)
    bias.requires_grad_()
    ab = tfl.padded_bias(bias.broadcast_to((2, 3, 5, 130)), dtype)
    assert ab.stride() == (3 * 5 * 136, 5 * 136, 136, 1) and ab.dtype == dtype
    assert type(ab.grad_fn).__name__ == "_PaddedBiasBackward"
    torch.testing.assert_close(ab, bias.broadcast_to(ab.shape).to(dtype), rtol=0, atol=0)
    w = torch.as_tensor(rng.standard_normal((2, 3, 5, 130)), dtype=torch.float32)
    (ab.float() * w).sum().backward()
    torch.testing.assert_close(bias.grad, w.to(dtype).float().sum(1, keepdim=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_version_on_card(case, dtype):
    """K6 on the card against its plain version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tdt, tol = DTYPES[dtype]
    q, k, v, bias, extra, scale = _inputs(case)
    dev = torch.device("cuda")
    t = lambda a, d=tdt: None if a is None else torch.as_tensor(a).to(device=dev, dtype=d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAMLESS_FUSED_ATTN", "1")
        before = launch_counts["flash_attention"]
        got = tfa.try_flash(t(q), t(k), t(v), t(bias, torch.float32),
                            t(extra, torch.float32), scale)
        assert launch_counts["flash_attention"] == before + 1
        want = _torch_flash(case, tdt)
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol, atol=tol)
