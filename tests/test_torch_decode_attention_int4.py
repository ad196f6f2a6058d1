"""The port's packed-int4 KV decode step against the JAX package: the
pack/unpack helpers bit for bit over every (lo, hi) pair; the plain version
``_reference_int4`` against JAX ``_reference_int4`` and against the Pallas
kernel run in interpret mode; the int4 decoder step of a transformer stack.

Tolerances: ``out`` within 2e-5 relative and absolute, the JAX kernel test's
(the logits are a low-half plus a high-half sum, taken in another order);
new caches and scales exactly equal to eager JAX. Under ``jit`` XLA rewrites
``absmax / 7`` into a product with the reciprocal, so the interpret-mode
kernel writes scales up to one ulp off: held within one ulp. A one-ulp scale
moves ``x / scale`` by about one ulp, which changes a packed nibble only where
``x / scale`` lies within an ulp of a half-integer; on these inputs no nibble
changes, so the packed bytes are held exactly equal there too."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.ops import attention as ja
from seamless_communication_tpu.ops.kernels import decode_attention as jda
from seamless_communication_tpu.ops.transformer import (
    decoder_cache_init as j_decoder_cache_init,
    transformer_decoder_step as j_transformer_decoder_step,
)

from seamless_communication_torch.checkpoint.from_jax import unity_params_from_jax
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.ops import attention as ta
from seamless_communication_torch.ops.kernels import decode_attention as tda
from seamless_communication_torch.ops.kernels import launch_counts
from seamless_communication_torch.ops.transformer import (
    DecoderCacheQ4, decoder_cache_init, transformer_decoder_step,
)

B, H, T, Dh = 5, 4, 24, 8


def test_pack_unpack_every_pair():
    """All 225 (lo, hi) pairs of [-7, 7]: rows [lo, 7, hi, 0] quantize with
    scale 1 to exactly those values; the packed bytes, the scales and the
    unpacked halves equal the JAX helpers'."""
    vals = np.asarray(np.meshgrid(np.arange(-7, 8), np.arange(-7, 8))).reshape(2, -1).T
    x = np.zeros((225, 4), np.float32)
    x[:, 0], x[:, 1], x[:, 2] = vals[:, 0], 7, vals[:, 1]
    jp, js = ja.quantize_kv_rows_int4(jnp.asarray(x))
    tp, ts = ta.quantize_kv_rows_int4(torch.from_numpy(x))
    assert tp.dtype == torch.int8 and tuple(tp.shape) == (225, 2)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    lo, hi = ta.unpack_int4(tp)
    np.testing.assert_array_equal(lo.numpy()[:, 0], vals[:, 0])
    np.testing.assert_array_equal(hi.numpy()[:, 0], vals[:, 1])
    for g, w in zip((lo, hi), ja.unpack_int4(jp)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # every byte value, the -8 nibbles of foreign caches included
    every = np.arange(-128, 128, dtype=np.int8)
    for g, w in zip(ta.unpack_int4(torch.from_numpy(every)),
                    ja.unpack_int4(jnp.asarray(every))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return dict(
        q=rng.standard_normal((B, H, Dh)).astype(np.float32),
        kt=rng.standard_normal((B, H, Dh)).astype(np.float32),
        vt=rng.standard_normal((B, H, Dh)).astype(np.float32),
        kc=rng.integers(-128, 128, (B, H, T, Dh // 2)).astype(np.int8),
        vc=rng.integers(-128, 128, (B, H, T, Dh // 2)).astype(np.int8),
        ks=(rng.random((B, H, T)) * 0.1 + 0.01).astype(np.float32),
        vs=(rng.random((B, H, T)) * 0.1 + 0.01).astype(np.float32),
        src=np.array([3, 0, 3, 1, 1], np.int32),      # repeated origins
    )


def _args(d, step, lib):
    names = ("q", "kt", "vt", "kc", "vc", "ks", "vs")
    if lib == "jax":
        return (*(jnp.asarray(d[n]) for n in names), jnp.int32(step),
                jnp.asarray(d["src"]))
    return (*(torch.from_numpy(d[n]) for n in names), step, torch.from_numpy(d["src"]))


@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("step", [0, 5, T - 1])
def test_reference_int4_matches_jax(data, step, against):
    jargs = _args(data, step, "jax")
    want = (jda._reference_int4(*jargs) if against == "reference" else
            jda.fused_decode_self_attention_int4(*jargs, use_pallas=True,
                                                 interpret=True))
    got = tda._reference_int4(*_args(data, step, "torch"))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-5, atol=2e-5)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rtol = 0.0 if against == "reference" else 2.0 ** -23
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=0)


def test_cpu_tensors_take_the_plain_version(data):
    """On CPU tensors the wrapper computes ``_reference_int4`` and launches
    nothing."""
    before = dict(launch_counts)
    args = _args(data, 7, "torch")
    got = tda.fused_decode_self_attention_int4(*args)
    for g, w in zip(got, tda._reference_int4(*args)):
        assert torch.equal(g, w)
    assert launch_counts == before


def test_attention_step_matches_jax(data):
    """``self_attention_step_nocache_int4`` (the plain decoder path) against
    JAX on random projections: y within 1e-5, the packed row exact."""
    rng = np.random.default_rng(3)
    p = {n: {"weight": rng.standard_normal((H * Dh, H * Dh)).astype(np.float32) * 0.2,
             "bias": rng.standard_normal((H * Dh,)).astype(np.float32) * 0.1}
         for n in ("q_proj", "k_proj", "v_proj", "output_proj")}
    x = rng.standard_normal((B, 1, H * Dh)).astype(np.float32)
    d = data
    want = ja.self_attention_step_nocache_int4(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), *(jnp.asarray(d[n]) for n in
                                                        ("kc", "vc", "ks", "vs")),
        jnp.int32(9), H)
    got = ta.self_attention_step_nocache_int4(
        jax.tree.map(torch.from_numpy, p), torch.from_numpy(x),
        *(torch.from_numpy(d[n]) for n in ("kc", "vc", "ks", "vs")), 9, H)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bound_bytes_int4_counts_each_byte_once():
    # packed rows are Dh/2 bytes: distinct source beams read once, B written
    assert tda.bound_bytes(5, 16, 320, 64, n_src=3, elem=4, bits=4) == (
        (3 + 5) * 16 * 320 * (64 + 8) + 4 * 5 * 16 * 64 * 4 + 4 * 5)


def test_decoder_step_int4_with_beam_src():
    """Three decode steps of the tiny_v2 text decoder stack over a
    ``DecoderCacheQ4`` with beam reorders, against JAX's per-layer int4 step:
    outputs within 1e-4, nearly all packed bytes equal (a row quantized from
    values equal to ~1e-6 may round apart)."""
    jparams = junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))
    tstack = unity_params_from_jax(jax.tree.map(np.asarray, jparams)
                                   )["text_decoder"]["stack"]
    jstack = jparams["text_decoder"]["stack"]
    jcfg, tcfg = jget_arch("tiny_v2").nllb.dec_cfg(), get_arch("tiny_v2").nllb.dec_cfg()
    rng = np.random.default_rng(6)
    Bm, S, Tm = 4, 7, 8
    enc = rng.standard_normal((Bm, S, 64)).astype(np.float32)
    mask = np.ones((Bm, S), bool)
    mask[1, 5:] = False
    jc = j_decoder_cache_init(jstack, jcfg, jnp.asarray(enc), Tm, kv_int8=True,
                              per_layer=True, kv_bits=4)
    tc = decoder_cache_init(tstack, tcfg, torch.from_numpy(enc), Tm, kv_int8=True,
                            kv_bits=4)
    assert isinstance(tc, DecoderCacheQ4) and tuple(tc.self_k[0].shape) == (Bm, 4, Tm, 8)
    for step, src in enumerate(([0, 1, 2, 3], [1, 1, 0, 3], [3, 2, 2, 0])):
        x = rng.standard_normal((Bm, 1, 64)).astype(np.float32)
        src = np.array(src, np.int32)
        jy, jc = j_transformer_decoder_step(jstack, jnp.asarray(x), jc, jnp.int32(step),
                                            jcfg, enc_padding_mask=jnp.asarray(mask),
                                            beam_src=jnp.asarray(src))
        ty, tc = transformer_decoder_step(tstack, torch.from_numpy(x), tc, step, tcfg,
                                          enc_padding_mask=torch.from_numpy(mask),
                                          beam_src=torch.from_numpy(src))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    for name in ("self_k", "self_v"):
        for a, b in zip(getattr(tc, name), getattr(jc, name)):
            assert np.mean(a.numpy() != np.asarray(b)) < 0.01
    for name in ("self_k_scale", "self_v_scale"):
        for a, b in zip(getattr(tc, name), getattr(jc, name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(dtype):
    """The CUDA kernel against its plain version at the main-path shape:
    caches and scales bit-equal, ``out`` within 2e-5 (fp32) or 1.6e-2
    (bf16, the int8 kernel's tolerance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    Bm, Hm, Tm, Dm = 5, 16, 320, 64
    dev = torch.device("cuda")
    t = lambda a, d: torch.as_tensor(a).to(device=dev, dtype=d)
    vecs = [t(rng.standard_normal((Bm, Hm, Dm)), dt) for _ in range(3)]
    # caches as the decoder fills them: unit-variance rows, quantized
    (kq, ks), (vq, vs) = (ta.quantize_kv_rows_int4(
        t(rng.standard_normal((Bm, Hm, Tm, Dm)), torch.float32)) for _ in range(2))
    src = t(np.array([3, 0, 3, 1, 1]), torch.int32)
    for step in (0, 1, 137, Tm - 1):
        args = (*vecs, kq, vq, ks, vs, step, src)
        got = tda.fused_decode_self_attention_int4(*args)
        want = tda._reference_int4(*args)
        tol = 2e-5 if dt == torch.float32 else 1.6e-2
        torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol, atol=tol)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w)
