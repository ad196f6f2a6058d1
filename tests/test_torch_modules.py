"""The port's modules against the JAX package on the same weights, carried
across by ``checkpoint/from_jax.py``, in fp32 on the CPU: the Shaw conformer
speech encoder of ``tiny_v2``, the NLLB text encoder, int8 weight-only
quantization, and the KV-cached decoder step with a beam reorder, int8 and fp
KV."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.models.nllb.model import (
    text_encoder_forward as j_text_encoder_forward,
)
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.models.wav2vec2.encoder import (
    speech_encoder_forward as j_speech_encoder_forward,
)
from seamless_communication_tpu.ops import quantization as jq
from seamless_communication_tpu.ops.modules import conv1d as j_conv1d
from seamless_communication_tpu.ops.positional import (
    apply_sinusoidal_pos as j_apply_sinusoidal_pos,
)
from seamless_communication_tpu.ops.transformer import (
    decoder_cache_init as j_decoder_cache_init,
    transformer_decoder_step as j_transformer_decoder_step,
)

from seamless_communication_torch.checkpoint.from_jax import unity_params_from_jax
from seamless_communication_torch.models.nllb.model import text_encoder_forward
from seamless_communication_torch.models.unity import model as tunity
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.wav2vec2.encoder import speech_encoder_forward
from seamless_communication_torch.ops import quantization as tq
from seamless_communication_torch.ops.modules import conv1d
from seamless_communication_torch.ops.positional import apply_sinusoidal_pos
from seamless_communication_torch.ops.transformer import (
    decoder_cache_init, transformer_decoder_step,
)


@pytest.fixture(scope="module")
def jparams():
    return junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tparams(jparams):
    return unity_params_from_jax(_np_tree(jparams))


def test_bridge_unstacks_layers_and_ties_embedding(jparams, tparams):
    cfg = get_arch("tiny_v2")
    assert len(tparams["speech_encoder"]["encoder"]) == cfg.speech.conformer.num_layers
    layers = tparams["text_decoder"]["stack"]["layers"]
    assert len(layers) == cfg.nllb.num_decoder_layers
    np.testing.assert_array_equal(
        layers[1]["self_attn"]["q_proj"]["weight"].numpy(),
        np.asarray(jparams["text_decoder"]["stack"]["layers"]["self_attn"]["q_proj"]
                   ["weight"][1]))
    assert tparams["text_encoder"]["embed"] is tparams["text_decoder"]["embed"]


@pytest.mark.parametrize("padding,groups,stride,dilation", [
    (pad, *gsd) for pad in ("SAME", "VALID", "CAUSAL", (4, 4))
    for gsd in ((1, 1, 1), (6, 1, 2), (1, 3, 1))
    if not (pad == "CAUSAL" and gsd[1] != 1)])     # causal is used at stride 1
def test_conv1d(padding, groups, stride, dilation):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 17, 6)).astype(np.float32)
    p = {"weight": rng.standard_normal((5, 6 // groups, 6)).astype(np.float32),
         "bias": rng.standard_normal((6,)).astype(np.float32)}
    kw = dict(stride=stride, padding=padding, groups=groups, dilation=dilation)
    want = j_conv1d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), **kw)
    got = conv1d({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sinusoidal_positions():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    want = j_apply_sinusoidal_pos(jnp.asarray(x), padding_mask=jnp.asarray(mask),
                                  padding_idx=0, start_step=3)
    got = apply_sinusoidal_pos(torch.from_numpy(x), padding_mask=torch.from_numpy(mask),
                               padding_idx=0, start_step=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_speech_encoder(jparams, tparams):
    """Shaw conformer stack + adaptor of tiny_v2 within 1e-4, with padding."""
    rng = np.random.default_rng(4)
    fb = rng.standard_normal((2, 96, 80)).astype(np.float32)
    lens = np.array([96, 61], np.int32)
    want, wlens = j_speech_encoder_forward(jparams["speech_encoder"], jnp.asarray(fb),
                                           jnp.asarray(lens), jget_arch("tiny_v2").speech)
    got, glens = speech_encoder_forward(tparams["speech_encoder"], torch.from_numpy(fb),
                                        torch.from_numpy(lens), get_arch("tiny_v2").speech)
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("quantized", [False, True])
def test_text_encoder(jparams, quantized):
    """NLLB text encoder of tiny_v2 (the tied embedding, fp or int8) within
    1e-4, with a padded row; ``encode_text`` returns the same output and
    keeps the lengths."""
    if quantized:
        jparams = jq.quantize_params(jparams, min_size=1)
    tparams = unity_params_from_jax(_np_tree(jparams))
    assert ("embedding_i8" in tparams["text_encoder"]["embed"]) == quantized
    rng = np.random.default_rng(7)
    ids = rng.integers(4, 256, (2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    ids[1, 9:] = 0
    want, wmask = j_text_encoder_forward(jparams["text_encoder"], jnp.asarray(ids),
                                         jnp.asarray(lens), jget_arch("tiny_v2").nllb)
    got, gmask = text_encoder_forward(tparams["text_encoder"], torch.from_numpy(ids),
                                      torch.from_numpy(lens), get_arch("tiny_v2").nllb)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    jenc = junity.encode_text(jparams, jget_arch("tiny_v2"), jnp.asarray(ids),
                              jnp.asarray(lens))
    tenc = tunity.encode_text(tparams, get_arch("tiny_v2"), torch.from_numpy(ids),
                              torch.from_numpy(lens))
    np.testing.assert_allclose(tenc.seqs.numpy(), np.asarray(jenc.seqs), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tenc.lengths.numpy(), lens)


def test_text_encoder_is_drawn_last():
    """The text encoder shares the decoder's table and is drawn after every
    other part, so the other parts are the same draws without it."""
    cfg = get_arch("tiny_v2")
    with_enc = tunity.unity_init(torch.Generator().manual_seed(0), cfg)
    without = tunity.unity_init(torch.Generator().manual_seed(0),
                                dataclasses.replace(cfg, use_text_encoder=False))
    assert set(with_enc) == set(without) | {"text_encoder"}
    assert with_enc["text_encoder"]["embed"] is with_enc["text_decoder"]["embed"]
    assert len(with_enc["text_encoder"]["stack"]["layers"]) == cfg.nllb.num_encoder_layers

    def walk(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert torch.equal(a, b)

    for part in without:
        walk(with_enc[part], without[part])


def test_quantize_params_and_linear_quantized(jparams):
    """int8 weights exactly equal, scales within 1e-7; a small ``min_size``
    quantizes the tiny stacks as the default quantizes v2-large's."""
    qj = jq.quantize_params(jparams, min_size=1 << 12)
    qt = tq.quantize_params(unity_params_from_jax(_np_tree(jparams)), min_size=1 << 12)
    qj_t = unity_params_from_jax(_np_tree(qj))
    n = 0

    def walk(a, b):
        nonlocal n
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            elif isinstance(a[k], list):
                for x, y in zip(a[k], b[k]):
                    walk(x, y)
            elif k in ("weight_i8", "embedding_i8"):
                n += 1
                assert torch.equal(a[k], b[k]), k
            elif k in ("scale", "row_scale"):
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                           atol=1e-7)

    walk(qt["speech_encoder"], qj_t["speech_encoder"])
    walk(qt["text_decoder"], qj_t["text_decoder"])
    assert n > 20
    lp = qt["text_decoder"]["stack"]["layers"][0]["ffn"]["inner_proj"]
    x = np.random.default_rng(5).standard_normal((3, 2, 64)).astype(np.float32)
    want = jq.linear_quantized(jax.tree.map(lambda a: jnp.asarray(a.numpy()), lp),
                               jnp.asarray(x))
    got = tq.linear_quantized(lp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_int8", [True, False])
def test_decoder_step_with_beam_src(jparams, tparams, kv_int8):
    """Three decode steps of the text decoder stack with beam reorders:
    outputs within 1e-4; the per-layer caches written the same."""
    jcfg, tcfg = jget_arch("tiny_v2").nllb.dec_cfg(), get_arch("tiny_v2").nllb.dec_cfg()
    rng = np.random.default_rng(6)
    B, S, Tm = 4, 7, 8
    enc = rng.standard_normal((B, S, 64)).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[1, 5:] = False
    jstack = jax.tree.map(jnp.asarray, jparams["text_decoder"]["stack"])
    jc = j_decoder_cache_init(jstack, jcfg, jnp.asarray(enc), Tm, kv_int8=kv_int8,
                              per_layer=True)
    tc = decoder_cache_init(tparams["text_decoder"]["stack"], tcfg,
                            torch.from_numpy(enc), Tm, kv_int8=kv_int8)
    for step, src in enumerate(([0, 1, 2, 3], [1, 1, 0, 3], [3, 2, 2, 0])):
        x = rng.standard_normal((B, 1, 64)).astype(np.float32)
        src = np.array(src, np.int32)
        jy, jc = j_transformer_decoder_step(jstack, jnp.asarray(x), jc, jnp.int32(step),
                                            jcfg, enc_padding_mask=jnp.asarray(mask),
                                            beam_src=jnp.asarray(src))
        ty, tc = transformer_decoder_step(tparams["text_decoder"]["stack"],
                                          torch.from_numpy(x), tc, step, tcfg,
                                          enc_padding_mask=torch.from_numpy(mask),
                                          beam_src=torch.from_numpy(src))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    for name in ("self_k", "self_v"):
        for a, b in zip(getattr(tc, name), getattr(jc, name)):
            if kv_int8:
                # rows quantized from values equal to ~1e-6 may round apart
                assert np.mean(a.numpy() != np.asarray(b)) < 0.01
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                           atol=1e-4)
