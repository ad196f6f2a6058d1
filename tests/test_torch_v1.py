"""The v1 modules of the port against the JAX package in fp32 on the CPU, on
``tiny_v1`` parameters carried across by ``checkpoint/from_jax.py`` (its
random u/v biases and folded batch norms made nonzero first): the XL
relative-position table and the factorised relative bias, XL
self-attention and the v1 conformer layer and speech encoder with the
fused-attention option off and on (the JAX library kernel in interpret
mode, the port's K6 in its plain version), the AR T2U's encoder and its
KV-cached decoder step with beam reorders (int8 and fp KV), and the AR
unit tokenizer.

Float outputs within 1e-4 (the port's other tiny module tests: fp32
products summed in other orders); integer outputs identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity import t2u as jt2u
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.models.unity.unit_tokenizer import (
    UnitTokenizer as JUnitTokenizer,
)
from seamless_communication_tpu.models.wav2vec2.encoder import (
    speech_encoder_forward as j_speech_encoder_forward,
)
from seamless_communication_tpu.ops import attention as jattn
from seamless_communication_tpu.ops import conformer as jconf
from seamless_communication_tpu.ops.masks import padding_bias as j_padding_bias

from seamless_communication_torch.checkpoint.from_jax import unity_params_from_jax
from seamless_communication_torch.models.unity import t2u as tt2u
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.unity.model import unity_init
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.models.wav2vec2.encoder import speech_encoder_forward
from seamless_communication_torch.ops import attention as tattn
from seamless_communication_torch.ops import conformer as tconf
from seamless_communication_torch.ops.masks import padding_bias
from tests.test_torch_flash_attention import pallas_interpret

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jparams():
    """tiny_v1 with random u/v biases and batch-norm affines (the init leaves
    them 0 and 1, which would hide a misplaced term)."""
    params = junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v1"))
    rng = np.random.default_rng(11)
    layers = params["speech_encoder"]["encoder"]
    for path in (("self_attn", "u_bias"), ("self_attn", "v_bias"),
                 ("conv", "norm", "scale"), ("conv", "norm", "bias")):
        node = layers
        for key in path[:-1]:
            node = node[key]
        shape = node[path[-1]].shape
        node[path[-1]] = jnp.asarray(rng.standard_normal(shape) * 0.5 + (
            1.0 if path[-1] == "scale" else 0.0), jnp.float32)
    return params


@pytest.fixture(scope="module")
def tparams(jparams):
    return unity_params_from_jax(jax.tree.map(np.asarray, jparams))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_bridge_carries_the_v1_trees(jparams, tparams):
    cfg = get_arch("tiny_v1")
    sa = tparams["speech_encoder"]["encoder"][1]["self_attn"]
    assert set(sa) == {"q_proj", "k_proj", "v_proj", "output_proj", "r_proj", "u_bias",
                       "v_bias"}
    np.testing.assert_array_equal(
        sa["u_bias"].numpy(),
        np.asarray(jparams["speech_encoder"]["encoder"]["self_attn"]["u_bias"][1]))
    t2u = tparams["t2u"]
    assert set(t2u) == {"encoder", "embed", "decoder"}
    assert len(t2u["decoder"]["layers"]) == cfg.ar_t2u.num_decoder_layers
    assert "cross_attn" in t2u["decoder"]["layers"][0]
    # the port draws the same tree shapes
    own = unity_init(torch.Generator().manual_seed(0), cfg)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes(own["t2u"]) == shapes(t2u)
    assert shapes(own["speech_encoder"]) == shapes(tparams["speech_encoder"])


def test_xl_rel_table():
    np.testing.assert_allclose(tattn.xl_rel_table(9, 16).numpy(),
                               np.asarray(jattn.xl_rel_table(9, 16)), rtol=1e-6, atol=1e-6)


def test_xl_rel_bias():
    rng = np.random.default_rng(1)
    qv = rng.standard_normal((2, 4, 37, 16)).astype(np.float32)
    w_r = (rng.standard_normal((64, 64)) * 0.125).astype(np.float32)
    want = jattn._xl_rel_bias(jnp.asarray(qv), jnp.asarray(w_r))
    got = tattn._xl_rel_bias(torch.from_numpy(qv), torch.from_numpy(w_r))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _x_and_mask(T=150, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T, 64)).astype(np.float32)
    mask = np.ones((2, T), bool)
    mask[1, 100:] = False                  # a row shorter than 128
    return x, mask


@pytest.mark.parametrize("fused", ["0", "1"])
def test_xl_self_attention(jparams, tparams, monkeypatch, fused):
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", fused)
    x, mask = _x_and_mask()
    jp = _layer(jparams["speech_encoder"]["encoder"], 0)["self_attn"]
    with pallas_interpret():
        want = jattn.xl_self_attention(jp, jnp.asarray(x), 4,
                                       bias=j_padding_bias(jnp.asarray(mask)))
    got = tattn.xl_self_attention(tparams["speech_encoder"]["encoder"][0]["self_attn"],
                                  torch.from_numpy(x), 4,
                                  bias=padding_bias(torch.from_numpy(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_conformer_layer_v1(jparams, tparams, monkeypatch, fused):
    """One XL / SAME-conv / batch-norm layer, with padding."""
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", fused)
    x, mask = _x_and_mask(seed=3)
    jcfg, tcfg = jget_arch("tiny_v1").speech.conformer, get_arch("tiny_v1").speech.conformer
    with pallas_interpret():
        want = jconf.conformer_layer(_layer(jparams["speech_encoder"]["encoder"], 1),
                                     jnp.asarray(x), jcfg,
                                     attn_bias=j_padding_bias(jnp.asarray(mask)),
                                     padding_mask=jnp.asarray(mask))
    got = tconf.conformer_layer(tparams["speech_encoder"]["encoder"][1],
                                torch.from_numpy(x), tcfg,
                                attn_bias=padding_bias(torch.from_numpy(mask)),
                                padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_speech_encoder_v1(jparams, tparams, monkeypatch, fused):
    """The tiny_v1 speech encoder (XL conformer stack + adaptor) on 300 and
    220 fbank frames: 150 conformer frames, so the option reaches it."""
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", fused)
    rng = np.random.default_rng(4)
    fb = rng.standard_normal((2, 300, 80)).astype(np.float32)
    lens = np.array([300, 220], np.int32)
    with pallas_interpret():
        want, wlens = j_speech_encoder_forward(jparams["speech_encoder"], jnp.asarray(fb),
                                               jnp.asarray(lens), jget_arch("tiny_v1").speech)
    got, glens = speech_encoder_forward(tparams["speech_encoder"], torch.from_numpy(fb),
                                        torch.from_numpy(lens), get_arch("tiny_v1").speech)
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conformer_pos_type_none():
    """The attention-free-of-positions variant (plain MHA) runs too."""
    cfg = tconf.ConformerConfig(dim=16, ffn_inner_dim=32, num_heads=2, num_layers=1,
                                depthwise_kernel_size=3, pos_type="none")
    gen = torch.Generator().manual_seed(0)
    layers = tconf.conformer_stack_init(gen, cfg)
    assert "rel_k_embed" not in layers[0]["self_attn"]
    out = tconf.conformer_encoder(layers, torch.randn((1, 5, 16), generator=gen), cfg)
    assert out.shape == (1, 5, 16) and bool(torch.isfinite(out).all())


def test_ar_t2u_encode(jparams, tparams):
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 12, 64)).astype(np.float32)
    lens = np.array([12, 7], np.int32)
    jcfg, tcfg = jget_arch("tiny_v1").ar_t2u, get_arch("tiny_v1").ar_t2u
    want, wmask = jt2u.ar_t2u_encode(jparams["t2u"], jcfg, jnp.asarray(feats),
                                     jnp.asarray(lens))
    got, gmask = tt2u.ar_t2u_encode(tparams["t2u"], tcfg, torch.from_numpy(feats),
                                    torch.from_numpy(lens))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_int8", [True, False])
def test_ar_t2u_decoder_step(jparams, tparams, kv_int8):
    """Four unit decode steps from [eos, lang] with beam reorders: logits
    within 1e-4 at every step."""
    jcfg, tcfg = jget_arch("tiny_v1").ar_t2u, get_arch("tiny_v1").ar_t2u
    rng = np.random.default_rng(6)
    B, S, Tm = 4, 9, 8
    enc = rng.standard_normal((B, S, 64)).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[2, 6:] = False
    jc = jt2u.ar_t2u_cache(jparams["t2u"], jcfg, jnp.asarray(enc), Tm, kv_int8)
    tc = tt2u.ar_t2u_cache(tparams["t2u"], tcfg, torch.from_numpy(enc), Tm, kv_int8)
    toks = ([2, 2, 2, 2], [105, 105, 105, 105], [7, 9, 7, 40], [11, 3, 60, 9])
    srcs = ([0, 1, 2, 3], [0, 1, 2, 3], [1, 1, 0, 3], [3, 2, 2, 0])
    for step, (tok, src) in enumerate(zip(toks, srcs)):
        tok = np.array(tok, np.int32)[:, None]
        src = np.array(src, np.int32)
        jl, jc = jt2u.ar_t2u_decoder_step(jparams["t2u"], jnp.asarray(tok), jc,
                                          jnp.int32(step), jcfg,
                                          enc_padding_mask=jnp.asarray(mask),
                                          beam_src=jnp.asarray(src))
        tl, tc = tt2u.ar_t2u_decoder_step(tparams["t2u"], torch.from_numpy(tok).long(), tc,
                                          step, tcfg, enc_padding_mask=torch.from_numpy(mask),
                                          beam_src=torch.from_numpy(src))
        assert tl.shape == (B, tcfg.unit_vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_ar_unit_tokenizer():
    """The AR ("base") unit vocabulary: two language blocks, the second's
    index for the prefix, [eos, lang] + units + 4 encoded, the lang symbol
    kept raw at position 0 of a decode."""
    j, t = JUnitTokenizer(100, ["eng"], "base"), UnitTokenizer(100, ["eng"], "base")
    assert not t.is_nar_decoder and t.lang_symbol_repetitions == 2
    assert t.vocab_size == j.vocab_size == 108
    assert t.lang_to_index("eng") == j.lang_to_index("eng") == 106
    assert t.index_to_lang(106) == j.index_to_lang(106) == "eng"
    units = np.array([[5, 99, 0, 120], [1, 2, 3, 4]])
    enc = t.encode(units, "eng")
    np.testing.assert_array_equal(enc, j.encode(units, "eng"))
    assert enc[0, :2].tolist() == [2, 106]
    hyp = np.concatenate([enc, np.full((2, 1), 2)], axis=1)
    np.testing.assert_array_equal(t.decode(hyp), j.decode(hyp))
    assert t.decode(hyp)[0, 0] == 106
