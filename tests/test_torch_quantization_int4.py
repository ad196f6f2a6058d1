"""The port's group-wise int4 weight-only quantization against the JAX
package's ``ops/quantization.py`` on the CPU: the dequantized weights and
embeddings equal, the products (linear, lookup, tied projection) within the
JAX test's tolerance of 1e-4 of the largest output, ``quantize_params(bits=4,
include=, int4_group=, predicate=)`` quantizing the same leaves with the same
values and keeping tied tables shared, JAX's int4 trees carried across by
``from_jax``, and a tiny_v2 S2TT through the int4 tree giving JAX's
tokens."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.ops import quantization as jq
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch

from seamless_communication_torch.checkpoint.from_jax import (
    to_numpy, unity_params_from_jax,
)
from seamless_communication_torch.ops import quantization as tq


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def dequant_weight(q: np.ndarray, s: np.ndarray) -> np.ndarray:
    G = s.shape[-2]
    g = q.shape[-2] // G
    qf = q.astype(np.float32).reshape(*q.shape[:-2], G, g, q.shape[-1])
    return (qf * s[..., :, None, :]).reshape(q.shape)


def dequant_embedding(q: np.ndarray, s: np.ndarray) -> np.ndarray:
    G = s.shape[-1]
    qf = q.astype(np.float32).reshape(*q.shape[:-1], G, q.shape[-1] // G)
    return (qf * s[..., None]).reshape(q.shape)


@pytest.mark.parametrize("shape,group", [((256, 96), 128), ((200, 64), 128),
                                         ((256, 96), 0)])
def test_weight_int4_equals_jax(shape, group):
    """Values and scales equal; the packed bytes unpack to JAX's int4
    values; the product is within 1e-4 of its largest element."""
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape)) * 0.02
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 3, shape[0])))
    jgroup = group or (1 << 30)
    jqw, js = jq.quantize_weight_int4(jnp.asarray(w), group=jgroup)
    q, s = tq.quantize_weight_int4(t(w), group=jgroup)
    assert q.dtype == torch.int8 and q.shape == (shape[0], shape[1] // 2)
    np.testing.assert_array_equal(tq.unpack_int4(q).numpy(), np.asarray(jqw, np.int8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequant_weight(tq.unpack_int4(q).numpy(), s.numpy()),
                                  dequant_weight(np.asarray(jqw, np.int8), np.asarray(js)))
    b = np.linspace(-1, 1, shape[1]).astype(np.float32)
    want = np.asarray(jq.linear_quantized_int4(
        {"weight_i4": jqw, "scale4": js, "bias": jnp.asarray(b)}, jnp.asarray(x)))
    got = tq.linear_quantized_int4({"weight_i4": q, "scale4": s, "bias": t(b)}, t(x))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(tq.pack_int4(tq.unpack_int4(q)).numpy(), q.numpy())


def test_embedding_int4_lookup_and_tied_projection_equal_jax():
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (300, 256))) * 0.05
    ids = np.array([[3, 299, 0], [17, 17, 42]])
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, 1, 256)))
    jqe, js = jq.quantize_embedding_int4(jnp.asarray(w))
    q, s = tq.quantize_embedding_int4(t(w))
    np.testing.assert_array_equal(tq.unpack_int4(q).numpy(), np.asarray(jqe, np.int8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jp, tp = {"embedding_i4": jqe, "row_scale4": js}, {"embedding_i4": q, "row_scale4": s}
    want = np.asarray(jq.embedding_lookup_quantized_int4(jp, jnp.asarray(ids), scale_mult=16.0))
    got = tq.embedding_lookup_quantized_int4(tp, torch.from_numpy(ids), scale_mult=16.0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy()[0, 0] / 16.0, dequant_embedding(np.asarray(jqe, np.int8),
                                                    np.asarray(js))[3])
    want = np.asarray(jq.tied_projection_quantized_int4(jp, jnp.asarray(x)))
    got = tq.tied_projection_quantized_int4(tp, t(x))
    assert got.shape == want.shape == (2, 1, 300)
    assert np.abs(got.numpy() - want).max() < 1e-4 * np.abs(want).max()


@pytest.fixture(scope="module")
def jparams():
    return junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))


def leaves(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


@pytest.mark.parametrize("kw", [
    dict(bits=4, min_size=1),
    dict(bits=4, min_size=1, int4_group=32, include=("q_proj", "inner_proj")),
    dict(bits=4, min_size=1 << 14, int4_group=0),
    dict(bits=4, predicate=lambda path, leaf: path[-2] == "output_proj"
         and "text_decoder" in path),
    dict(bits=8, min_size=1),
])
def test_quantize_params_equals_jax(jparams, kw):
    """Leaf for leaf in the JAX tree's layout (the layers stacked again, the
    int4 values unpacked); the text encoder's table stays the decoder's."""
    want = jq.quantize_params(jparams, **kw)
    got = tq.quantize_params(unity_params_from_jax(jax.tree.map(np.asarray, jparams)),
                             **kw)
    assert got["text_encoder"]["embed"] is got["text_decoder"]["embed"]
    from seamless_communication_torch.checkpoint.from_jax import unity_params_to_numpy
    w = leaves({k: want[k] for k in ("speech_encoder", "text_decoder", "text_encoder",
                                     "t2u")})
    g = leaves(unity_params_to_numpy(got))
    assert set(w) == set(g), (sorted(set(w) - set(g))[:4], sorted(set(g) - set(w))[:4])
    n4 = 0
    for key, a in w.items():
        if a.dtype.name == "int4":
            a, n4 = a.astype(np.int8), n4 + 1
        np.testing.assert_array_equal(g[key], a, err_msg=key)
    assert (n4 > 0) == (kw["bits"] == 4)
    # the JAX tree's int4 leaves carried over pack to the port's bytes
    if kw["bits"] == 4:
        carried = unity_params_from_jax(jax.tree.map(np.asarray, want))
        layer = carried["text_decoder"]["stack"]["layers"][1]["ffn"]["output_proj"]
        ours = got["text_decoder"]["stack"]["layers"][1]["ffn"]["output_proj"]
        assert set(layer) == set(ours)
        for k in layer:
            assert torch.equal(layer[k], ours[k]), k


def test_stacked_tables_stay_unquantized(jparams):
    """Repaired fault: with a small ``min_size`` the port quantized each
    conformer layer's ``rel_k_embed`` table, which the Shaw attention reads
    as it is (a KeyError at the first speech encode); the JAX package never
    quantizes them (they are 3-d stacked leaves there)."""
    from seamless_communication_torch.models.unity import model as tunity
    from seamless_communication_torch.models.unity.builder import get_arch
    for bits in (8, 4):
        p = tq.quantize_params(unity_params_from_jax(jax.tree.map(np.asarray, jparams)),
                               min_size=1, bits=bits)
        layer = p["speech_encoder"]["encoder"][0]["self_attn"]
        assert set(layer["rel_k_embed"]) == {"embedding"}
        enc = tunity.encode_speech(p, get_arch("tiny_v2"), torch.zeros(1, 128, 80),
                                   torch.tensor([128]))
        assert torch.isfinite(enc.seqs).all()


def test_quantize_params_rejects_bits(jparams):
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        tq.quantize_params({}, bits=2)
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros(3, 5, dtype=torch.int8))
    assert to_numpy({"weight_i4": tq.pack_int4(torch.ones(2, 4, dtype=torch.int8))})[
        "weight_i4"].tolist() == [[1, 1, 1, 1]] * 2


def test_s2tt_through_int4_tree_equals_jax(jparams):
    """tiny_v2 S2TT with every linear and the tied table in int4 (group 32):
    the same tokens and text as the JAX Translator on JAX's int4 tree."""
    from seamless_communication_tpu.inference.generator import (
        SequenceGeneratorOptions as JOptions,
    )
    from seamless_communication_tpu.inference.translator import Translator as JTranslator
    from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
    from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

    from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.text.nllb import NllbTokenizer
    from seamless_communication_torch.text.spm import (
        TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
    )
    words = ["▁the", "▁cat", "▁sat", "▁on", "▁mat", "▁a", "▁dog", "▁he", "llo"]
    blob = build_spm_model([("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
                            ("</s>", 0.0, TYPE_CONTROL)]
                           + [(w, -float(20 - len(w)), TYPE_NORMAL) for w in words])
    langs = ["__eng__", "__fra__"]
    kw = dict(bits=4, min_size=1, int4_group=32)
    jp4 = jq.quantize_params(jparams, **kw)
    tp4 = tq.quantize_params(unity_params_from_jax(jax.tree.map(np.asarray, jparams)),
                             **kw)
    opts = dict(beam_size=2, soft_max_seq_len=(0, 12), hard_max_seq_len=12,
                kv_cache_int8=True)
    jt = JTranslator(jp4, jget_arch("tiny_v2"),
                     JNllbTokenizer(JSpm.from_bytes(blob), langs=langs),
                     text_opts=JOptions(**opts))
    tt = Translator(tp4, get_arch("tiny_v2"),
                    NllbTokenizer(SentencePieceModel.from_bytes(blob), langs=langs),
                    text_opts=SequenceGeneratorOptions(**opts), device="cpu")
    wav = (np.random.default_rng(5).standard_normal(16000 * 2) * 0.1).astype(np.float32)
    fb, fl = tt._audio_to_fbank(wav, 16000)
    from seamless_communication_torch.models.unity import model as tunity
    jenc = jt.generator._encode_speech_fn()(jp4, jnp.asarray(fb), jnp.asarray(fl))
    with torch.inference_mode():
        tenc = tunity.encode_speech(tt.params, tt.cfg, torch.from_numpy(fb),
                                    torch.from_numpy(fl))
        ttok, tlens, _ = tt.generator.generate_text(tenc, "fra")
    jtok, jlens, _ = jt.generator.generate_text(jenc, "fra")
    np.testing.assert_array_equal(tlens, jlens)
    np.testing.assert_array_equal(ttok, jtok)
    assert tt.text_tokenizer.decode(ttok[0, :tlens[0]]) == \
        jt.text_tokenizer.decode(jtok[0, :jlens[0]])
