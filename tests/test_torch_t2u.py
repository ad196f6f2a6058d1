"""The port's NAR T2U path against the JAX package in fp32 on the CPU: the
full-sequence re-decode of the text decoder, ``hard_upsample``, the variance
predictor, ``durations_from_log``, ``nar_t2u_forward`` on ``tiny_v2``
parameters carried across by ``checkpoint/from_jax.py``, the host char
frontend, and which T2U weights ``quantize_params`` quantizes.

Float outputs within 1e-4 (the tolerance of the port's other tiny_v2 module
tests: fp32 products summed in another order); integer outputs (lengths,
durations, units, char ids and counts) identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.inference.generator import (
    remove_consecutive_repeated_ngrams as j_remove_ngrams,
)
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity import t2u as jt2u
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.ops import quantization as jq
from seamless_communication_tpu.ops.positional import (
    sinusoidal_positions as j_sinusoidal_positions,
)
from seamless_communication_tpu.ops.upsample import hard_upsample as j_hard_upsample
from seamless_communication_tpu.text.char_frontend import (
    text_to_char_seqs as j_text_to_char_seqs,
)
from seamless_communication_tpu.text.char_tokenizer import CharTokenizer as JCharTokenizer
from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

from seamless_communication_torch.checkpoint.from_jax import to_torch, unity_params_from_jax
from seamless_communication_torch.inference.generator import (
    remove_consecutive_repeated_ngrams,
)
from seamless_communication_torch.models.unity import model as tunity
from seamless_communication_torch.models.unity import t2u as tt2u
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.ops import quantization as tq
from seamless_communication_torch.ops.positional import sinusoidal_positions
from seamless_communication_torch.ops.upsample import hard_upsample
from seamless_communication_torch.text.char_frontend import text_to_char_seqs
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import SentencePieceModel

from test_torch_translator_s2st import CHAR_SPM, LANGS, TEXT_SPM


@pytest.fixture(scope="module")
def jparams():
    return junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))


@pytest.fixture(scope="module")
def tparams(jparams):
    return unity_params_from_jax(jax.tree.map(np.asarray, jparams))


def test_bridge_unstacks_the_t2u(jparams, tparams):
    cfg = get_arch("tiny_v2").nar_t2u
    t2u = tparams["t2u"]
    assert len(t2u["encoder"]["layers"]) == cfg.num_encoder_layers
    assert len(t2u["decoder_layers"]) == cfg.num_decoder_layers
    np.testing.assert_array_equal(
        t2u["decoder_layers"][1]["conv2"]["weight"].numpy(),
        np.asarray(jparams["t2u"]["decoder_layers"]["conv2"]["weight"][1]))


@pytest.mark.parametrize("max_out_len", [5, 12, 40])
def test_hard_upsample(max_out_len):
    """Durations with zeros, and an output shorter than the total: the
    validity mask and the uncapped totals as in the JAX package."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    dur = rng.integers(0, 4, (3, 6)).astype(np.int32)
    dur[2] = 0
    want, wtot = j_hard_upsample(jnp.asarray(x), jnp.asarray(dur), max_out_len)
    got, gtot = hard_upsample(torch.from_numpy(x), torch.from_numpy(dur), max_out_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gtot.numpy(), np.asarray(wtot))


def test_sinusoidal_table():
    want = j_sinusoidal_positions(11, 16, padding_idx=1)
    got = sinusoidal_positions(11, 16, padding_idx=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_variance_predictor_and_durations():
    rng = np.random.default_rng(1)
    p = jax.tree.map(np.asarray, jt2u.variance_predictor_init(jax.random.PRNGKey(3),
                                                              16, 8, 3))
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    want = jt2u.variance_predictor(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                   jnp.asarray(mask))
    got = tt2u.variance_predictor(to_torch(p), torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # log-durations spanning the rounding points, the factor and the minimum
    log_dur = np.log1p(np.array([[0.0, 0.49, 0.5, 1.5, 2.5, 7.3, -0.9, 3.0, 12.0]] * 2,
                                np.float32))
    for factor in (1.0, 1.7):
        want = jt2u.durations_from_log(jnp.asarray(log_dur), jnp.asarray(mask),
                                       duration_factor=factor)
        got = tt2u.durations_from_log(torch.from_numpy(log_dur), torch.from_numpy(mask),
                                      duration_factor=factor)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_redecode_matches_jax(jparams, tparams):
    """The full-sequence text decoder (causal + padding self-attention,
    cross-attention to a padded encoder output) of ``decode_text``."""
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, 9, 64)).astype(np.float32)
    enc_lens = np.array([9, 6], np.int32)
    ids = rng.integers(4, 256, (2, 16)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    want = junity.decode_text(jparams, jget_arch("tiny_v2"), jnp.asarray(ids),
                              junity.EncoderOutput(jnp.asarray(enc), jnp.asarray(enc_lens)),
                              self_lengths=jnp.asarray(lens))
    got = tunity.decode_text(tparams, get_arch("tiny_v2"), torch.from_numpy(ids),
                             tunity.EncoderOutput(torch.from_numpy(enc),
                                                  torch.from_numpy(enc_lens)),
                             self_lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_nar_t2u_forward_matches_jax(jparams, tparams):
    """tiny_v2's NAR T2U on seeded text-decoder features: durations,
    lengths and argmax units identical, logits within 1e-4."""
    rng = np.random.default_rng(4)
    B, T, C = 2, 16, 64
    feats = rng.standard_normal((B, T, 64)).astype(np.float32)
    lens = np.array([15, 9], np.int32)
    counts = np.zeros((B, T), np.int32)
    counts[0, 1:15] = rng.integers(1, 5, 14)
    counts[1, 1:9] = rng.integers(1, 5, 8)
    char_ids = rng.integers(4, 30, (B, C)).astype(np.int32)
    kw = dict(max_unit_len=128)
    want = junity.t2u_nar(jparams, jget_arch("tiny_v2"), jnp.asarray(feats),
                          jnp.asarray(lens), jnp.asarray(char_ids),
                          jnp.asarray(counts), **kw)
    got = tunity.t2u_nar(tparams, get_arch("tiny_v2"), torch.from_numpy(feats),
                         torch.from_numpy(lens), torch.from_numpy(char_ids),
                         torch.from_numpy(counts), **kw)
    for name in ("durations", "unit_lengths", "char_lengths"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.unit_logits.numpy(), np.asarray(want.unit_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.unit_logits.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(want.unit_logits, -1)))


def test_text_to_char_seqs_matches_jax():
    """Shifted alignment (``char_counts[b, 1:1+n]``), unk, punctuation that
    absorbs the next subword's space, EOS and pads."""
    jtok = JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS)
    ttok = NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS)
    jchar = JCharTokenizer(JSpm.from_bytes(CHAR_SPM))
    tchar = CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM))
    seqs = [ttok.encode_target("the cat sat. on a mat, hello world", "fra"),
            ttok.encode_target("a dog", "fra")]
    arr = np.zeros((3, 24), np.int32)
    for i, s in enumerate(seqs):
        arr[i, :len(s)] = s
    arr[2, :6] = [3, ttok.lang_token("eng"), 1, 200, 9, 3]       # unk, out-of-vocab id
    for max_char_len in (64, 20):
        want = j_text_to_char_seqs(jtok, jchar, arr, max_char_len=max_char_len)
        got = text_to_char_seqs(ttok, tchar, arr, max_char_len=max_char_len)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert got[2][0, 0] == 0 and got[2][0, 1] > 0


def test_quantize_params_counts_the_t2u_stacks(jparams, tparams):
    """A per-layer FFT weight below ``min_size`` whose stack of layers is
    above it quantizes in both packages (the JAX tree stacks the layers), and
    the int8 weights are equal."""
    w = tparams["t2u"]["decoder_layers"][0]["self_attn"]["q_proj"]["weight"]
    min_size = w.numel() + 1
    assert w.numel() * len(tparams["t2u"]["decoder_layers"]) >= min_size
    qj = unity_params_from_jax(jax.tree.map(np.asarray, jq.quantize_params(
        jparams, min_size=min_size)))["t2u"]
    qt = tq.quantize_params(tparams, min_size=min_size)["t2u"]
    picked = []

    def walk(a, b, path):
        assert a.keys() == b.keys(), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + [k])
            elif isinstance(a[k], list):
                for i, (x, y) in enumerate(zip(a[k], b[k])):
                    walk(x, y, path + [k, str(i)])
            elif k in ("weight_i8", "embedding_i8"):
                picked.append("/".join(path))
                assert torch.equal(a[k], b[k]), path

    walk(qt, qj, [])
    assert "decoder_layers/0/self_attn/q_proj" in picked
    assert "encoder/layers/1/ffn/inner_proj" in picked
    assert not any("conv" in p or "final_proj" in p for p in picked)


@pytest.mark.parametrize("seq", [[], [5], [1, 1, 1, 2], [3, 4, 3, 4, 3, 4, 5, 5, 6],
                                 [7, 8, 9, 7, 8, 9, 7, 1, 2, 1, 2, 2]])
def test_remove_consecutive_repeated_ngrams(seq):
    """The n-gram filter of the units, unigrams to long repeats."""
    assert remove_consecutive_repeated_ngrams(seq) == j_remove_ngrams(seq)
