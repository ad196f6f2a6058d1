"""The port's SeamlessExpressive model half against the JAX package in fp32
on the CPU: ``gaussian_upsample`` (a 0-duration EOS unit included), FiLM,
the NAR T2U with the prosody projection and FiLM (forward and the
teacher-forced train pass), the NLLB's tanh GELU, the ECAPA-TDNN
embedding, ``encode_prosody``, the ``expressivity_v2`` and
``tiny_expressive`` archs, and ``Translator.predict(...,
prosody_encoder_input=)`` on ``tiny_expressive``, the JAX parameters carried
across by ``checkpoint/from_jax.py``.

Floats within 1e-5 (fp32 products of two libraries summed in other orders);
tokens, units, durations and lengths identical. Every random input comes
from numpy's seeded generators."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.inference.generator import (
    SequenceGeneratorOptions as JOptions,
)
from seamless_communication_tpu.inference.translator import Translator as JTranslator
from seamless_communication_tpu.models.nllb import model as jnllb
from seamless_communication_tpu.models.pretssel import ecapa_tdnn as jecapa
from seamless_communication_tpu.models.unity import film as jfilm
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity import t2u as jt2u
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.models.unity.unit_tokenizer import (
    UnitTokenizer as JUnitTokenizer,
)
from seamless_communication_tpu.ops.upsample import gaussian_upsample as j_gaussian_upsample
from seamless_communication_tpu.text.char_tokenizer import CharTokenizer as JCharTokenizer
from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

from seamless_communication_torch.checkpoint.from_jax import (
    to_torch, unity_params_from_jax, unity_params_to_numpy,
)
from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
from seamless_communication_torch.inference.translator import Translator
from seamless_communication_torch.models.nllb import model as tnllb
from seamless_communication_torch.models.pretssel import ecapa_tdnn as tecapa
from seamless_communication_torch.models.unity import film as tfilm
from seamless_communication_torch.models.unity import model as tunity
from seamless_communication_torch.models.unity import t2u as tt2u
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.ops.upsample import gaussian_upsample
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import SentencePieceModel

from test_torch_translator_s2st import CHAR_SPM, LANGS, TEXT_SPM

TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tiny ops on one intra-op thread while the file runs: the
    suite runs six workers at once, and torch's default of a thread a core in
    each of them slows these files several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
ARCH = "tiny_expressive"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def jparams():
    return junity.unity_init(jax.random.PRNGKey(3), jget_arch(ARCH))


@pytest.fixture(scope="module")
def tparams(jparams):
    return unity_params_from_jax(_np(jparams))


@pytest.mark.parametrize("case", ["eos_zero", "no_mask", "padded"])
def test_gaussian_upsample(case):
    """Durations with a trailing 0-duration EOS unit (masked by the padding
    mask only, so it keeps weight), the default mask (durations > 0), and a
    padded second row whose total is short of ``max_out_len``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    d = rng.integers(1, 5, (2, 9)).astype(np.int32)
    lens = np.array([9, 6], np.int32)
    d[0, 8] = 0                                  # the EOS unit
    d[1, 6:] = 0
    mask = np.arange(9)[None] < lens[:, None]
    kw = {} if case == "no_mask" else dict(src_mask=mask)
    M = 40 if case == "padded" else int(d.sum(1).max())
    jo, jt = j_gaussian_upsample(jnp.asarray(x), jnp.asarray(d), M,
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    to, tt = gaussian_upsample(_t(x), _t(d), M, **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt.dtype == torch.int32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    if case == "eos_zero":
        # the EOS unit of duration 0 still weighs on the last frames
        w_eos = gaussian_upsample(torch.eye(9)[None], _t(d[:1]), M,
                                  src_mask=_t(mask[:1]))[0][0, :, 8]
        assert float(w_eos[-1]) > 0.1


def test_film():
    rng = np.random.default_rng(1)
    jp = jfilm.film_init(jax.random.PRNGKey(0), 12, 8)
    jp = dict(jp, s_gamma=jnp.asarray([0.7]), s_beta=jnp.asarray([1.3]))
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    cond = rng.standard_normal((2, 1, 12)).astype(np.float32)
    want = jfilm.film(jp, jnp.asarray(x), jnp.asarray(cond))
    got = tfilm.film(to_torch(_np(jp)), _t(x), _t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    init = tfilm.film_init(torch.Generator().manual_seed(0), 12, 8)
    assert init["proj"]["weight"].shape == (12, 16)
    assert float(init["s_gamma"]) == float(init["s_beta"]) == 1.0


def _t2u_inputs(seed: int):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, 6, 64)).astype(np.float32)
    lens = np.array([6, 4], np.int32)
    char_ids = rng.integers(4, 64, (2, 24)).astype(np.int32)
    counts = rng.integers(1, 4, (2, 6)).astype(np.int32)
    counts[1, 4:] = 0
    prosody = rng.standard_normal((2, 1, 32)).astype(np.float32)
    return feats, lens, char_ids, counts, prosody


@pytest.mark.parametrize("seed", [0, 1])
def test_nar_t2u_with_prosody(jparams, tparams, seed):
    """The expressive NAR T2U: prosody projection on the encoder output,
    FiLM in the duration predictor and every FFT layer. A second prosody
    embedding changes the durations or the units in both packages."""
    cfg = jget_arch(ARCH).nar_t2u
    feats, lens, char_ids, counts, prosody = _t2u_inputs(seed)
    outs = []
    jforward = jax.jit(lambda *a: jt2u.nar_t2u_forward(
        jparams["t2u"], cfg, *a[:4], max_unit_len=96, prosody_embed=a[4], film_cond=a[4]))
    for p in (prosody, prosody[::-1].copy() * 3.0):
        jo = jforward(*map(jnp.asarray, (feats, lens, char_ids, counts, p)))
        to = tt2u.nar_t2u_forward(tparams["t2u"], get_arch(ARCH).nar_t2u, *map(_t, (
            feats, lens, char_ids, counts)), max_unit_len=96, prosody_embed=_t(p),
            film_cond=_t(p))
        np.testing.assert_array_equal(to.durations.numpy(), np.asarray(jo.durations))
        np.testing.assert_array_equal(to.unit_lengths.numpy(), np.asarray(jo.unit_lengths))
        np.testing.assert_array_equal(to.unit_logits.argmax(-1).numpy(),
                                      np.asarray(jo.unit_logits).argmax(-1))
        np.testing.assert_allclose(to.unit_logits.numpy(), np.asarray(jo.unit_logits),
                                   **TOL)
        outs.append((np.asarray(jo.durations), np.asarray(jo.unit_logits).argmax(-1),
                     to.durations.numpy(), to.unit_logits.argmax(-1).numpy()))
    (jd0, ju0, td0, tu0), (jd1, ju1, td1, tu1) = outs
    assert not (np.array_equal(jd0, jd1) and np.array_equal(ju0, ju1))
    assert not (np.array_equal(td0, td1) and np.array_equal(tu0, tu1))


def test_nar_t2u_train_with_prosody(jparams, tparams):
    cfg = jget_arch(ARCH).nar_t2u
    feats, lens, char_ids, counts, prosody = _t2u_inputs(2)
    gt = np.random.default_rng(3).integers(0, 4, (2, 24)).astype(np.int32)
    jo = jax.jit(lambda *a: jt2u.nar_t2u_train(
        jparams["t2u"], cfg, *a[:5], max_unit_len=64, prosody_embed=a[5], film_cond=a[5]))(
        *map(jnp.asarray, (feats, lens, char_ids, counts, gt, prosody)))
    to = tt2u.nar_t2u_train(tparams["t2u"], get_arch(ARCH).nar_t2u, *map(_t, (
        feats, lens, char_ids, counts, gt)), max_unit_len=64, prosody_embed=_t(prosody),
        film_cond=_t(prosody))
    np.testing.assert_array_equal(to.unit_lengths.numpy(), np.asarray(jo.unit_lengths))
    np.testing.assert_array_equal(to.char_mask.numpy(), np.asarray(jo.char_mask))
    np.testing.assert_allclose(to.log_dur_pred.numpy(), np.asarray(jo.log_dur_pred), **TOL)
    np.testing.assert_allclose(to.unit_logits.numpy(), np.asarray(jo.unit_logits), **TOL)


def test_gelu_decoder_is_jax_tanh_gelu(jparams, tparams):
    """The expressive NLLB's FFN activation is JAX's default (tanh) GELU:
    the full-sequence decoder matches within 1e-5, and the exact (erf) GELU
    would not."""
    ncfg = jget_arch(ARCH).nllb
    assert ncfg.activation == get_arch(ARCH).nllb.activation == "gelu"
    rng = np.random.default_rng(4)
    ids = rng.integers(4, 256, (2, 7)).astype(np.int32)
    enc = rng.standard_normal((2, 9, 64)).astype(np.float32)
    want = jnllb.text_decoder_forward(jparams["text_decoder"], jnp.asarray(ids),
                                      jnp.asarray(enc), ncfg)
    got = tnllb.text_decoder_forward(tparams["text_decoder"], _t(ids).long(), _t(enc),
                                     get_arch(ARCH).nllb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = torch.linspace(-3, 3, 13)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(x, approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))), rtol=0, atol=1e-6)
    assert float((torch.nn.functional.gelu(x) - torch.nn.functional.gelu(
        x, approximate="tanh")).abs().max()) > 1e-4


ECAPA_CFGS = {
    "tiny_expressive": jget_arch(ARCH).ecapa,
    # widths that differ between blocks (a shortcut conv), no global context
    "shortcut_no_context": jecapa.EcapaConfig(channels=(24, 32, 32, 24, 64),
                                              attention_channels=8, res2net_scale=4,
                                              se_channels=8, global_context=False,
                                              embed_dim=16),
}


@pytest.mark.parametrize("name", list(ECAPA_CFGS))
def test_ecapa_forward(name):
    jcfg = ECAPA_CFGS[name]
    tcfg = tecapa.EcapaConfig(**jcfg._asdict())
    jp = jax.jit(jecapa.ecapa_init, static_argnums=1)(jax.random.PRNGKey(5), jcfg)
    assert ("shortcut" in jp["blocks"][1]) == (name == "shortcut_no_context")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 37, 80)).astype(np.float32)
    mask = np.arange(37)[None] < np.array([37, 21])[:, None]
    jforward = jax.jit(lambda p, x, m: jecapa.ecapa_forward(p, x, jcfg, padding_mask=m))
    want = jforward(jp, jnp.asarray(x), jnp.asarray(mask))
    got = tecapa.ecapa_forward(to_torch(_np(jp)), _t(x), tcfg, padding_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, rtol=1e-5)
    # without a mask every frame counts: the embedding differs, as in JAX
    want_all = jforward(jp, jnp.asarray(x), jnp.ones(mask.shape, bool))
    got_all = tecapa.ecapa_forward(to_torch(_np(jp)), _t(x), tcfg)
    np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all), **TOL)
    assert np.abs(got_all.numpy()[1] - got.numpy()[1]).max() > 1e-3
    tinit = tecapa.ecapa_init(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.structure(_np(jp)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), tinit))


def test_expressive_archs_and_encode_prosody(jparams, tparams):
    for name in ("expressivity_v2", ARCH):
        j, t = jget_arch(name), get_arch(name)
        assert t.nar_t2u._asdict() == j.nar_t2u._asdict()
        assert t.ecapa._asdict() == j.ecapa._asdict()
        assert t.prosody_encoder_dim == j.prosody_encoder_dim
        assert t.nllb._asdict() == j.nllb._asdict()
    # the port's own init has every leaf of the JAX tree, shapes included
    tinit = tunity.unity_init(torch.Generator().manual_seed(0), get_arch(ARCH))
    want = jax.tree.map(np.shape, _np(jparams))
    got = jax.tree.map(np.shape, unity_params_to_numpy(tinit))
    assert got == want
    rng = np.random.default_rng(6)
    fb = rng.standard_normal((2, 50, 80)).astype(np.float32)
    lens = np.array([50, 33], np.int32)
    je = jax.jit(lambda p, f, n: junity.encode_prosody(p, jget_arch(ARCH), f, n))(
        jparams, jnp.asarray(fb), jnp.asarray(lens))
    te = tunity.encode_prosody(tparams, get_arch(ARCH), _t(fb), _t(lens))
    assert te.shape == (2, 1, 32)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)


@pytest.fixture(scope="module")
def translators(jparams, tparams):
    jt = JTranslator(jparams, jget_arch(ARCH),
                     JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS),
                     JUnitTokenizer(100, ["eng", "fra"], "base_v2"),
                     JCharTokenizer(JSpm.from_bytes(CHAR_SPM)))
    tt = Translator(tparams, get_arch(ARCH),
                    NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS),
                    UnitTokenizer(100, ["eng", "fra"], ARCH),
                    CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM)), device="cpu")
    return jt, tt


def test_translator_prosody_input(translators):
    """S2ST with the prosody input on ``tiny_expressive``: texts and units
    identical to JAX's; a second prosody input (another utterance's fbank,
    padded, with its length) gives other units in both packages; without a
    prosody input both raise."""
    jt, tt = translators
    rng = np.random.default_rng(7)
    wav = (rng.standard_normal(16000 * 2) * 0.1).astype(np.float32)
    opts = dict(beam_size=2, soft_max_seq_len=(0, 12), hard_max_seq_len=12,
                kv_cache_int8=True)
    prosody = [rng.standard_normal((150, 80)).astype(np.float32)]
    other = np.zeros((1, 192, 80), np.float32)
    other[0, :120] = rng.standard_normal((120, 80)) * 2.0 + 1.0
    prosody.append((other, np.array([120], np.int32)))
    units = []
    for p in prosody:
        kw = (dict(prosody_encoder_input=p) if isinstance(p, np.ndarray)
              else dict(prosody_encoder_input=p[0], prosody_input_lens=p[1]))
        jtexts, jspeech = jt.predict(wav, "s2st", "fra", duration_factor=1.2,
                                     text_generation_opts=JOptions(**opts), **kw)
        ttexts, tspeech = tt.predict(wav, "s2st", "fra", duration_factor=1.2,
                                     text_generation_opts=SequenceGeneratorOptions(**opts),
                                     **kw)
        assert ttexts == jtexts
        assert tspeech.units == jspeech.units and len(tspeech.units[0]) > 0
        assert tspeech.audio_wavs == []
        units.append(tspeech.units)
    assert units[0] != units[1]
    assert {"prosody_encoder", "t2u"} <= set(tt.last_timings)
    with pytest.raises(ValueError, match="prosody_fbank"):
        jt.predict(wav, "s2st", "fra", text_generation_opts=JOptions(**opts))
    with pytest.raises(ValueError, match="prosody_fbank"):
        tt.predict(wav, "s2st", "fra",
                   text_generation_opts=SequenceGeneratorOptions(**opts))
