"""The port's offline entry point against the JAX package on the CPU: a
tiny_v2 ``.pt`` exported from a JAX tree, with a card directory of its own
(as tests/unit/test_cli_loading.py's ``tiny_card_dir``), through
``cli.predict.main([..., "--device", "cpu"])``: the same text as the JAX
Translator on JAX's own ``load_unity_model_and_tokenizers`` of the same
files, and a WAV within 1e-4 of its waveform (both in fp32, the PCM16 file
read back within one step of 1/32767). Then the v1 HF route through the
loaders, with a tiny random ``SeamlessM4TModel`` (the config of
tests/integration/test_hf_conversion_v1.py) passed in by monkeypatch: the
port converts it with the v1 converter, the JAX loader raises."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.checkpoint.fairseq_export import (
    export_unity, export_vocoder,
)
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.models.vocoder import codehifigan as jcodehifigan
from seamless_communication_tpu.models.vocoder.hifigan import HifiGanConfig as JHifiGanConfig

from seamless_communication_torch.audio.wav import read_wav, write_wav
from seamless_communication_torch.cli import loading, predict
from seamless_communication_torch.models.vocoder.codehifigan import CodeHifiGanConfig
from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, build_spm_model,
)

VOCODER = dict(num_units=100, unit_embed_dim=32, num_langs=4, lang_embed_dim=8,
               num_spkrs=4, spkr_embed_dim=8, dur_predictor_hidden=16)
HIFIGAN = dict(model_in_dim=48, upsample_initial_channel=32, upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),))
BASE = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL), ("</s>", 0.0, TYPE_CONTROL)]
WORDS = ["▁the", "▁cat", "▁sat", "▁on", "▁mat", "▁a", "▁dog", "▁he", "llo"]
CHARS = ["▁"] + list("abcdefghijklmnopqrstuvwxyz")
MAX_LEN = ["--text_generation_max_len_a", "0", "--text_generation_max_len_b", "10"]
SHORT = ["--text_generation_max_len_a", "0", "--text_generation_max_len_b", "4",
         "--text_generation_beam_size", "2"]


@pytest.fixture(scope="module")
def card_dir(tmp_path_factory):
    """A tiny_v2 UnitY ``.pt`` and a tiny unit HiFi-GAN ``.pt`` from the JAX
    exporters, SentencePiece files, a seeded 2 s WAV, and their cards."""
    d = tmp_path_factory.mktemp("cards")
    params = junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))
    torch.save({"model": export_unity(params)}, d / "tiny.pt")
    vcfg = jcodehifigan.CodeHifiGanConfig(**VOCODER, hifigan=JHifiGanConfig(**HIFIGAN))
    torch.save({"generator": export_vocoder(
        jcodehifigan.code_hifigan_init(jax.random.PRNGKey(1), vcfg))}, d / "voc.pt")
    (d / "tok.model").write_bytes(build_spm_model(
        BASE + [(w, -float(20 - len(w)), TYPE_NORMAL) for w in WORDS]
        + [(c, -30.0, TYPE_NORMAL) for c in CHARS]))
    (d / "char.model").write_bytes(build_spm_model(
        BASE + [(c, -1.0, TYPE_NORMAL) for c in CHARS]))
    (d / "tiny_pt_test.yaml").write_text(
        "name: tiny_pt_test\nmodel_type: unity\nmodel_arch: tiny_v2\n"
        f"tokenizer: {d / 'tok.model'}\nchar_tokenizer: {d / 'char.model'}\n"
        "langs: [eng, fra]\nnum_units: 100\nunit_langs: [eng, fra]\n")
    (d / "tiny_vocoder.yaml").write_text(
        "name: tiny_vocoder\nmodel_type: vocoder_code_hifigan\nmodel_arch: base\n"
        f"checkpoint: {d / 'voc.pt'}\nmodel_config:\n  lang_spkr_idx_map:\n"
        "    multilingual:\n      eng: 0\n      fra: 1\n"
        "    multispkr:\n      eng: [0]\n      fra: [1, 2]\n")
    wav = (np.random.default_rng(3).standard_normal(2 * 16000) * 0.1).astype(np.float32)
    write_wav(str(d / "in.wav"), wav, 16000)
    return d


@pytest.fixture()
def tiny_env(card_dir, monkeypatch):
    """The cards on SEAMLESS_CARDS_DIR; both packages' vocoder loaders take
    the tiny HiFi-GAN config (they build ``CodeHifiGanConfig()``); the port's
    CLI loads UnitY in fp32, as the JAX side is asked to."""
    monkeypatch.setenv("SEAMLESS_CARDS_DIR", str(card_dir))
    monkeypatch.setattr(loading, "CodeHifiGanConfig",
                        lambda: CodeHifiGanConfig(**VOCODER, hifigan=HifiGanConfig(**HIFIGAN)))
    monkeypatch.setattr(jcodehifigan, "CodeHifiGanConfig", functools.partial(
        jcodehifigan.CodeHifiGanConfig, **VOCODER, hifigan=JHifiGanConfig(**HIFIGAN)))
    monkeypatch.setattr(loading, "load_unity_model_and_tokenizers", functools.partial(
        loading.load_unity_model_and_tokenizers, dtype=torch.float32))
    return card_dir


def jax_predict(d, task: str):
    """The JAX Translator on JAX's loaders of the same files, with the
    options ``cli.predict.main`` builds from MAX_LEN and the defaults."""
    from seamless_communication_tpu.cli.loading import (
        load_unity_model_and_tokenizers, load_vocoder,
    )
    from seamless_communication_tpu.inference.generator import SequenceGeneratorOptions
    from seamless_communication_tpu.inference.translator import Translator

    params, cfg, text_tok, unit_tok, char_tok = load_unity_model_and_tokenizers(
        "tiny_pt_test", local_pt_path=str(d / "tiny.pt"), dtype=jnp.float32)
    voc, vcfg, idx_map = load_vocoder("tiny_vocoder")
    opts = SequenceGeneratorOptions(beam_size=5, soft_max_seq_len=(0, 10))
    unit_opts = SequenceGeneratorOptions(beam_size=5, soft_max_seq_len=(25, 50))
    jt = Translator(params, cfg, text_tok, unit_tok, char_tok, vocoder_params=voc,
                    vocoder_cfg=vcfg, lang_spkr_idx_map=idx_map, text_opts=opts,
                    unit_opts=unit_opts)
    return jt.predict(str(d / "in.wav"), task, "fra", spkr=-1)


def test_m4t_predict_s2st_equals_jax(tiny_env, tmp_path):
    out = tmp_path / "out.wav"
    res = predict.main([str(tiny_env / "in.wav"), "s2st", "fra", "--model_name",
                        "tiny_pt_test", "--vocoder_name", "tiny_vocoder",
                        "--local_pt_path", str(tiny_env / "tiny.pt"),
                        "--output_path", str(out), "--device", "cpu", *MAX_LEN])
    assert res.translator.device == torch.device("cpu")
    assert set(res.load_timings) == {"torch_load", "convert", "transfer"}
    jtexts, jspeech = jax_predict(tiny_env, "s2st")
    assert res.texts == jtexts
    assert res.speech.units == jspeech.units and len(res.speech.units[0]) > 0
    want = np.asarray(jspeech.audio_wavs[0])
    got = res.speech.audio_wavs[0]
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4
    back, rate = read_wav(str(out))
    assert rate == 16000 and back.shape == want.shape
    assert np.abs(back - np.clip(want, -1, 1) * 32767 / 32768).max() < 1.5 / 32768


def test_m4t_predict_s2tt_int4_and_options(tiny_env, tmp_path, monkeypatch):
    """An S2TT request with --quantize --quantize_bits 4 runs through the
    int4 tree (tiny tables need ``min_size=1``); --apply_mintox without a
    word list is refused, with one it runs the port's ETOX checker."""
    monkeypatch.setattr(loading, "quantize_params",
                        functools.partial(loading.quantize_params, min_size=1))
    res = predict.main([str(tiny_env / "in.wav"), "s2tt", "fra", "--model_name",
                        "tiny_pt_test", "--local_pt_path", str(tiny_env / "tiny.pt"),
                        "--device", "cpu", "--quantize", "--quantize_bits", "4", *SHORT])
    assert res.speech is None and len(res.texts) == 1
    dec = res.translator.params["text_decoder"]
    assert "weight_i4" in dec["stack"]["layers"][0]["self_attn"]["q_proj"]
    assert "embedding_i4" in dec["embed"]
    assert set(res.load_timings) == {"torch_load", "convert", "transfer", "quantize"}
    with pytest.raises(SystemExit):
        predict.main([str(tiny_env / "in.wav"), "s2tt", "fra", "--apply_mintox",
                      "--device", "cpu"])
    twl = tmp_path / "twl"
    twl.mkdir()
    (twl / "fra_twl.txt").write_text("zzz\n")
    (twl / "eng_twl.txt").write_text("zzz\n")
    res2 = predict.main(["the cat sat", "t2tt", "fra", "--src_lang", "eng",
                         "--model_name", "tiny_pt_test", "--local_pt_path",
                         str(tiny_env / "tiny.pt"), "--device", "cpu", "--apply_mintox",
                         "--etox_dataset", str(twl), *SHORT])
    checker = res2.translator.etox_checker
    assert res2.translator.apply_mintox and set(checker.bad_words) == {"eng", "fra"}


# ---------------------------------------------------------------------------
# the v1 HF route
# ---------------------------------------------------------------------------

DIM, HEADS = 64, 4


@pytest.fixture(scope="module")
def hf_v1():
    from transformers import SeamlessM4TConfig, SeamlessM4TModel
    torch.manual_seed(0)
    cfg = SeamlessM4TConfig(
        hidden_size=DIM, vocab_size=300, t2u_vocab_size=120,
        encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=HEADS, decoder_attention_heads=HEADS,
        encoder_ffn_dim=DIM * 2, decoder_ffn_dim=DIM * 2,
        speech_encoder_layers=2, speech_encoder_attention_heads=HEADS,
        speech_encoder_intermediate_size=DIM * 2, conv_depthwise_kernel_size=7,
        speech_encoder_dropout=0.0, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, speech_encoder_hidden_act="swish",
        adaptor_kernel_size=8, adaptor_stride=8, adaptor_dropout=0.0,
        num_adapter_layers=1, feature_projection_input_dim=160,
        t2u_encoder_layers=2, t2u_decoder_layers=2,
        t2u_encoder_attention_heads=HEADS, t2u_decoder_attention_heads=HEADS,
        t2u_encoder_ffn_dim=DIM * 2, t2u_decoder_ffn_dim=DIM * 2,
        position_embeddings_type="relative",
        unit_hifi_gan_vocab_size=120, upsample_initial_channel=32,
        upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4],
        resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 2]],
        unit_embed_dim=32, lang_embed_dim=8, spkr_embed_dim=8,
        vocoder_num_langs=4, vocoder_num_spkrs=4, var_pred_dropout=0.0,
        max_position_embeddings=512)
    return SeamlessM4TModel(cfg).eval()


@pytest.fixture()
def v1_card(card_dir, hf_v1, monkeypatch):
    import transformers
    (card_dir / "tiny_v1_hf.yaml").write_text(
        "name: tiny_v1_hf\nmodel_type: unity\nmodel_arch: tiny_v1\n"
        f"tokenizer: {card_dir / 'tok.model'}\nlangs: [eng, fra]\n"
        "num_units: 100\nunit_langs: [eng, fra]\n")
    monkeypatch.setenv("SEAMLESS_CARDS_DIR", str(card_dir))
    monkeypatch.setattr(transformers.SeamlessM4TModel, "from_pretrained",
                        classmethod(lambda cls, *a, **k: hf_v1))
    return card_dir


def test_v1_hf_route_uses_the_v1_converter(v1_card, hf_v1):
    """The port's loader on a v1 card's HF route gives the tree of the JAX
    package's ``convert_hf_seamless_m4t_v1``, leaf for leaf."""
    from seamless_communication_tpu.checkpoint.convert_hf import convert_hf_seamless_m4t_v1

    from seamless_communication_torch.checkpoint.from_jax import unity_params_from_jax
    params, cfg, text_tok, unit_tok, char_tok = loading.load_unity_model_and_tokenizers(
        "tiny_v1_hf", local_hf_path="not-read", dtype=torch.float32, device="cpu")
    want = unity_params_from_jax(convert_hf_seamless_m4t_v1(hf_v1))
    assert cfg.arch == "tiny_v1" and char_tok is None and not unit_tok.is_nar_decoder
    wl, gl = [], []

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            wl.append(path)
            assert torch.equal(a, b), path

    walk(want, params)
    assert any("r_proj" in p for p in wl) and any("u_bias" in p for p in wl)
    assert "t2u" in params and "decoder" in params["t2u"]


def test_jax_loader_raises_on_v1_hf(v1_card):
    """The fault the port does not copy: the JAX loader converts a v1 HF
    model with its v2 converter, which reads ``distance_embedding``."""
    from seamless_communication_tpu.cli.loading import load_unity_model_and_tokenizers
    with pytest.raises(AttributeError, match="distance_embedding"):
        load_unity_model_and_tokenizers("tiny_v1_hf", local_hf_path="not-read",
                                        dtype=jnp.float32)
