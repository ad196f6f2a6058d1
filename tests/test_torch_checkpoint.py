"""The port's checkpoint loading against the JAX package on the CPU: the HF
converters (a tiny random ``SeamlessM4Tv2Model``, the configs of
tests/integration/test_hf_conversion.py), the original-``.pt`` converters on
fairseq2- and fairseq1-keyed state dicts from the JAX exporter, the
exporters, ``.npz`` files, the asset cards, the new archs, ``synthesize``,
``write_wav`` and the task names. Converted trees must equal
``from_jax(JAX's tree)`` leaf for leaf, exactly."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.checkpoint import convert_fairseq2 as jf2
from seamless_communication_tpu.checkpoint import fairseq_export as jexport
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.models.vocoder.codehifigan import (
    CodeHifiGanConfig as JCodeHifiGanConfig, code_hifigan_init as j_code_hifigan_init,
)
from seamless_communication_tpu.models.vocoder.hifigan import HifiGanConfig as JHifiGanConfig

from seamless_communication_torch.checkpoint import convert_fairseq2 as tf2
from seamless_communication_torch.checkpoint import fairseq_export as texport
from seamless_communication_torch.checkpoint.from_jax import (
    to_torch, unity_params_from_jax,
)

VOCODER = dict(num_units=100, unit_embed_dim=32, num_langs=4, lang_embed_dim=8,
               num_spkrs=4, spkr_embed_dim=8, dur_predictor_hidden=16)
HIFIGAN = dict(model_in_dim=48, upsample_initial_channel=32, upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),))
DIM, HEADS = 64, 4


def flat(tree, prefix=""):
    """path -> leaf of a tree of dicts and lists."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def assert_trees_equal(want, got):
    """Same paths, dtypes, shapes and bits."""
    w, g = flat(want), flat(got)
    assert set(w) == set(g), (sorted(set(w) - set(g))[:5], sorted(set(g) - set(w))[:5])
    for key in w:
        a, b = w[key], g[key]
        assert isinstance(b, torch.Tensor), key
        assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype)
        assert torch.equal(a, b), key


def unity_want(jtree):
    return unity_params_from_jax(jax.tree.map(np.asarray, jtree))


@pytest.fixture(scope="module")
def jparams():
    return {"tiny_v2": junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2")),
            "tiny_v1": junity.unity_init(jax.random.PRNGKey(4), jget_arch("tiny_v1"))}


@pytest.fixture(scope="module")
def jvocoder():
    cfg = JCodeHifiGanConfig(**VOCODER, hifigan=JHifiGanConfig(**HIFIGAN))
    return jax.tree.map(np.asarray, j_code_hifigan_init(jax.random.PRNGKey(2), cfg))


# ---------------------------------------------------------------------------
# HF converters (v2 model here; the v1 one is in test_torch_cli_predict.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_v2():
    from transformers import SeamlessM4Tv2Config, SeamlessM4Tv2Model
    torch.manual_seed(0)
    cfg = SeamlessM4Tv2Config(
        hidden_size=DIM, vocab_size=300, t2u_vocab_size=120, char_vocab_size=60,
        encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=HEADS, decoder_attention_heads=HEADS,
        encoder_ffn_dim=DIM * 2, decoder_ffn_dim=DIM * 2,
        speech_encoder_layers=2, speech_encoder_attention_heads=HEADS,
        speech_encoder_intermediate_size=DIM * 2, conv_depthwise_kernel_size=7,
        left_max_position_embeddings=8, right_max_position_embeddings=3,
        speech_encoder_dropout=0.0, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, speech_encoder_hidden_act="swish",
        adaptor_kernel_size=8, adaptor_stride=8, adaptor_dropout=0.0,
        num_adapter_layers=1, feature_projection_input_dim=160,
        t2u_encoder_layers=2, t2u_decoder_layers=2,
        t2u_encoder_attention_heads=HEADS, t2u_decoder_attention_heads=HEADS,
        t2u_encoder_ffn_dim=DIM * 2, t2u_decoder_ffn_dim=DIM * 2,
        t2u_variance_predictor_embed_dim=DIM, t2u_variance_predictor_hidden_dim=32,
        t2u_variance_predictor_kernel_size=3, t2u_variance_pred_dropout=0.0,
        speech_encoder_chunk_size=None, position_embeddings_type="relative_key",
        unit_hifi_gan_vocab_size=120, upsample_initial_channel=32, upsample_rates=[4, 2],
        upsample_kernel_sizes=[8, 4], resblock_kernel_sizes=[3],
        resblock_dilation_sizes=[[1, 2]], unit_embed_dim=32, lang_embed_dim=8,
        spkr_embed_dim=8, vocoder_num_langs=4, vocoder_num_spkrs=4,
        var_pred_dropout=0.0, max_position_embeddings=512)
    return SeamlessM4Tv2Model(cfg).eval()


def test_convert_hf_v2_equals_jax(hf_v2):
    from seamless_communication_tpu.checkpoint.convert_hf import (
        convert_hf_seamless_m4t_v2 as jconvert,
    )

    from seamless_communication_torch.checkpoint.convert_hf import (
        convert_hf_seamless_m4t_v2, convert_speech_encoder,
    )
    from seamless_communication_torch.device import params_to
    got = convert_hf_seamless_m4t_v2(hf_v2)
    assert_trees_equal(unity_want(jconvert(hf_v2)), got)
    assert got["text_encoder"]["embed"] is got["text_decoder"]["embed"]
    assert_trees_equal(got["speech_encoder"], convert_speech_encoder(hf_v2.speech_encoder))
    moved = params_to(got, "cpu", torch.bfloat16)
    assert moved["text_encoder"]["embed"] is moved["text_decoder"]["embed"]
    assert moved["t2u"]["final_proj"]["weight"].dtype == torch.bfloat16


def test_convert_hf_code_hifigan_equals_jax(hf_v2):
    from seamless_communication_tpu.checkpoint.convert_hf import (
        convert_hf_code_hifigan as jconvert,
    )

    from seamless_communication_torch.checkpoint.convert_hf import convert_hf_code_hifigan
    want = to_torch(jconvert(hf_v2.vocoder))         # folds the weight norm in place
    assert_trees_equal(want, convert_hf_code_hifigan(hf_v2.vocoder))


# ---------------------------------------------------------------------------
# original .pt converters and the exporters
# ---------------------------------------------------------------------------

# fairseq2 -> fairseq1 keys of a UnitY with a T2U (the inverse of the
# converter's table for the keys the exporter writes; first match wins)
W2V = "encoder.w2v_encoder.w2v_model"
TO_FAIRSEQ1 = [
    (r"^speech_encoder_frontend\.post_extract_layer_norm\.", f"{W2V}.layer_norm."),
    (r"^speech_encoder_frontend\.model_dim_proj\.", f"{W2V}.post_extract_proj."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.conv\.batch_norm\.",
     rf"{W2V}.encoder.layers.\1.conv_module.batch_norm."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.conv\.layer_norm\.",
     rf"{W2V}.encoder.layers.\1.conv_module.layer_norm2."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.conv_layer_norm\.",
     rf"{W2V}.encoder.layers.\1.conv_module.layer_norm."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.conv\.",
     rf"{W2V}.encoder.layers.\1.conv_module."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.ffn(1|2)_layer_norm\.",
     rf"{W2V}.encoder.layers.\1.ffn\2.layer_norm."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.ffn(1|2)\.inner_proj\.",
     rf"{W2V}.encoder.layers.\1.ffn\2.w_1."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.ffn(1|2)\.output_proj\.",
     rf"{W2V}.encoder.layers.\1.ffn\2.w_2."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.self_attn\.(q|k|v)_proj\.",
     rf"{W2V}.encoder.layers.\1.self_attn.linear_\2."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.self_attn\.output_proj\.",
     rf"{W2V}.encoder.layers.\1.self_attn.linear_out."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.self_attn\.sdpa\.rel_k_embed\.",
     rf"{W2V}.encoder.layers.\1.self_attn.rel_k_embedding."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.self_attn\.sdpa\.r_proj\.",
     rf"{W2V}.encoder.layers.\1.self_attn.linear_pos."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.self_attn\.sdpa\.(u|v)_bias",
     rf"{W2V}.encoder.layers.\1.self_attn.pos_bias_\2"),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.self_attn_layer_norm\.",
     rf"{W2V}.encoder.layers.\1.self_attn_layer_norm."),
    (r"^speech_encoder\.inner\.layers\.(\d+)\.layer_norm\.",
     rf"{W2V}.encoder.layers.\1.final_layer_norm."),
    (r"^speech_encoder\.proj1\.", "encoder.adaptor.proj.0."),
    (r"^speech_encoder\.proj2\.", "encoder.adaptor.proj.2."),
    (r"^speech_encoder\.layer_norm\.", "encoder.adaptor.out_ln."),
    (r"^speech_encoder\.adaptor_layers\.(\d+)\.residual_conv\.",
     r"encoder.adaptor.layers.\1.residual_pool.1."),
    (r"^speech_encoder\.adaptor_layers\.(\d+)\.self_attn_conv\.",
     r"encoder.adaptor.layers.\1.attn_pool.1."),
    (r"^speech_encoder\.adaptor_layers\.(\d+)\.ffn\.inner_proj\.",
     r"encoder.adaptor.layers.\1.fc1."),
    (r"^speech_encoder\.adaptor_layers\.(\d+)\.ffn\.output_proj\.",
     r"encoder.adaptor.layers.\1.fc2."),
    (r"^speech_encoder\.adaptor_layers\.(\d+)\.ffn_layer_norm\.",
     r"encoder.adaptor.layers.\1.final_layer_norm."),
    (r"^speech_encoder\.adaptor_layers\.(\d+)\.self_attn\.output_proj\.",
     r"encoder.adaptor.layers.\1.self_attn.out_proj."),
    (r"^speech_encoder\.adaptor_layers\.", "encoder.adaptor.layers."),
    (r"^text_decoder_frontend\.embed\.", "target_letter_decoder.embed_tokens."),
    (r"^text_encoder_frontend\.embed\.", "text_encoder.embed_tokens."),
    (r"^text_decoder\.", "target_letter_decoder."),
    (r"^t2u_model\.encoder\.", "synthesizer_encoder."),
    (r"^t2u_model\.decoder_frontend\.embed_char\.", "decoder.embed_tokens_text."),
    (r"^t2u_model\.decoder_frontend\.embed\.", "decoder.embed_tokens."),
    (r"^t2u_model\.decoder_frontend\.variance_adaptor\.duration_predictor\.",
     "decoder.var_adaptor.duration_predictor."),
    (r"^t2u_model\.decoder_frontend\.pos_emb_alpha_char", "decoder.char_upsampler.pos_emb_alpha"),
    (r"^t2u_model\.decoder_frontend\.pos_emb_alpha", "decoder.dec_pos_emb_alpha"),
    (r"^t2u_model\.decoder\.layers\.(\d+)\.conv1d\.conv1\.", r"decoder.layers.\1.ffn.ffn.0."),
    (r"^t2u_model\.decoder\.layers\.(\d+)\.conv1d\.conv2\.", r"decoder.layers.\1.ffn.ffn.2."),
    (r"^t2u_model\.decoder\.layers\.(\d+)\.conv1d_layer_norm\.",
     r"decoder.layers.\1.ffn.layer_norm."),
    (r"^t2u_model\.decoder\.", "decoder."),
    (r"^t2u_model\.final_proj\.", "decoder.output_projection."),
]
# within text / T2U stacks (applied after the prefix rules)
LAYER_RULES = [
    (r"\.layers\.(\d+)\.self_attn\.output_proj\.", r".layers.\1.self_attn.out_proj."),
    (r"\.layers\.(\d+)\.encoder_decoder_attn\.output_proj\.", r".layers.\1.encoder_attn.out_proj."),
    (r"\.layers\.(\d+)\.encoder_decoder_attn_layer_norm\.", r".layers.\1.encoder_attn_layer_norm."),
    (r"\.layers\.(\d+)\.encoder_decoder_attn\.", r".layers.\1.encoder_attn."),
    (r"\.layers\.(\d+)\.ffn\.inner_proj\.", r".layers.\1.fc1."),
    (r"\.layers\.(\d+)\.ffn\.output_proj\.", r".layers.\1.fc2."),
    (r"\.layers\.(\d+)\.ffn_layer_norm\.", r".layers.\1.final_layer_norm."),
]


def to_fairseq1(sd: dict) -> dict:
    out = {}
    for key, val in sd.items():
        new = key
        for pat, rep in TO_FAIRSEQ1:
            if re.match(pat, key):
                new = re.sub(pat, rep, key)
                break
        if not new.startswith(("encoder.",)):
            for pat, rep in LAYER_RULES:
                new = re.sub(pat, rep, new)
        out[new] = val
    out["target_letter_decoder.output_projection.weight"] = \
        sd["text_decoder_frontend.embed.weight"].clone()
    return out


# the char tokenizer's pieces, not in sorted order, so the reorder moves rows
CHAR_PIECES = ["<pad>", "<unk>", "<s>", "</s>"] + list("qwertyuiopasdfghjklz")


def jax_from_pt(sd, *, v2, fairseq1):
    if fairseq1:
        sd = jf2.apply_unity_fixups(jf2.fairseq1_to_fairseq2_auto(sd),
                                    char_spm_pieces=CHAR_PIECES)
    return jf2.unity_tree_from_fairseq2(sd, v2=v2)


def port_from_pt(sd, *, v2, fairseq1):
    if fairseq1:
        assert tf2.is_fairseq1_unity(sd)
        sd = tf2.apply_unity_fixups(tf2.fairseq1_to_fairseq2_auto(sd),
                                    char_spm_pieces=CHAR_PIECES)
    return tf2.unity_tree_from_fairseq2(sd, v2=v2)


@pytest.mark.parametrize("arch,fairseq1", [("tiny_v2", False), ("tiny_v2", True),
                                           ("tiny_v1", False), ("tiny_v1", True)])
def test_unity_tree_from_pt_equals_jax(jparams, tmp_path, arch, fairseq1):
    """A ``.pt`` file of the JAX exporter (fairseq2 keys, or renamed to the
    fairseq1 keys of a released checkpoint, which takes the key remap, the
    control-symbol permutation and the char reorder) through both
    packages' loaders."""
    v2 = arch == "tiny_v2"
    sd = jexport.export_unity(jparams[arch], conv_batch_norm=not v2)
    if fairseq1:
        sd = to_fairseq1(sd)
    path = tmp_path / "unity.pt"
    torch.save({"model": sd}, path)
    loaded = tf2.load_pt_state_dict(str(path))
    assert set(loaded) == set(sd)
    want = unity_want(jax_from_pt(jf2.load_pt_state_dict(str(path)), v2=v2,
                                  fairseq1=fairseq1))
    got = port_from_pt(loaded, v2=v2, fairseq1=fairseq1)
    assert_trees_equal(want, got)
    if fairseq1:      # the permutation and the reorder did move rows
        emb = got["text_decoder"]["embed"]["embedding"]
        raw = sd["target_letter_decoder.embed_tokens.weight"]
        assert torch.equal(emb[0], raw[1]) and not torch.equal(emb[0], raw[0])


def test_exporters_equal_jax(jparams, jvocoder):
    """The port's exporters on the carried-over trees give the JAX
    exporters' state dicts key for key and bit for bit, and its converters
    give the trees back."""
    for arch, bn in (("tiny_v2", False), ("tiny_v1", True)):
        want = jexport.export_unity(jparams[arch], conv_batch_norm=bn)
        tree = unity_want(jparams[arch])
        got = texport.export_unity(tree, conv_batch_norm=bn)
        assert set(got) == set(want), arch
        for k in want:
            assert torch.equal(got[k], want[k]), (arch, k)
        assert_trees_equal(tree, tf2.unity_tree_from_fairseq2(got, v2=not bn))
    want = jexport.export_vocoder(jvocoder)
    got = texport.export_vocoder(to_torch(jvocoder))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    half = texport.export_unity(unity_want(jparams["tiny_v2"]), dtype=torch.float16)
    assert {v.dtype for v in half.values()} == {torch.float16}


def test_vocoder_tree_from_pt_equals_jax(jvocoder, tmp_path):
    path = tmp_path / "vocoder.pt"
    torch.save({"generator": jexport.export_vocoder(jvocoder)}, path)
    want = to_torch(jf2.vocoder_tree_from_pt(jf2.load_pt_state_dict(str(path))))
    assert_trees_equal(want, tf2.vocoder_tree_from_pt(tf2.load_pt_state_dict(str(path))))
    # an fp16 export keeps g in fp32: the fold gives back the fp16 weights
    sd = texport.export_vocoder(to_torch(jvocoder), dtype=torch.float16)
    assert sd["code_generator.conv_pre.weight_g"].dtype == torch.float32
    tree = tf2.vocoder_tree_from_pt(sd)
    w = tree["hifigan"]["resblocks"][0]["convs1"][1]["weight"]
    v = sd["code_generator.resblocks.0.convs1.1.weight_v"].permute(2, 1, 0)
    assert torch.equal(w.half(), v)


def test_pt_of_bf16_and_expressive_leaves(jparams, tmp_path):
    """A bf16 checkpoint loads (the JAX package's ``.numpy()`` raises on
    one) and keeps its dtype; an expressive checkpoint's FiLM, prosody
    and ECAPA leaves convert too (as the JAX converter converts them,
    tests/test_torch_pretssel.py)."""
    sd = texport.export_unity(unity_want(jparams["tiny_v2"]), dtype=torch.bfloat16)
    path = tmp_path / "bf16.pt"
    torch.save({"model": sd}, path)
    with pytest.raises(TypeError):
        jf2.load_pt_state_dict(str(path))
    tree = tf2.unity_tree_from_fairseq2(tf2.load_pt_state_dict(str(path)))
    assert tree["t2u"]["final_proj"]["weight"].dtype == torch.bfloat16
    jexp = junity.unity_init(jax.random.PRNGKey(9), jget_arch("tiny_expressive"))
    sd = texport.export_unity(unity_want(jexp), dtype=torch.bfloat16)
    tree = tf2.unity_tree_from_fairseq2(sd)
    film = tree["t2u"]["decoder_layers"][0]["film"]
    assert film["proj"]["weight"].dtype == torch.bfloat16
    assert "prosody_proj" in tree["t2u"] and "film" in tree["t2u"]["duration_predictor"]
    assert tree["prosody_encoder"]["fc"]["weight"].dtype == torch.bfloat16


def test_apply_unity_fixups_nllb100():
    """The NLLB-100 dummy row drop and the ties, as in the JAX package."""
    rng = np.random.default_rng(0)
    sd = {"final_proj.weight": rng.normal(size=(256103, 2)).astype(np.float32),
          "t2u_model.final_proj.weight": rng.normal(size=(5, 2)).astype(np.float32),
          "t2u_model.decoder_frontend.embed.weight": np.zeros((5, 2), np.float32)}
    want = jf2.apply_unity_fixups({k: v.copy() for k, v in sd.items()})
    got = tf2.apply_unity_fixups({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert got["final_proj.weight"].shape[0] == 256102


# ---------------------------------------------------------------------------
# .npz files
# ---------------------------------------------------------------------------

def test_npz_both_ways(jparams, tmp_path):
    from seamless_communication_tpu.checkpoint.serialize import (
        load_params_npz as jload, save_params_npz as jsave,
    )

    from seamless_communication_torch.checkpoint.serialize import (
        load_params, save_params,
    )
    from seamless_communication_torch.ops.quantization import quantize_params
    jp = jparams["tiny_v2"]
    jsave(str(tmp_path / "jax.npz"), jp)
    assert_trees_equal(unity_want(jp), load_params(str(tmp_path / "jax.npz")))
    q = quantize_params(unity_want(jp), min_size=1)
    save_params(str(tmp_path / "port.npz"), q)
    back = jload(str(tmp_path / "port.npz"))
    assert back["text_decoder"]["stack"]["layers"]["self_attn"]["q_proj"][
        "weight_i8"].shape == (2, 64, 64)
    assert_trees_equal(q, load_params(str(tmp_path / "port.npz")))
    # any other path is a checkpoint directory of the port's tree
    save_params(str(tmp_path / "ckpt_dir"), q)
    assert_trees_equal(q, load_params(str(tmp_path / "ckpt_dir")))


# ---------------------------------------------------------------------------
# asset cards
# ---------------------------------------------------------------------------

def test_packaged_cards_equal_jax(monkeypatch):
    from seamless_communication_tpu.assets import load_card as jload_card

    from seamless_communication_torch.assets import list_cards, load_card
    monkeypatch.delenv("SEAMLESS_CARDS_DIR", raising=False)
    monkeypatch.delenv("SEAMLESS_GATED_ASSETS", raising=False)
    names = list_cards()
    assert names == sorted(["seamlessM4T_v2_large", "seamlessM4T_large",
                            "seamlessM4T_medium", "unity_nllb-100", "unity_nllb-200",
                            "vocoder_v2", "vocoder_36langs", "seamless_streaming_unity",
                            "seamless_streaming_monotonic_decoder",
                            "seamless_expressivity", "vocoder_pretssel",
                            "vocoder_pretssel_16khz", "conformer_shaw", "mintox",
                            "mexpresso_text", "expresso"])
    for name in names:
        assert load_card(name) == jload_card(name), name
    assert load_card("seamlessM4T_v2_large")["model_arch"] == "base_v2"
    assert "eng" in load_card("seamlessM4T_medium")["langs"]


def test_user_cards_and_gated_dir(tmp_path, monkeypatch):
    from seamless_communication_tpu.assets import load_card as jload_card

    from seamless_communication_torch.assets import load_card, resolve_asset
    cards, gated = tmp_path / "cards", tmp_path / "gated"
    cards.mkdir()
    gated.mkdir()
    (cards / "my_model.yaml").write_text(
        "name: my_model\nbase: seamlessM4T_v2_large\nmodel_arch: tiny_v2\n"
        "num_units: 100  # a comment\nunit_langs: [eng, fra]\n")
    (cards / "vocoder_pretssel_16khz.yaml").write_text(
        "name: vocoder_pretssel_16khz\ncheckpoint: file://x/pt?gated=true\n"
        "sample_rate: 16000\n")
    (gated / "pretssel_melhifigan_wm-16khz.pt").write_bytes(b"x")
    monkeypatch.setenv("SEAMLESS_CARDS_DIR", str(cards))
    monkeypatch.setenv("SEAMLESS_GATED_ASSETS", str(gated))
    for name in ("my_model", "vocoder_pretssel_16khz", "vocoder_v2"):
        assert load_card(name) == jload_card(name), name
    mine = load_card("my_model")
    assert mine["model_arch"] == "tiny_v2" and mine["unit_langs"] == ["eng", "fra"]
    assert "afr" in mine["langs"]                       # from unity_nllb-100
    assert load_card("vocoder_pretssel_16khz")["checkpoint"] == \
        str(gated / "pretssel_melhifigan_wm-16khz.pt")
    with pytest.raises(FileNotFoundError):
        load_card("no_such_card")
    assert resolve_asset(str(cards)) == str(cards)
    monkeypatch.setenv("SEAMLESS_CACHE", str(gated))
    assert resolve_asset("https://example.invalid/a/pretssel_melhifigan_wm-16khz.pt") \
        == str(gated / "pretssel_melhifigan_wm-16khz.pt")
    with pytest.raises(FileNotFoundError):
        resolve_asset("https://example.invalid/missing.pt")


# ---------------------------------------------------------------------------
# archs, the nano speech encoder, synthesize, write_wav, tasks
# ---------------------------------------------------------------------------

def assert_config_equal(want, got, path="cfg"):
    """Every field of the port's config equals the JAX config's; a field the
    port lacks (a feature of a later slice) is at the JAX class's default."""
    if not hasattr(got, "_fields") and not hasattr(got, "__dataclass_fields__"):
        assert got == want, path
        return
    names = getattr(got, "_fields", None) or tuple(got.__dataclass_fields__)
    jnames = getattr(want, "_fields", None) or tuple(want.__dataclass_fields__)
    default = type(want)()
    for name in jnames:
        if name in names:
            assert_config_equal(getattr(want, name), getattr(got, name), f"{path}.{name}")
        else:
            assert getattr(want, name) == getattr(default, name), f"{path}.{name}"


@pytest.mark.parametrize("arch", ["medium", "seamless_micro", "seamless_nano",
                                  "base", "base_v2", "tiny_v1", "tiny_v2"])
def test_arch_configs_equal_jax(arch):
    from seamless_communication_torch.models.unity.builder import get_arch
    assert_config_equal(jget_arch(arch), get_arch(arch))


def test_nano_speech_encoder_equals_jax():
    """A seamless_nano speech encoder (stride-4 fbank stacks, 6 XL layers at
    width 256) forward on a seeded fbank, against the JAX package's."""
    from seamless_communication_tpu.models.wav2vec2.encoder import (
        speech_encoder_forward as jforward, speech_encoder_init as jinit,
    )

    from seamless_communication_torch.checkpoint.from_jax import speech_encoder_from_jax
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.wav2vec2.encoder import speech_encoder_forward
    cfg = get_arch("seamless_nano").speech
    jcfg = jget_arch("seamless_nano").speech
    jp = jinit(jax.random.PRNGKey(3), jcfg)
    fbank = np.random.default_rng(3).standard_normal((2, 128, 80)).astype(np.float32)
    lens = np.array([128, 97], np.int32)
    want_x, want_len = jforward(jp, jnp.asarray(fbank), jnp.asarray(lens), jcfg)
    got_x, got_len = speech_encoder_forward(
        speech_encoder_from_jax(jax.tree.map(np.asarray, jp)),
        torch.from_numpy(fbank), torch.from_numpy(lens).long(), cfg)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_x.shape == want_x.shape == (2, 5, 256)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-4)


def test_synthesize_and_write_wav_equal_jax(jvocoder, tmp_path):
    from seamless_communication_tpu.audio.wav import write_wav as jwrite
    from seamless_communication_tpu.inference.translator import Translator as JTranslator

    from seamless_communication_torch.audio.wav import read_wav, write_wav
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.vocoder.codehifigan import CodeHifiGanConfig
    from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig
    jcfg = JCodeHifiGanConfig(**VOCODER, hifigan=JHifiGanConfig(**HIFIGAN))
    cfg = CodeHifiGanConfig(**VOCODER, hifigan=HifiGanConfig(**HIFIGAN))
    lang_spkr = {"multilingual": {"fra": 1}, "multispkr": {"fra": [2, 3]}}
    jt = JTranslator({}, jget_arch("tiny_v2"), None, vocoder_params=jvocoder,
                     vocoder_cfg=jcfg, lang_spkr_idx_map=lang_spkr)
    tt = Translator({}, jget_arch("tiny_v2"), None, vocoder_params=to_torch(jvocoder),
                    vocoder_cfg=cfg, lang_spkr_idx_map=lang_spkr, device="cpu")
    units = [[5, 9, 9, 40, 2, 77, 13], [], [60] * 20]
    for dur in (True, False):
        want = jt.synthesize(units, "fra", spkr=0, dur_prediction=dur)
        got = tt.synthesize(units, "fra", spkr=0, dur_prediction=dur)
        assert [w.shape for w in got] == [w.shape for w in want]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    wav = np.concatenate([got[0], [1.5, -2.0, 0.5]]).astype(np.float32)
    jwrite(str(tmp_path / "j.wav"), wav, 16000)
    write_wav(str(tmp_path / "t.wav"), wav, 16000)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "t.wav").read_bytes()
    back, rate = read_wav(str(tmp_path / "t.wav"))
    assert rate == 16000 and back.shape == wav.shape


def test_tasks_and_modalities():
    from seamless_communication_tpu.inference import translator as jt

    from seamless_communication_torch.inference import translator as tt
    assert [t.name for t in tt.Task] == [t.name for t in jt.Task]
    assert [m.value for m in tt.Modality] == [m.value for m in jt.Modality]
    for name in ("s2st", "S2TT", "t2st", "t2tt", "asr"):
        want = jt.get_modalities_from_task_str(name)
        got = tt.get_modalities_from_task_str(name)
        assert [m.value for m in got] == [m.value for m in want], name
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="s2st, s2tt, t2st, t2tt, asr"):
            mod.get_modalities_from_task_str("tts")


# ---------------------------------------------------------------------------
# golden anchors through the port
# ---------------------------------------------------------------------------

def test_golden_anchors_through_the_port(jparams):
    """tests/integration/golden_tiny.json's anchors, computed by the port from
    the JAX tree's tiny_v2 parameters, within test_golden_regression.py's
    tolerance."""
    from seamless_communication_torch.audio.fbank import fbank_numpy
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.unity.t2u import nar_t2u_forward
    golden = json.loads((Path(__file__).parent / "integration" / "golden_tiny.json")
                        .read_text())
    cfg = get_arch("tiny_v2")
    params = unity_want(jparams["tiny_v2"])
    t = np.arange(16000) / 16000.0
    fb = fbank_numpy(np.sin(2 * np.pi * (200 + 400 * t) * t).astype(np.float32))
    got = {"fbank_mean": float(fb.mean()), "fbank_std": float(fb.std())}
    with torch.no_grad():
        enc = unity.encode_speech(params, cfg, torch.from_numpy(fb[None, :96].copy()),
                                  torch.tensor([96]))
        got.update(enc_mean=float(enc.seqs.mean()), enc_std=float(enc.seqs.std()),
                   enc_len=int(enc.lengths[0]))
        feats = unity.decode_text(params, cfg, torch.tensor([[3, 5, 7, 9, 11, 3]]), enc,
                                  self_lengths=torch.tensor([6]))
        logits = unity.project(params, feats)
        got.update(dec_logit_mean=float(logits.mean()),
                   dec_argmax_sum=int(logits.argmax(-1).sum()))
        out = nar_t2u_forward(params["t2u"], cfg.nar_t2u, feats, torch.tensor([6]),
                              torch.tensor([[4, 5, 6, 7, 8, 9, 10, 11]]),
                              torch.tensor([[0, 0, 2, 2, 2, 2]]), max_unit_len=64)
        got.update(t2u_unit_len=int(out.unit_lengths[0]),
                   t2u_dur_sum=int(out.durations.sum()),
                   t2u_argmax_sum=int(out.unit_logits.argmax(-1).sum()))
    for key, val in golden.items():
        if isinstance(val, int):
            assert got[key] == val, f"{key}: {got[key]} != {val}"
        else:
            assert got[key] == pytest.approx(val, rel=2e-3, abs=2e-4), key

