"""Synthetic fairseq2-keyed checkpoints from the port's trees (counterpart of
``export_unity``, ``export_ecapa``, ``export_pretssel``, ``export_vocoder``,
``export_monotonic``, ``export_monotonic_fairseq1``, ``export_aligner`` and
``export_w2v2_raw`` in
``seamless_communication_tpu/checkpoint/fairseq_export.py``).

These invert ``convert_fairseq2``: a UnitY (expressive ones too), PRETSSEL,
monotonic decoder or unit HiFi-GAN tree becomes a
state dict in torch layouts (linear (out, in), conv1d (out, in, k), transposed
conv (in, out, k), weight-norm g/v pairs with g = ||v||, batch norm as an
identity: running mean 0, running variance 1 - eps), which the loaders turn
back into the tree. Tests and ``chip_smoke.py`` write ``.pt`` files with them,
no real checkpoint being in the repository. The arithmetic (the weight-norm g)
is the JAX package's, in numpy.

``dtype`` casts every floating tensor of the state dict, except the
weight-norm g, which stays fp32: a 16-bit g would move the folded weights by
up to one of their own ulps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    t = x.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).copy())


def _x_lin(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(_np(p["weight"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(_np(p["bias"]))


def _x_ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(_np(p["scale"]))
    sd[f"{prefix}.bias"] = _t(_np(p["bias"]))


def _x_conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(_np(p["weight"]), (2, 1, 0)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(_np(p["bias"]))


def _x_pointwise(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(_np(p["weight"]).T[:, :, None])


def _x_embed(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(_np(p["embedding"]))


def _x_mha(sd, prefix, p):
    for k in ("q_proj", "k_proj", "v_proj", "output_proj"):
        _x_lin(sd, f"{prefix}.{k}", p[k])


def _x_film(sd, prefix, p):
    _x_lin(sd, f"{prefix}.proj", p["proj"])
    sd[f"{prefix}.s_gamma"] = _t(_np(p["s_gamma"]))
    sd[f"{prefix}.s_beta"] = _t(_np(p["s_beta"]))


def _x_convT(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(_np(p["weight"]), (1, 2, 0)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(_np(p["bias"]))


def _x_wn(sd, prefix, p, dtype=None, *, transpose=False):
    """A conv as a weight-norm g/v pair with g = ||v|| (fp32), so that the
    fold gives v back; with ``dtype``, the norm of v as the file holds it."""
    w = _np(p["weight"])
    v = (np.transpose(w, (1, 2, 0)) if transpose         # (k, in, out) -> (in, out, k)
         else np.transpose(w, (2, 1, 0)))                # (k, in, out) -> (out, in, k)
    if dtype is not None:
        v = _np(torch.from_numpy(np.ascontiguousarray(v)).to(dtype).float())
    sd[f"{prefix}.weight_g"] = _t(np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)),
                                                       keepdims=True)))
    sd[f"{prefix}.weight_v"] = _t(v)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(_np(p["bias"]))


def _x_lstm(sd, prefix, layers):
    """torch LSTM keys; ``wx``'s bias goes to ``bias_ih`` and ``bias_hh`` is
    zero, so the converter's sum gives it back in any dtype."""
    for k, lp in enumerate(layers):
        sd[f"{prefix}.weight_ih_l{k}"] = _t(_np(lp["wx"]["weight"]).T)
        sd[f"{prefix}.weight_hh_l{k}"] = _t(_np(lp["wh"]["weight"]).T)
        b = _np(lp["wx"]["bias"])
        sd[f"{prefix}.bias_ih_l{k}"] = _t(b)
        sd[f"{prefix}.bias_hh_l{k}"] = _t(np.zeros_like(b))


def _x_variance_predictor(sd, prefix, p):
    _x_conv(sd, f"{prefix}.conv1.0", p["conv1"])
    _x_ln(sd, f"{prefix}.ln1", p["ln1"])
    _x_conv(sd, f"{prefix}.conv2.0", p["conv2"])
    _x_ln(sd, f"{prefix}.ln2", p["ln2"])
    _x_lin(sd, f"{prefix}.proj", p["proj"])
    if "film" in p:
        _x_film(sd, f"{prefix}.film", p["film"])


def _x_fft_layers(sd, prefix, layers):
    for i, lp in enumerate(layers):
        p = f"{prefix}.layers.{i}"
        _x_mha(sd, f"{p}.self_attn", lp["self_attn"])
        _x_ln(sd, f"{p}.self_attn_layer_norm", lp["self_attn_layer_norm"])
        _x_conv(sd, f"{p}.conv1d.conv1", lp["conv1"])
        _x_conv(sd, f"{p}.conv1d.conv2", lp["conv2"])
        _x_ln(sd, f"{p}.conv1d_layer_norm", lp["conv_layer_norm"])
        if "film" in lp:
            _x_film(sd, f"{p}.film", lp["film"])


def _x_bn_identity(sd, prefix, p):
    """BatchNorm1d keys whose fold gives the affine {scale, bias} exactly:
    running_var = 1 - eps, so sqrt(var + 1e-5) == 1."""
    scale = _np(p["scale"])
    sd[f"{prefix}.weight"] = _t(scale)
    sd[f"{prefix}.bias"] = _t(_np(p["bias"]))
    sd[f"{prefix}.running_mean"] = _t(np.zeros_like(scale))
    sd[f"{prefix}.running_var"] = _t(np.full_like(scale, 1.0 - 1e-5))


def _x_encoder(sd, prefix, embed_prefix, tree):
    if embed_prefix is not None:
        _x_embed(sd, embed_prefix, tree["embed"])
    for i, lp in enumerate(tree["stack"]["layers"]):
        p = f"{prefix}.layers.{i}"
        _x_ln(sd, f"{p}.self_attn_layer_norm", lp["self_attn_layer_norm"])
        _x_mha(sd, f"{p}.self_attn", lp["self_attn"])
        _x_ln(sd, f"{p}.ffn_layer_norm", lp["ffn"]["layer_norm"])
        _x_lin(sd, f"{p}.ffn.inner_proj", lp["ffn"]["inner_proj"])
        _x_lin(sd, f"{p}.ffn.output_proj", lp["ffn"]["output_proj"])
    _x_ln(sd, f"{prefix}.layer_norm", tree["stack"]["layer_norm"])


def _x_decoder(sd, prefix, embed_prefix, tree):
    _x_embed(sd, embed_prefix, tree["embed"])
    for i, lp in enumerate(tree["stack"]["layers"]):
        p = f"{prefix}.layers.{i}"
        _x_ln(sd, f"{p}.self_attn_layer_norm", lp["self_attn_layer_norm"])
        _x_mha(sd, f"{p}.self_attn", lp["self_attn"])
        _x_ln(sd, f"{p}.encoder_decoder_attn_layer_norm", lp["cross_attn_layer_norm"])
        _x_mha(sd, f"{p}.encoder_decoder_attn", lp["cross_attn"])
        _x_ln(sd, f"{p}.ffn_layer_norm", lp["ffn"]["layer_norm"])
        _x_lin(sd, f"{p}.ffn.inner_proj", lp["ffn"]["inner_proj"])
        _x_lin(sd, f"{p}.ffn.output_proj", lp["ffn"]["output_proj"])
    _x_ln(sd, f"{prefix}.layer_norm", tree["stack"]["layer_norm"])


def export_ecapa(sd: dict, prefix: str, tree: dict) -> None:
    """An ECAPA-TDNN tree's keys under ``prefix``, into ``sd``."""
    def tdnn(p, t):
        _x_conv(sd, f"{p}.conv", t["conv"])
        _x_ln(sd, f"{p}.norm", t["norm"])

    tdnn(f"{prefix}.blocks.0", tree["blocks"][0])
    for i, b in enumerate(tree["blocks"][1:], start=1):
        p = f"{prefix}.blocks.{i}"
        tdnn(f"{p}.tdnn1", b["tdnn1"])
        for j, rb in enumerate(b["res2net"]["blocks"]):
            tdnn(f"{p}.res2net_block.blocks.{j}", rb)
        tdnn(f"{p}.tdnn2", b["tdnn2"])
        _x_conv(sd, f"{p}.se_block.conv1", b["se"]["conv1"])
        _x_conv(sd, f"{p}.se_block.conv2", b["se"]["conv2"])
        if "shortcut" in b:
            _x_conv(sd, f"{p}.shortcut", b["shortcut"])
    tdnn(f"{prefix}.mfa", tree["mfa"])
    tdnn(f"{prefix}.asp.tdnn", tree["asp_tdnn"])
    _x_conv(sd, f"{prefix}.asp.conv", tree["asp_conv"])
    _x_ln(sd, f"{prefix}.asp_norm", tree["asp_norm"])
    _x_conv(sd, f"{prefix}.fc", tree["fc"])


def _cast(sd: dict, dtype, keep=()) -> dict:
    if dtype is None:
        return sd
    return {k: (v.to(dtype) if v.is_floating_point() and not k.endswith(keep) else v)
            for k, v in sd.items()}


def export_unity(params: dict, *, conv_batch_norm: bool = False,
                 dtype: Optional[torch.dtype] = None) -> dict:
    """A port UnitY tree -> a fairseq2-keyed state dict. ``conv_batch_norm``
    writes each conformer layer's conv norm as an identity batch norm (the
    v1 models' layout). An expressive tree adds its ECAPA prosody encoder,
    its FiLM layers and ``prosody_proj``."""
    sd: dict = {}
    se = params["speech_encoder"]
    _x_ln(sd, "speech_encoder_frontend.post_extract_layer_norm",
          se["feature_projection"]["layer_norm"])
    _x_lin(sd, "speech_encoder_frontend.model_dim_proj",
           se["feature_projection"]["projection"])
    for i, lp in enumerate(se["encoder"]):
        p = f"speech_encoder.inner.layers.{i}"
        _x_ln(sd, f"{p}.ffn1_layer_norm", lp["ffn1"]["layer_norm"])
        _x_lin(sd, f"{p}.ffn1.inner_proj", lp["ffn1"]["inner_proj"])
        _x_lin(sd, f"{p}.ffn1.output_proj", lp["ffn1"]["output_proj"])
        _x_ln(sd, f"{p}.self_attn_layer_norm", lp["self_attn_layer_norm"])
        _x_mha(sd, f"{p}.self_attn", lp["self_attn"])
        if "rel_k_embed" in lp["self_attn"]:
            _x_embed(sd, f"{p}.self_attn.sdpa.rel_k_embed", lp["self_attn"]["rel_k_embed"])
        if "r_proj" in lp["self_attn"]:
            _x_lin(sd, f"{p}.self_attn.sdpa.r_proj", lp["self_attn"]["r_proj"])
            sd[f"{p}.self_attn.sdpa.u_bias"] = _t(_np(lp["self_attn"]["u_bias"]))
            sd[f"{p}.self_attn.sdpa.v_bias"] = _t(_np(lp["self_attn"]["v_bias"]))
        conv = lp["conv"]
        _x_ln(sd, f"{p}.conv_layer_norm", conv["layer_norm"])
        _x_pointwise(sd, f"{p}.conv.pointwise_conv1", conv["pointwise_conv1"])
        _x_conv(sd, f"{p}.conv.depthwise_conv", conv["depthwise_conv"])
        if conv_batch_norm:
            _x_bn_identity(sd, f"{p}.conv.batch_norm", conv["norm"])
        else:
            _x_ln(sd, f"{p}.conv.layer_norm", conv["norm"])
        _x_pointwise(sd, f"{p}.conv.pointwise_conv2", conv["pointwise_conv2"])
        _x_ln(sd, f"{p}.ffn2_layer_norm", lp["ffn2"]["layer_norm"])
        _x_lin(sd, f"{p}.ffn2.inner_proj", lp["ffn2"]["inner_proj"])
        _x_lin(sd, f"{p}.ffn2.output_proj", lp["ffn2"]["output_proj"])
        _x_ln(sd, f"{p}.layer_norm", lp["layer_norm"])
    _x_lin(sd, "speech_encoder.proj1", se["intermediate_ffn"]["inner_proj"])
    _x_lin(sd, "speech_encoder.proj2", se["intermediate_ffn"]["output_proj"])
    _x_ln(sd, "speech_encoder.layer_norm", se["inner_layer_norm"])
    for i, ap in enumerate(se["adaptor"]):
        p = f"speech_encoder.adaptor_layers.{i}"
        _x_ln(sd, f"{p}.residual_layer_norm", ap["residual_layer_norm"])
        _x_conv(sd, f"{p}.residual_conv", ap["residual_conv"])
        _x_ln(sd, f"{p}.self_attn_layer_norm", ap["self_attn_layer_norm"])
        _x_conv(sd, f"{p}.self_attn_conv", ap["self_attn_conv"])
        _x_mha(sd, f"{p}.self_attn", ap["self_attn"])
        _x_ln(sd, f"{p}.ffn_layer_norm", ap["ffn_layer_norm"])
        _x_lin(sd, f"{p}.ffn.inner_proj", ap["ffn"]["inner_proj"])
        _x_lin(sd, f"{p}.ffn.output_proj", ap["ffn"]["output_proj"])
    # the streaming UnitY has no text decoder (the monotonic one is separate)
    if "text_decoder" in params:
        _x_decoder(sd, "text_decoder", "text_decoder_frontend.embed",
                   params["text_decoder"])
    if "text_encoder" in params:
        _x_encoder(sd, "text_encoder", "text_encoder_frontend.embed",
                   params["text_encoder"])
    if "prosody_encoder" in params:
        export_ecapa(sd, "prosody_encoder_model", params["prosody_encoder"])
    t2u = params.get("t2u")
    if t2u is not None and "embed_char" not in t2u:
        # AR T2U (v1): an encoder-decoder over the unit vocabulary
        _x_decoder(sd, "t2u_model.decoder", "t2u_model.decoder_frontend.embed",
                   {"embed": t2u["embed"], "stack": t2u["decoder"]})
        if "encoder" in t2u:
            _x_encoder(sd, "t2u_model.encoder", None, {"stack": t2u["encoder"]})
    elif t2u is not None:
        # the JAX exporter writes a (4, 4) zero placeholder for the unit
        # embedding the NAR T2U does not have
        sd["t2u_model.decoder_frontend.embed.weight"] = _t(np.zeros((4, 4), np.float32))
        _x_encoder(sd, "t2u_model.encoder", None, {"stack": t2u["encoder"]})
        _x_embed(sd, "t2u_model.decoder_frontend.embed_char", t2u["embed_char"])
        sd["t2u_model.decoder_frontend.pos_emb_alpha"] = _t(_np(t2u["pos_emb_alpha"]))
        sd["t2u_model.decoder_frontend.pos_emb_alpha_char"] = _t(
            _np(t2u["pos_emb_alpha_char"]))
        _x_variance_predictor(
            sd, "t2u_model.decoder_frontend.variance_adaptor.duration_predictor",
            t2u["duration_predictor"])
        if "prosody_proj" in t2u:
            _x_lin(sd, "t2u_model.prosody_proj", t2u["prosody_proj"])
        _x_fft_layers(sd, "t2u_model.decoder", t2u["decoder_layers"])
        _x_ln(sd, "t2u_model.decoder.layer_norm", t2u["layer_norm"])
        _x_lin(sd, "t2u_model.final_proj", t2u["final_proj"])
    return _cast(sd, dtype)


def export_monotonic(params: dict, *, dtype: Optional[torch.dtype] = None) -> dict:
    """A port monotonic decoder tree -> a fairseq2-keyed state dict. The
    energy MLPs' linears go to the even indices of their Sequentials
    (Linear, ReLU, ...), as in the released checkpoints."""
    sd: dict = {}
    for i, lp in enumerate(params["layers"]):
        p = f"text_decoder.layers.{i}"
        _x_ln(sd, f"{p}.self_attn_layer_norm", lp["self_attn_layer_norm"])
        _x_mha(sd, f"{p}.self_attn", lp["self_attn"])
        _x_ln(sd, f"{p}.encoder_decoder_attn_layer_norm", lp["cross_attn_layer_norm"])
        _x_mha(sd, f"{p}.encoder_decoder_attn", lp["cross_attn"])
        pc = f"{p}.p_choose_layer"
        sd[f"{pc}.energy_bias"] = _t(_np(lp["p_choose"]["energy_bias"]))
        for j, (qp, kp) in enumerate(zip(lp["p_choose"]["q_energy_proj"],
                                         lp["p_choose"]["k_energy_proj"])):
            _x_lin(sd, f"{pc}.q_energy_proj.layers.{2 * j}", qp)
            _x_lin(sd, f"{pc}.k_energy_proj.layers.{2 * j}", kp)
        _x_ln(sd, f"{p}.ffn_layer_norm", lp["ffn"]["layer_norm"])
        _x_lin(sd, f"{p}.ffn.inner_proj", lp["ffn"]["inner_proj"])
        _x_lin(sd, f"{p}.ffn.output_proj", lp["ffn"]["output_proj"])
    _x_ln(sd, "text_decoder.layer_norm", params["layer_norm"])
    sd["final_proj.weight"] = _t(_np(params["embed"]["embedding"]))
    return _cast(sd, dtype)


def export_monotonic_fairseq1(params: dict, *, dtype: Optional[torch.dtype] = None
                              ) -> dict:
    """The fairseq1 key space of the EMMA decoder (``decoder.*``,
    ``encoder_attn.{source,target}_energy_layer``, ``energy_bias``), the
    control-symbol permutation inverted so that ``monotonic_tree_from_pt``
    gives the tree back."""
    sd: dict = {"decoder.version": torch.zeros(1),
                "decoder.embed_positions._float_tensor": torch.zeros(1)}
    for i, lp in enumerate(params["layers"]):
        p = f"decoder.layers.{i}"
        _x_ln(sd, f"{p}.self_attn_layer_norm", lp["self_attn_layer_norm"])
        for k in ("q_proj", "k_proj", "v_proj"):
            _x_lin(sd, f"{p}.self_attn.{k}", lp["self_attn"][k])
        _x_lin(sd, f"{p}.self_attn.out_proj", lp["self_attn"]["output_proj"])
        _x_ln(sd, f"{p}.encoder_attn_layer_norm", lp["cross_attn_layer_norm"])
        for k in ("q_proj", "k_proj", "v_proj"):
            _x_lin(sd, f"{p}.encoder_attn.{k}", lp["cross_attn"][k])
        _x_lin(sd, f"{p}.encoder_attn.out_proj", lp["cross_attn"]["output_proj"])
        sd[f"{p}.encoder_attn.energy_bias"] = _t(_np(lp["p_choose"]["energy_bias"]))
        for j, (qp, kp) in enumerate(zip(lp["p_choose"]["q_energy_proj"],
                                         lp["p_choose"]["k_energy_proj"])):
            _x_lin(sd, f"{p}.encoder_attn.target_energy_layer.layers.{2 * j}", qp)
            _x_lin(sd, f"{p}.encoder_attn.source_energy_layer.layers.{2 * j}", kp)
        _x_ln(sd, f"{p}.final_layer_norm", lp["ffn"]["layer_norm"])
        _x_lin(sd, f"{p}.fc1", lp["ffn"]["inner_proj"])
        _x_lin(sd, f"{p}.fc2", lp["ffn"]["output_proj"])
    _x_ln(sd, "decoder.layer_norm", params["layer_norm"])
    # the converter maps rows (1, 3, 0, 2) to (0, 1, 2, 3): write them there
    emb = _np(params["embed"]["embedding"]).copy()
    emb[[1, 3, 0, 2]] = emb[[0, 1, 2, 3]].copy()
    sd["decoder.output_projection.weight"] = _t(emb)
    sd["decoder.embed_tokens.weight"] = _t(emb)
    return _cast(sd, dtype)


def export_vocoder(params: dict, *, dtype: Optional[torch.dtype] = None) -> dict:
    """A unit HiFi-GAN tree -> a state dict with the reference's
    speech-resynthesis keys (``code_generator.*``), the convs of the HiFi-GAN
    as weight-norm g/v pairs."""
    sd: dict = {}
    g = "code_generator"

    def conv_wn(prefix, p, transpose=False):
        _x_wn(sd, prefix, p, dtype, transpose=transpose)

    _x_embed(sd, f"{g}.dict", params["unit_embedding"])
    _x_embed(sd, f"{g}.spkr", params["speaker_embedding"])
    _x_embed(sd, f"{g}.lang", params["language_embedding"])
    dp = params["dur_predictor"]
    _x_conv(sd, f"{g}.dur_predictor.conv1.0", dp["conv1"])
    _x_ln(sd, f"{g}.dur_predictor.ln1", dp["ln1"])
    _x_conv(sd, f"{g}.dur_predictor.conv2.0", dp["conv2"])
    _x_ln(sd, f"{g}.dur_predictor.ln2", dp["ln2"])
    _x_lin(sd, f"{g}.dur_predictor.proj", dp["proj"])
    h = params["hifigan"]
    conv_wn(f"{g}.conv_pre", h["conv_pre"])
    for i, up in enumerate(h["upsampler"]):
        conv_wn(f"{g}.ups.{i}", up, transpose=True)
    for i, rb in enumerate(h["resblocks"]):
        for j, c in enumerate(rb["convs1"]):
            conv_wn(f"{g}.resblocks.{i}.convs1.{j}", c)
        for j, c in enumerate(rb["convs2"]):
            conv_wn(f"{g}.resblocks.{i}.convs2.{j}", c)
    conv_wn(f"{g}.conv_post", h["conv_post"])
    return _cast(sd, dtype, keep=".weight_g")


def export_pretssel(params: dict, cfg, *, dtype: Optional[torch.dtype] = None) -> dict:
    """A PRETSSEL tree -> its checkpoint's state dict, the flat ``layers``
    list built as the reference builds it, independently of the converter's
    index arithmetic: the SEANet stream layers in construction order, cut
    into four chunks and interleaved with the postnet, the HiFi-GAN's
    conv_pre, upsamplers, resblocks and conv_post (weight-norm pairs). The
    postnet's norms are identity batch norms; the gcmvn statistics are not
    written (card data). ``dtype`` casts as ``export_vocoder`` does."""
    sd: dict = {}
    export_ecapa(sd, "encoder_frontend.prosody_encoder", params["prosody_encoder"])
    _x_embed(sd, "encoder_frontend.embed_tokens", params["embed_tokens"])
    _x_embed(sd, "encoder_frontend.embed_lang", params["embed_lang"])
    sd["encoder_frontend.pos_emb_alpha"] = _t(_np(params["pos_emb_alpha_enc"]))
    sd["decoder_frontend.pos_emb_alpha"] = _t(_np(params["pos_emb_alpha_dec"]))
    _x_fft_layers(sd, "encoder", params["encoder_layers"])
    _x_fft_layers(sd, "decoder", params["decoder_layers"])
    va = "decoder_frontend.variance_adaptor"
    for name in ("pitch_predictor", "vuv_predictor", "energy_predictor"):
        _x_variance_predictor(sd, f"{va}.{name}", params[name])
    _x_conv(sd, f"{va}.embed_pitch", params["embed_pitch"])
    _x_conv(sd, f"{va}.embed_energy", params["embed_energy"])
    _x_lin(sd, "final_proj", params["final_proj"])
    sd["mean"] = _t(_np(params["mean"]))
    sd["scale"] = _t(_np(params["scale"]))

    sea = params["seanet"]
    stream: list = [("conv", sea["enc_in"])]
    for blk in sea["enc_blocks"]:
        stream += [("res", blk["res"]), ("elu", None), ("conv", blk["down"])]
    stream += [("lstm", sea["enc_lstm"]), ("elu", None), ("conv", sea["enc_out"]),
               ("conv", sea["dec_in"]), ("lstm", sea["dec_lstm"])]
    for blk in sea["dec_blocks"]:
        stream += [("elu", None), ("convtr", blk["up"]), ("res", blk["res"])]
    stream += [("elu", None), ("conv", sea["dec_out"])]
    chunk = len(stream) // 4
    hifi = params["hifigan"]
    flat: list = [("postnet", p) for p in params["postnet"]]
    flat += stream[:chunk] + [("wnconv", hifi["conv_pre"])]
    flat += stream[chunk:2 * chunk] + [("wnconvtr", up) for up in hifi["upsampler"]]
    flat += stream[2 * chunk:3 * chunk] + [("hifires", rb) for rb in hifi["resblocks"]]
    flat += stream[3 * chunk:] + [("wnconv", hifi["conv_post"])]
    for idx, (kind, tree) in enumerate(flat):
        p = f"layers.{idx}"
        if kind == "postnet":
            _x_conv(sd, f"{p}.0", tree["conv"])
            _x_bn_identity(sd, f"{p}.1", tree["norm"])
        elif kind == "conv":
            _x_conv(sd, f"{p}.conv.conv", tree)
        elif kind == "convtr":
            _x_convT(sd, f"{p}.convtr.convtr", tree)
        elif kind == "res":
            _x_conv(sd, f"{p}.block.1.conv.conv", tree["conv1"])
            _x_conv(sd, f"{p}.block.3.conv.conv", tree["conv2"])
        elif kind == "lstm":
            _x_lstm(sd, f"{p}.lstm", tree)
        elif kind == "wnconv":
            _x_wn(sd, p, tree, dtype)
        elif kind == "wnconvtr":
            _x_wn(sd, p, tree, dtype, transpose=True)
        elif kind == "hifires":
            for j, c in enumerate(tree["convs1"]):
                _x_wn(sd, f"{p}.convs1.{j}", c, dtype)
            for j, c in enumerate(tree["convs2"]):
                _x_wn(sd, f"{p}.convs2.{j}", c, dtype)
    # the batch norms' statistics stay fp32 too: their fold is the identity
    # only at fp32 (1 - 1e-5 rounds to 1 in fp16)
    return _cast(sd, dtype, keep=(".weight_g", ".running_mean", ".running_var"))


def export_conformer_shaw_fairseq1(se: dict, *, dtype: Optional[torch.dtype] = None
                                   ) -> dict:
    """The speech encoder's frontend projection and conformer stack of a
    port tree under the fairseq1 w2v-BERT names that
    ``convert_fairseq2.conformer_shaw_tree_from_pt`` reads (the reference's
    models/conformer_shaw/loader.py), with the pretraining-only tensors a
    real checkpoint holds, which the converter drops."""
    sd: dict = {}
    _x_ln(sd, "layer_norm", se["feature_projection"]["layer_norm"])
    _x_lin(sd, "post_extract_proj", se["feature_projection"]["projection"])
    for i, lp in enumerate(se["encoder"]):
        p = f"encoder.layers.{i}"
        for n in (1, 2):
            _x_ln(sd, f"{p}.ffn{n}.layer_norm", lp[f"ffn{n}"]["layer_norm"])
            _x_lin(sd, f"{p}.ffn{n}.w_1", lp[f"ffn{n}"]["inner_proj"])
            _x_lin(sd, f"{p}.ffn{n}.w_2", lp[f"ffn{n}"]["output_proj"])
        _x_ln(sd, f"{p}.self_attn_layer_norm", lp["self_attn_layer_norm"])
        for k in ("q_proj", "k_proj", "v_proj"):
            _x_lin(sd, f"{p}.self_attn.{k}", lp["self_attn"][k])
        _x_lin(sd, f"{p}.self_attn.out_proj", lp["self_attn"]["output_proj"])
        _x_embed(sd, f"{p}.self_attn.rel_k_embedding", lp["self_attn"]["rel_k_embed"])
        conv = lp["conv"]
        _x_ln(sd, f"{p}.conv_module.layer_norm", conv["layer_norm"])
        _x_pointwise(sd, f"{p}.conv_module.pointwise_conv1", conv["pointwise_conv1"])
        _x_conv(sd, f"{p}.conv_module.depthwise_conv", conv["depthwise_conv"])
        _x_ln(sd, f"{p}.conv_module.layer_norm2", conv["norm"])
        _x_pointwise(sd, f"{p}.conv_module.pointwise_conv2", conv["pointwise_conv2"])
        _x_ln(sd, f"{p}.final_layer_norm", lp["layer_norm"])
    sd["mask_emb"] = torch.zeros(4)
    sd["quantizer.vars"] = torch.zeros(1, 8, 2)
    sd["quantizer.weight_proj.weight"] = torch.zeros(8, 4)
    sd["project_q.weight"] = torch.zeros(4, 4)
    sd["mlm_proj.weight"] = torch.zeros(4, 4)
    return _cast(sd, dtype)


def export_aligner(params: dict) -> dict:
    """An aligner tree -> the raw aligner checkpoint's layout (reference
    aligner/loader.py:22-58): ``aligner_state`` with a conv at Sequential
    slot 1 + 3 i of each tower, ``text_emb_state`` and ``unit_emb_state``."""
    aligner_state: dict = {}
    for name in ("t_conv", "f_conv"):
        for i, cp in enumerate(params[name]):
            _x_conv(aligner_state, f"{name}.{1 + 3 * i}", cp)
    return {"aligner_state": aligner_state,
            "text_emb_state": {"weight": _t(_np(params["embed_text"]["embedding"]))},
            "unit_emb_state": {"weight": _t(_np(params["embed_unit"]["embedding"]))}}


def export_w2v2_raw(params: dict) -> dict:
    """A ``wav2vec2_raw`` tree (layers a list) -> fairseq1-style wav2vec2 keys,
    the form fairseq2's loader remaps. The positional conv is weight-normed
    over the kernel axis (dim 2): g of shape (1, 1, k)."""
    sd: dict = {}
    for i, cp in enumerate(params["feature_extractor"]):
        _x_conv(sd, f"feature_extractor.conv_layers.{i}.0", cp["conv"])
        _x_ln(sd, f"feature_extractor.conv_layers.{i}.2.1", cp["norm"])
    _x_ln(sd, "layer_norm", params["post_extract_norm"])
    _x_lin(sd, "post_extract_proj", params["post_extract_proj"])
    pc = params["pos_conv"]
    w = np.transpose(_np(pc["weight"]), (2, 1, 0))            # (out, in / g, k)
    sd["encoder.pos_conv.0.weight_g"] = _t(np.sqrt((w ** 2).sum(axis=(0, 1), keepdims=True)))
    sd["encoder.pos_conv.0.weight_v"] = _t(w)
    sd["encoder.pos_conv.0.bias"] = _t(_np(pc["bias"]))
    for i, lp in enumerate(params["layers"]):
        p = f"encoder.layers.{i}"
        _x_ln(sd, f"{p}.self_attn_layer_norm", lp["self_attn_layer_norm"])
        for k in ("q_proj", "k_proj", "v_proj"):
            _x_lin(sd, f"{p}.self_attn.{k}", lp["self_attn"][k])
        _x_lin(sd, f"{p}.self_attn.out_proj", lp["self_attn"]["output_proj"])
        _x_lin(sd, f"{p}.fc1", lp["ffn"]["inner_proj"])
        _x_lin(sd, f"{p}.fc2", lp["ffn"]["output_proj"])
        _x_ln(sd, f"{p}.final_layer_norm", lp["ffn"]["layer_norm"])
    _x_ln(sd, "encoder.layer_norm", params["encoder_norm"])
    return sd
