"""Synthetic fairseq2-keyed checkpoints from the port's trees (counterpart of
``export_unity``, ``export_vocoder``, ``export_monotonic`` and
``export_monotonic_fairseq1`` in
``seamless_communication_tpu/checkpoint/fairseq_export.py``).

These invert ``convert_fairseq2``: a UnitY, monotonic decoder or unit
HiFi-GAN tree becomes a
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


def _cast(sd: dict, dtype, keep=()) -> dict:
    if dtype is None:
        return sd
    return {k: (v.to(dtype) if v.is_floating_point() and not k.endswith(keep) else v)
            for k, v in sd.items()}


def export_unity(params: dict, *, conv_batch_norm: bool = False,
                 dtype: Optional[torch.dtype] = None) -> dict:
    """A port UnitY tree -> a fairseq2-keyed state dict. ``conv_batch_norm``
    writes each conformer layer's conv norm as an identity batch norm (the
    v1 models' layout)."""
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
        vp = "t2u_model.decoder_frontend.variance_adaptor.duration_predictor"
        dp = t2u["duration_predictor"]
        _x_conv(sd, f"{vp}.conv1.0", dp["conv1"])
        _x_ln(sd, f"{vp}.ln1", dp["ln1"])
        _x_conv(sd, f"{vp}.conv2.0", dp["conv2"])
        _x_ln(sd, f"{vp}.ln2", dp["ln2"])
        _x_lin(sd, f"{vp}.proj", dp["proj"])
        for i, lp in enumerate(t2u["decoder_layers"]):
            p = f"t2u_model.decoder.layers.{i}"
            _x_mha(sd, f"{p}.self_attn", lp["self_attn"])
            _x_ln(sd, f"{p}.self_attn_layer_norm", lp["self_attn_layer_norm"])
            _x_conv(sd, f"{p}.conv1d.conv1", lp["conv1"])
            _x_conv(sd, f"{p}.conv1d.conv2", lp["conv2"])
            _x_ln(sd, f"{p}.conv1d_layer_norm", lp["conv_layer_norm"])
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
        w = _np(p["weight"])
        v = (np.transpose(w, (1, 2, 0)) if transpose     # (k, in, out) -> (in, out, k)
             else np.transpose(w, (2, 1, 0)))            # (k, in, out) -> (out, in, k)
        if dtype is not None:          # the norm of the values the file holds
            v = _np(torch.from_numpy(np.ascontiguousarray(v)).to(dtype).float())
        sd[f"{prefix}.weight_g"] = _t(np.sqrt((v ** 2).sum(
            axis=tuple(range(1, v.ndim)), keepdims=True)))
        sd[f"{prefix}.weight_v"] = _t(v)
        if "bias" in p:
            sd[f"{prefix}.bias"] = _t(_np(p["bias"]))

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
