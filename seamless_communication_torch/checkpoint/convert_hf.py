"""HF ``transformers`` SeamlessM4T(v2) models -> the port's parameter trees
(counterpart of ``seamless_communication_tpu/checkpoint/convert_hf.py``).

The HF weights were converted from the reference release with its
control-symbol permutation, char reorder and dummy-token drop already applied,
so this path needs none of the ``.pt`` path's fixups. Linear weights are
transposed to (in, out), convs to WIO (``(k, in, out)``), transposed convs to
``(k, in, out)``; batch norm and weight norm are folded. The arithmetic of the
folds is the JAX package's, in numpy, so both packages give the same bits.

The trees are the port's: the layers of a stack stay a list (the JAX package
stacks them), and the text encoder shares the text decoder's ``embed`` dict,
as NLLB ties the two tables. ``device.params_to`` moves a tree to a device
and dtype (the JAX package's ``to_jax``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from seamless_communication_torch.checkpoint.from_jax import to_torch


def _np(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _linear(mod) -> dict:
    p = {"weight": _np(mod.weight).T}
    if getattr(mod, "bias", None) is not None:
        p["bias"] = _np(mod.bias)
    return p


def _ln(mod) -> dict:
    return {"scale": _np(mod.weight), "bias": _np(mod.bias)}


def _embed(mod) -> dict:
    return {"embedding": _np(mod.weight)}


def _conv1d(mod) -> dict:
    p = {"weight": np.transpose(_np(mod.weight), (2, 1, 0))}
    if mod.bias is not None:
        p["bias"] = _np(mod.bias)
    return p


def _pointwise(mod) -> dict:
    return {"weight": _np(mod.weight)[:, :, 0].T}


def _conv_transpose1d(mod) -> dict:
    p = {"weight": np.transpose(_np(mod.weight), (2, 0, 1))}
    if mod.bias is not None:
        p["bias"] = _np(mod.bias)
    return p


def _batch_norm_fold(bn) -> dict:
    scale = _np(bn.weight) / np.sqrt(_np(bn.running_var) + bn.eps)
    return {"scale": scale, "bias": _np(bn.bias) - _np(bn.running_mean) * scale}


def _mha(attn) -> dict:
    """HF attention modules name their projections q_proj/k_proj/v_proj/
    out_proj or linear_q/linear_k/linear_v/linear_out."""
    q = getattr(attn, "q_proj", None) or attn.linear_q
    k = getattr(attn, "k_proj", None) or attn.linear_k
    v = getattr(attn, "v_proj", None) or attn.linear_v
    o = getattr(attn, "out_proj", None) or attn.linear_out
    return {"q_proj": _linear(q), "k_proj": _linear(k), "v_proj": _linear(v),
            "output_proj": _linear(o)}


# ---------------------------------------------------------------------------
# speech encoder
# ---------------------------------------------------------------------------

def _speech_ffn(ffn) -> dict:
    return {"inner_proj": _linear(ffn.intermediate_dense),
            "output_proj": _linear(ffn.output_dense)}


def _conformer_layer(lyr, *, v2: bool) -> dict:
    sa = _mha(lyr.self_attn)
    if v2:
        sa["rel_k_embed"] = _embed(lyr.self_attn.distance_embedding)
    else:
        sa["r_proj"] = _linear(lyr.self_attn.linear_pos)
        sa["u_bias"] = _np(lyr.self_attn.pos_bias_u)
        sa["v_bias"] = _np(lyr.self_attn.pos_bias_v)
    cm = lyr.conv_module
    return {
        "ffn1": {"layer_norm": _ln(lyr.ffn1_layer_norm), **_speech_ffn(lyr.ffn1)},
        "self_attn_layer_norm": _ln(lyr.self_attn_layer_norm),
        "self_attn": sa,
        "conv": {"layer_norm": _ln(cm.layer_norm),
                 "pointwise_conv1": _pointwise(cm.pointwise_conv1),
                 "depthwise_conv": _conv1d(cm.depthwise_conv),
                 "norm": (_ln(cm.depthwise_layer_norm) if v2
                          else _batch_norm_fold(cm.batch_norm)),
                 "pointwise_conv2": _pointwise(cm.pointwise_conv2)},
        "ffn2": {"layer_norm": _ln(lyr.ffn2_layer_norm), **_speech_ffn(lyr.ffn2)},
        "layer_norm": _ln(lyr.final_layer_norm),
    }


def _speech_encoder(mod, *, v2: bool) -> dict:
    adaptor = [] if mod.adapter is None else [{
        "residual_layer_norm": _ln(a.residual_layer_norm),
        "residual_conv": _conv1d(a.residual_conv),
        "self_attn_layer_norm": _ln(a.self_attn_layer_norm),
        "self_attn_conv": _conv1d(a.self_attn_conv),
        "self_attn": _mha(a.self_attn),
        "ffn_layer_norm": _ln(a.ffn_layer_norm),
        "ffn": _speech_ffn(a.ffn),
    } for a in mod.adapter.layers]
    return {
        "feature_projection": {"layer_norm": _ln(mod.feature_projection.layer_norm),
                               "projection": _linear(mod.feature_projection.projection)},
        "encoder": [_conformer_layer(lyr, v2=v2) for lyr in mod.encoder.layers],
        "intermediate_ffn": _speech_ffn(mod.intermediate_ffn),
        "inner_layer_norm": _ln(mod.inner_layer_norm),
        "adaptor": adaptor,
    }


def convert_speech_encoder(mod, *, v2: bool = True) -> dict:
    """The w2v-BERT speech encoder: v2 (Shaw relative positions, layer norm
    in the conv module) or v1 (XL relative positions, folded batch norm)."""
    return to_torch(_speech_encoder(mod, v2=v2))


# ---------------------------------------------------------------------------
# text encoder / decoder
# ---------------------------------------------------------------------------

def _text_ffn(lyr) -> dict:
    return {"layer_norm": _ln(lyr.ffn_layer_norm),
            "inner_proj": _linear(lyr.ffn.fc1),
            "output_proj": _linear(lyr.ffn.fc2)}


def _encoder_layer(lyr) -> dict:
    return {"self_attn_layer_norm": _ln(lyr.self_attn_layer_norm),
            "self_attn": _mha(lyr.self_attn),
            "ffn": _text_ffn(lyr)}


def _decoder_layer(lyr) -> dict:
    return {"self_attn_layer_norm": _ln(lyr.self_attn_layer_norm),
            "self_attn": _mha(lyr.self_attn),
            "cross_attn_layer_norm": _ln(lyr.cross_attention_layer_norm),
            "cross_attn": _mha(lyr.cross_attention),
            "ffn": _text_ffn(lyr)}


def _text_stack(mod, layer) -> dict:
    return {"embed": _embed(mod.embed_tokens),
            "stack": {"layers": [layer(lyr) for lyr in mod.layers],
                      "layer_norm": _ln(mod.layer_norm)}}


def convert_text_encoder(mod) -> dict:
    return to_torch(_text_stack(mod, _encoder_layer))


def convert_text_decoder(mod) -> dict:
    return to_torch(_text_stack(mod, _decoder_layer))


# ---------------------------------------------------------------------------
# T2U
# ---------------------------------------------------------------------------

def _vp(mod) -> dict:
    return {"conv1": _conv1d(mod.conv1), "ln1": _ln(mod.ln1),
            "conv2": _conv1d(mod.conv2), "ln2": _ln(mod.ln2),
            "proj": _linear(mod.proj)}


def _nar_t2u(t2u_model, lm_head) -> dict:
    dec = t2u_model.decoder
    return {
        "encoder": {"layers": [_encoder_layer(lyr) for lyr in t2u_model.encoder.layers],
                    "layer_norm": _ln(t2u_model.encoder.layer_norm)},
        "embed_char": _embed(dec.embed_char),
        "pos_emb_alpha_char": _np(dec.pos_emb_alpha_char),
        "pos_emb_alpha": _np(dec.pos_emb_alpha),
        "duration_predictor": _vp(dec.duration_predictor),
        "decoder_layers": [{"self_attn": _mha(lyr.self_attn),
                            "self_attn_layer_norm": _ln(lyr.self_attn_layer_norm),
                            "conv1": _conv1d(lyr.conv1),
                            "conv2": _conv1d(lyr.conv2),
                            "conv_layer_norm": _ln(lyr.conv_layer_norm)}
                           for lyr in dec.layers],
        "layer_norm": _ln(dec.layer_norm),
        "final_proj": _linear(lm_head),
    }


def _ar_t2u(t2u_model) -> dict:
    enc, dec = t2u_model.encoder, t2u_model.decoder
    return {
        "encoder": {"layers": [_encoder_layer(lyr) for lyr in enc.layers],
                    "layer_norm": _ln(enc.layer_norm)},
        "embed": _embed(dec.embed_tokens),
        "decoder": {"layers": [_decoder_layer(lyr) for lyr in dec.layers],
                    "layer_norm": _ln(dec.layer_norm)},
    }


def convert_nar_t2u(t2u_model, lm_head) -> dict:
    """v2 ``SeamlessM4Tv2TextToUnitModel`` (encoder + NAR decoder) and its
    ``lm_head``."""
    return to_torch(_nar_t2u(t2u_model, lm_head))


def convert_ar_t2u(t2u_model, lm_head=None) -> dict:
    """v1 ``SeamlessM4TTextToUnitModel``: an encoder-decoder over the unit
    vocabulary whose output projection is tied to the decoder's embedding
    (``lm_head`` is taken for symmetry and not read)."""
    return to_torch(_ar_t2u(t2u_model))


# ---------------------------------------------------------------------------
# vocoder
# ---------------------------------------------------------------------------

def convert_hf_code_hifigan(mod) -> dict:
    """``SeamlessM4Tv2CodeHifiGan`` (weight norm folded in place where it is
    still on)."""
    try:
        mod.hifi_gan.remove_weight_norm()
    except Exception:
        pass
    hg = mod.hifi_gan
    return to_torch({
        "unit_embedding": _embed(mod.unit_embedding),
        "speaker_embedding": _embed(mod.speaker_embedding),
        "language_embedding": _embed(mod.language_embedding),
        "dur_predictor": _vp(mod.dur_predictor),
        "hifigan": {
            "conv_pre": _conv1d(hg.conv_pre),
            "upsampler": [_conv_transpose1d(u) for u in hg.upsampler],
            "resblocks": [{"convs1": [_conv1d(c) for c in rb.convs1],
                           "convs2": [_conv1d(c) for c in rb.convs2]}
                          for rb in hg.resblocks],
            "conv_post": _conv1d(hg.conv_post),
        },
    })


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def _unity(model, *, v2: bool) -> Dict[str, Any]:
    tree = {"speech_encoder": _speech_encoder(model.speech_encoder, v2=v2),
            "text_decoder": _text_stack(model.text_decoder, _decoder_layer)}
    if getattr(model, "t2u_model", None) is not None:
        tree["t2u"] = (_nar_t2u(model.t2u_model.model, model.t2u_model.lm_head) if v2
                       else _ar_t2u(model.t2u_model.model))
    params = to_torch(tree)
    if getattr(model, "text_encoder", None) is not None:
        enc = to_torch(_text_stack(model.text_encoder, _encoder_layer)["stack"])
        params["text_encoder"] = {"embed": params["text_decoder"]["embed"], "stack": enc}
    return params


def convert_hf_seamless_m4t_v2(model) -> Dict[str, Any]:
    """``SeamlessM4Tv2Model`` -> a port UnitY tree (speech encoder, text
    decoder, text encoder, NAR T2U)."""
    return _unity(model, v2=True)


def convert_hf_seamless_m4t_v1(model) -> Dict[str, Any]:
    """``SeamlessM4TModel`` (v1: XL relative positions, batch-norm conv
    module, AR T2U) -> a port UnitY tree."""
    return _unity(model, v2=False)
