"""The reference's original ``.pt`` checkpoints (fairseq1 or fairseq2 keyed)
-> the port's parameter trees: the UnitY models and the unit HiFi-GAN vocoder
(counterpart of that half of
``seamless_communication_tpu/checkpoint/convert_fairseq2.py``).

The steps are the reference loader's (models/unity/loader.py:27-176): the
fairseq1 -> fairseq2 key remap, the NLLB-100 dummy-token drop, the
control-symbol permutation (BOS, PAD, EOS, UNK) -> (PAD, UNK, BOS, EOS) of the
first four embedding rows, the char-embedding reorder to sorted-SPM order,
the tied embeddings; then fairseq2 module paths map onto the port's tree:
linear weights transposed to (in, out), convs to WIO (``(k, in, out)``),
batch norm and weight norm folded (in numpy, with the JAX package's
arithmetic, so both packages give the same bits).

The state dict stays torch tensors: where the JAX package turns every tensor
into numpy (which fails on a bf16 checkpoint), the port keeps each tensor in
its dtype and widens only the folded ones to fp32. The layers of a stack stay
a list, and the text encoder shares the text decoder's ``embed`` dict.

The SeamlessStreaming EMMA monotonic decoder converts too
(``monotonic_tree_from_pt``, either key space), and SeamlessExpressive: the
expressive UnitY's ECAPA prosody encoder, FiLM layers and prosody projection
(``unity_tree_from_fairseq2``), and the PRETSSEL vocoder
(``pretssel_tree_from_pt``: its flat, interleaved ``layers`` list decoded
by the config, the LSTM's two biases folded into one).

The auxiliary models convert too: the raw-waveform XLSR wav2vec2 of unit
extraction (``wav2vec2_raw_tree_from_pt``, fairseq1 or fairseq2 keys, its
positional conv's weight norm folded), the UnitY2 forced aligner
(``aligner_tree_from_pt``) and the MuToX classifier (``mutox_tree_from_pt``);
so does the standalone conformer-shaw encoder.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# layout helpers (torch layouts -> the port's)
# ---------------------------------------------------------------------------

def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _f32(x) -> np.ndarray:
    """A tensor as a numpy array for a fold's arithmetic: fp32 and fp64 as
    they are, the 16-bit floats widened to fp32."""
    t = _t(x).detach().cpu()
    if t.dtype in (torch.float16, torch.bfloat16):
        t = t.float()
    return t.numpy()


def _lin_w(w) -> torch.Tensor:
    return _t(w).T.contiguous()                          # (out, in) -> (in, out)


def _conv_w(w) -> torch.Tensor:
    return _t(w).permute(2, 1, 0).contiguous()           # (out, in, k) -> (k, in, out)


def _convT_w(w) -> torch.Tensor:
    return _t(w).permute(2, 0, 1).contiguous()           # (in, out, k) -> (k, in, out)


def _fold_weight_norm(g, v) -> torch.Tensor:
    """torch weight norm folded: w = g * v / ||v||, the norm over the axes
    where g has size 1."""
    g, v = _f32(g), _f32(v)
    if g.ndim == v.ndim:
        axes = tuple(i for i in range(v.ndim) if g.shape[i] == 1)
    else:
        axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=g.ndim == v.ndim))
    return torch.from_numpy(g * v / np.maximum(norm, 1e-12))


def _ln(sd: Mapping, prefix: str) -> dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _linear(sd: Mapping, prefix: str) -> dict:
    p = {"weight": _lin_w(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = _t(sd[f"{prefix}.bias"])
    return p


def _conv(sd: Mapping, prefix: str) -> dict:
    p = {"weight": _conv_w(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = _t(sd[f"{prefix}.bias"])
    return p


def _pointwise(sd: Mapping, prefix: str) -> dict:
    return {"weight": _t(sd[f"{prefix}.weight"])[:, :, 0].T.contiguous()}


def _embed(sd: Mapping, prefix: str) -> dict:
    return {"embedding": _t(sd[f"{prefix}.weight"])}


def _bn_fold(sd: Mapping, prefix: str, eps: float = 1e-5) -> dict:
    scale = _f32(sd[f"{prefix}.weight"]) / np.sqrt(_f32(sd[f"{prefix}.running_var"]) + eps)
    bias = _f32(sd[f"{prefix}.bias"]) - _f32(sd[f"{prefix}.running_mean"]) * scale
    return {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}


def _mha(sd: Mapping, prefix: str) -> dict:
    return {"q_proj": _linear(sd, f"{prefix}.q_proj"),
            "k_proj": _linear(sd, f"{prefix}.k_proj"),
            "v_proj": _linear(sd, f"{prefix}.v_proj"),
            "output_proj": _linear(sd, f"{prefix}.output_proj")}


def _num_layers(sd: Mapping, pattern: str) -> int:
    rx = re.compile(pattern)
    idx = {int(m.group(1)) for k in sd if (m := rx.match(k))}
    return max(idx) + 1 if idx else 0


# ---------------------------------------------------------------------------
# fairseq1 -> fairseq2 key remap (reference loader.py:179-389)
# ---------------------------------------------------------------------------

def fairseq1_to_fairseq2(state_dict: Mapping[str, Any], *,
                         has_prosody: bool = False, has_t2u: bool = True,
                         has_text_encoder: bool = True,
                         conformer_adaptor: bool = False) -> Dict[str, torch.Tensor]:
    if has_prosody:
        enc, dec = "s2t_model.encoder", "s2t_model.decoder"
        t2u_enc, t2u_dec = "t2s_model.encoder", "t2s_model.decoder"
    elif has_t2u:
        enc, dec = "encoder", "target_letter_decoder"
        t2u_enc, t2u_dec = "synthesizer_encoder", "decoder"
    elif has_text_encoder:
        enc, dec = "speech_encoder", "shared_decoder"
        t2u_enc = t2u_dec = None
    else:
        enc, dec = "encoder", "decoder"
        t2u_enc = t2u_dec = None

    w2v = rf"^{enc}\.w2v_encoder\.w2v_model"
    rules = [
        # speech frontend
        (rf"{w2v}\.encoder\.pos_conv\.0\.", "speech_encoder_frontend.pos_encoder.conv."),
        (rf"{w2v}\.layer_norm\.", "speech_encoder_frontend.post_extract_layer_norm."),
        (rf"{w2v}\.post_extract_proj\.", "speech_encoder_frontend.model_dim_proj."),
        (rf"{w2v}\.feature_extractor\.conv_layers\.([0-9]+)\.0\.",
         r"speech_encoder_frontend.feature_extractor.layers.\1.conv."),
        (rf"{w2v}\.feature_extractor\.conv_layers\.([0-9]+)\.2\.1\.",
         r"speech_encoder_frontend.feature_extractor.layers.\1.layer_norm."),
        # group-norm variant: only block 0 carries a bare GroupNorm at .2.
        # (loader.py:211); must stay AFTER the .2.1. rule so layer-norm-style
        # block-0 keys keep their layer_norm mapping (first-match order)
        (rf"{w2v}\.feature_extractor\.conv_layers\.0\.2\.",
         "speech_encoder_frontend.feature_extractor.layers.0.group_norm."),
        # conformer layers
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.conv_module\.batch_norm\.",
         r"speech_encoder.inner.layers.\1.conv.batch_norm."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.conv_module\.layer_norm2\.",
         r"speech_encoder.inner.layers.\1.conv.layer_norm."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.conv_module\.depthwise_conv\.",
         r"speech_encoder.inner.layers.\1.conv.depthwise_conv."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.conv_module\.layer_norm\.",
         r"speech_encoder.inner.layers.\1.conv_layer_norm."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.conv_module\.pointwise_conv1\.",
         r"speech_encoder.inner.layers.\1.conv.pointwise_conv1."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.conv_module\.pointwise_conv2\.",
         r"speech_encoder.inner.layers.\1.conv.pointwise_conv2."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.ffn(1|2)\.layer_norm\.",
         r"speech_encoder.inner.layers.\1.ffn\2_layer_norm."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.ffn(1|2)\.w_1\.",
         r"speech_encoder.inner.layers.\1.ffn\2.inner_proj."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.ffn(1|2)\.w_2\.",
         r"speech_encoder.inner.layers.\1.ffn\2.output_proj."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.self_attn_layer_norm\.",
         r"speech_encoder.inner.layers.\1.self_attn_layer_norm."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.self_attn\.linear_(q|k|v)\.",
         r"speech_encoder.inner.layers.\1.self_attn.\2_proj."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.self_attn\.(q|k|v)_proj\.",
         r"speech_encoder.inner.layers.\1.self_attn.\2_proj."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.self_attn\.rel_k_embedding\.",
         r"speech_encoder.inner.layers.\1.self_attn.sdpa.rel_k_embed."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.self_attn\.(?:linear_out|out_proj)\.",
         r"speech_encoder.inner.layers.\1.self_attn.output_proj."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.self_attn\.linear_pos\.",
         r"speech_encoder.inner.layers.\1.self_attn.sdpa.r_proj."),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.self_attn\.pos_bias_u",
         r"speech_encoder.inner.layers.\1.self_attn.sdpa.u_bias"),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.self_attn\.pos_bias_v",
         r"speech_encoder.inner.layers.\1.self_attn.sdpa.v_bias"),
        (rf"{w2v}\.encoder\.layers\.([0-9]+)\.final_layer_norm\.",
         r"speech_encoder.inner.layers.\1.layer_norm."),
        (rf"{w2v}\.encoder\.layer_norm\.", "speech_encoder.inner_layer_norm."),
        # adaptor
        (rf"^{enc}\.adaptor\.proj\.0\.", "speech_encoder.proj1."),
        (rf"^{enc}\.adaptor\.proj\.2\.", "speech_encoder.proj2."),
        (rf"^{enc}\.adaptor\.out_ln\.", "speech_encoder.layer_norm."),
        (rf"^{enc}\.adaptor\.layers\.([0-9]+)\.residual_layer_norm\.",
         r"speech_encoder.adaptor_layers.\1.residual_layer_norm."),
        (rf"^{enc}\.adaptor\.layers\.([0-9]+)\.residual_pool\.1\.",
         r"speech_encoder.adaptor_layers.\1.residual_conv."),
        (rf"^{enc}\.adaptor\.layers\.([0-9]+)\.attn_pool\.1\.",
         r"speech_encoder.adaptor_layers.\1.self_attn_conv."),
        (rf"^{enc}\.adaptor\.layers\.([0-9]+)\.self_attn\.out_proj\.",
         r"speech_encoder.adaptor_layers.\1.self_attn.output_proj."),
        (rf"^{enc}\.adaptor\.layers\.([0-9]+)\.self_attn\.",
         r"speech_encoder.adaptor_layers.\1.self_attn."),
        (rf"^{enc}\.adaptor\.layers\.([0-9]+)\.self_attn_layer_norm\.",
         r"speech_encoder.adaptor_layers.\1.self_attn_layer_norm."),
        (rf"^{enc}\.adaptor\.layers\.([0-9]+)\.fc1\.",
         r"speech_encoder.adaptor_layers.\1.ffn.inner_proj."),
        (rf"^{enc}\.adaptor\.layers\.([0-9]+)\.fc2\.",
         r"speech_encoder.adaptor_layers.\1.ffn.output_proj."),
        (rf"^{enc}\.adaptor\.layers\.([0-9]+)\.final_layer_norm\.",
         r"speech_encoder.adaptor_layers.\1.ffn_layer_norm."),
        # text decoder
        (rf"^{dec}\.embed_tokens\.", "text_decoder_frontend.embed."),
        (rf"^{dec}\.layers\.([0-9]+)\.self_attn\.out_proj\.",
         r"text_decoder.layers.\1.self_attn.output_proj."),
        (rf"^{dec}\.layers\.([0-9]+)\.self_attn\.",
         r"text_decoder.layers.\1.self_attn."),
        (rf"^{dec}\.layers\.([0-9]+)\.self_attn_layer_norm\.",
         r"text_decoder.layers.\1.self_attn_layer_norm."),
        (rf"^{dec}\.layers\.([0-9]+)\.encoder_attn\.out_proj\.",
         r"text_decoder.layers.\1.encoder_decoder_attn.output_proj."),
        (rf"^{dec}\.layers\.([0-9]+)\.encoder_attn\.",
         r"text_decoder.layers.\1.encoder_decoder_attn."),
        (rf"^{dec}\.layers\.([0-9]+)\.encoder_attn_layer_norm\.",
         r"text_decoder.layers.\1.encoder_decoder_attn_layer_norm."),
        (rf"^{dec}\.layers\.([0-9]+)\.fc1\.", r"text_decoder.layers.\1.ffn.inner_proj."),
        (rf"^{dec}\.layers\.([0-9]+)\.fc2\.", r"text_decoder.layers.\1.ffn.output_proj."),
        (rf"^{dec}\.layers\.([0-9]+)\.final_layer_norm\.",
         r"text_decoder.layers.\1.ffn_layer_norm."),
        (rf"^{dec}\.layer_norm\.", "text_decoder.layer_norm."),
        (rf"^{dec}\.output_projection\.", "final_proj."),
    ]
    if has_text_encoder:
        rules += [
            (r"^text_encoder\.embed_tokens\.", "text_encoder_frontend.embed."),
            (r"^text_encoder\.layers\.([0-9]+)\.self_attn\.out_proj\.",
             r"text_encoder.layers.\1.self_attn.output_proj."),
            (r"^text_encoder\.layers\.([0-9]+)\.self_attn\.",
             r"text_encoder.layers.\1.self_attn."),
            (r"^text_encoder\.layers\.([0-9]+)\.self_attn_layer_norm\.",
             r"text_encoder.layers.\1.self_attn_layer_norm."),
            # the reference maps encoder_attn keys under text_encoder too
            # (loader.py:248-250) — inert for the released checkpoints (their
            # text encoders have no cross-attention) but kept for exact key-map
            # parity with the reference table
            (r"^text_encoder\.layers\.([0-9]+)\.encoder_attn\.out_proj\.",
             r"text_encoder.layers.\1.encoder_decoder_attn.output_proj."),
            (r"^text_encoder\.layers\.([0-9]+)\.encoder_attn\.",
             r"text_encoder.layers.\1.encoder_decoder_attn."),
            (r"^text_encoder\.layers\.([0-9]+)\.encoder_attn_layer_norm\.",
             r"text_encoder.layers.\1.encoder_decoder_attn_layer_norm."),
            (r"^text_encoder\.layers\.([0-9]+)\.fc1\.",
             r"text_encoder.layers.\1.ffn.inner_proj."),
            (r"^text_encoder\.layers\.([0-9]+)\.fc2\.",
             r"text_encoder.layers.\1.ffn.output_proj."),
            (r"^text_encoder\.layers\.([0-9]+)\.final_layer_norm\.",
             r"text_encoder.layers.\1.ffn_layer_norm."),
            (r"^text_encoder\.layer_norm\.", "text_encoder.layer_norm."),
        ]
    if t2u_enc is not None:
        rules += [
            (rf"^{t2u_enc}\.layers\.([0-9]+)\.self_attn\.out_proj\.",
             r"t2u_model.encoder.layers.\1.self_attn.output_proj."),
            (rf"^{t2u_enc}\.layers\.([0-9]+)\.self_attn\.",
             r"t2u_model.encoder.layers.\1.self_attn."),
            (rf"^{t2u_enc}\.layers\.([0-9]+)\.self_attn_layer_norm\.",
             r"t2u_model.encoder.layers.\1.self_attn_layer_norm."),
            (rf"^{t2u_enc}\.layers\.([0-9]+)\.fc1\.",
             r"t2u_model.encoder.layers.\1.ffn.inner_proj."),
            (rf"^{t2u_enc}\.layers\.([0-9]+)\.fc2\.",
             r"t2u_model.encoder.layers.\1.ffn.output_proj."),
            (rf"^{t2u_enc}\.layers\.([0-9]+)\.final_layer_norm\.",
             r"t2u_model.encoder.layers.\1.ffn_layer_norm."),
            (rf"^{t2u_enc}\.layer_norm\.", "t2u_model.encoder.layer_norm."),
            # t2u decoder frontend
            (rf"^{t2u_dec}\.embed_tokens_text\.", "t2u_model.decoder_frontend.embed_char."),
            (rf"^{t2u_dec}\.embed_tokens_unit\.", "t2u_model.decoder_frontend.embed."),
            (rf"^{t2u_dec}\.embed_tokens\.", "t2u_model.decoder_frontend.embed."),
            (rf"^{t2u_dec}\.var_adaptor\.duration_predictor\.",
             "t2u_model.decoder_frontend.variance_adaptor.duration_predictor."),
            (rf"^{t2u_dec}\.dec_pos_emb_alpha", "t2u_model.decoder_frontend.pos_emb_alpha"),
            (rf"^{t2u_dec}\.char_upsampler\.pos_emb_alpha",
             "t2u_model.decoder_frontend.pos_emb_alpha_char"),
            # t2u decoder layers
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.self_attn\.out_proj\.",
             r"t2u_model.decoder.layers.\1.self_attn.output_proj."),
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.self_attn\.",
             r"t2u_model.decoder.layers.\1.self_attn."),
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.(?:self_attn_layer_norm|layer_norm)\.",
             r"t2u_model.decoder.layers.\1.self_attn_layer_norm."),
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.encoder_attn\.out_proj\.",
             r"t2u_model.decoder.layers.\1.encoder_decoder_attn.output_proj."),
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.encoder_attn\.",
             r"t2u_model.decoder.layers.\1.encoder_decoder_attn."),
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.encoder_attn_layer_norm\.",
             r"t2u_model.decoder.layers.\1.encoder_decoder_attn_layer_norm."),
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.fc1\.",
             r"t2u_model.decoder.layers.\1.ffn.inner_proj."),
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.fc2\.",
             r"t2u_model.decoder.layers.\1.ffn.output_proj."),
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.final_layer_norm\.",
             r"t2u_model.decoder.layers.\1.ffn_layer_norm."),
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.ffn\.ffn\.0\.",
             r"t2u_model.decoder.layers.\1.conv1d.conv1."),
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.ffn\.ffn\.2\.",
             r"t2u_model.decoder.layers.\1.conv1d.conv2."),
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.ffn\.layer_norm\.",
             r"t2u_model.decoder.layers.\1.conv1d_layer_norm."),
            (rf"^{t2u_dec}\.layer_norm\.", "t2u_model.decoder.layer_norm."),
            (rf"^{t2u_dec}\.output_projection\.", "t2u_model.final_proj."),
        ]
    if has_prosody:
        rules += [
            (rf"^{t2u_dec}\.layers\.([0-9]+)\.film\.",
             r"t2u_model.decoder.layers.\1.film."),
            (r"^global_prosody\.", "prosody_encoder_model."),
            (r"^t2s_model\.global_proj_enc\.", "t2u_model.prosody_proj."),
        ]

    out: Dict[str, torch.Tensor] = {}
    compiled = [(re.compile(p), r) for p, r in rules]
    for key, val in state_dict.items():
        for rx, repl in compiled:
            if rx.match(key):
                out[rx.sub(repl, key)] = _t(val)
                break
        # unmatched keys (versions, float_tensors, mask_emb, aligner...) dropped
    return out


def is_fairseq1_unity(sd: Mapping[str, Any]) -> bool:
    """True for original fairseq1-keyed UnitY checkpoints (all released .pt
    files); fairseq2-native key spaces pass through untouched."""
    return any(".w2v_model." in k for k in sd)


def fairseq1_to_fairseq2_auto(
        state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """fairseq1_to_fairseq2 with the family flags detected from the key
    prefixes themselves (the reference derives them from the model config;
    the prefixes are unambiguous per family — loader.py:183-200):
    's2t_model.*' = expressive (prosody), 'target_letter_decoder.*' = UnitY
    with t2u, 'shared_decoder.*' = S2T-only with text encoder."""
    has_prosody = any(k.startswith("s2t_model.") for k in state_dict)
    # synthesizer_encoder marks the t2u prefix set even when the checkpoint
    # carries NO text decoder (seamless_streaming_unity: the reference loads
    # it with use_text_decoder=False and t2u_config set, so its 'decoder.*'
    # keys are the T2U decoder — unity_pipeline.py:113-121)
    has_t2u = has_prosody or any(
        k.startswith(("target_letter_decoder.", "synthesizer_encoder."))
        for k in state_dict)
    has_text_encoder = any(k.startswith("text_encoder.") for k in state_dict)
    return fairseq1_to_fairseq2(state_dict, has_prosody=has_prosody,
                                has_t2u=has_t2u,
                                has_text_encoder=has_text_encoder)



def apply_unity_fixups(sd: Dict[str, Any], *, is_nllb_100: Optional[bool] = None,
                       char_spm_pieces: Optional[Sequence[str]] = None,
                       has_text_encoder: bool = True) -> Dict[str, Any]:
    """The embedding fixups (reference loader.py:116-155), in place on a
    fairseq2-keyed state dict. ``is_nllb_100=None`` detects the 256103-row
    fairseq NLLB-100 table; a state dict without a text decoder's
    ``final_proj`` (seamless_streaming_unity) gets none of the text ones."""
    if is_nllb_100 is None:
        fp = sd.get("final_proj.weight")
        is_nllb_100 = fp is not None and tuple(fp.shape)[0] == 256103
    if "final_proj.weight" in sd:
        embeds = _t(sd["final_proj.weight"])
        if is_nllb_100 and embeds.shape[0] == 256103:
            embeds = embeds[:-1]
        # control-symbol permutation (BOS, PAD, EOS, UNK) -> (PAD, UNK, BOS, EOS)
        embeds = embeds.clone()
        embeds[[0, 1, 2, 3]] = embeds[[1, 3, 0, 2]].clone()
        sd["final_proj.weight"] = embeds
        sd["text_decoder_frontend.embed.weight"] = embeds
        if has_text_encoder:
            sd["text_encoder_frontend.embed.weight"] = embeds
    ce = sd.get("t2u_model.decoder_frontend.embed_char.weight")
    if ce is not None and char_spm_pieces is not None:
        # rows from the model's (SPM) order to the dictionary's (sorted
        # pieces) order, loader.py:158-176
        spm_order = list(char_spm_pieces)[4:] if len(char_spm_pieces) > 4 else []
        spm_to_dict = {ch: i for i, ch in enumerate(sorted(spm_order), start=4)}
        mapping = [0, 1, 2, 3] + [spm_to_dict[ch] for ch in spm_order]
        ce = _t(ce).clone()
        ce[torch.arange(len(mapping))] = ce[mapping].clone()
        sd["t2u_model.decoder_frontend.embed_char.weight"] = ce
    if ("t2u_model.final_proj.weight" in sd
            and "t2u_model.decoder_frontend.embed.weight" in sd):
        sd["t2u_model.decoder_frontend.embed.weight"] = sd["t2u_model.final_proj.weight"]
    return sd


# ---------------------------------------------------------------------------
# fairseq2 paths -> the port's tree
# ---------------------------------------------------------------------------

def _conformer_layer_tree(sd: Mapping, p: str) -> dict:
    """One conformer block (ffn1, self-attention (Shaw or XL), conv module,
    ffn2) at fairseq2 path prefix ``p``."""
    sa = _mha(sd, f"{p}.self_attn")
    if f"{p}.self_attn.sdpa.rel_k_embed.weight" in sd:
        sa["rel_k_embed"] = _embed(sd, f"{p}.self_attn.sdpa.rel_k_embed")
    if f"{p}.self_attn.sdpa.r_proj.weight" in sd:
        sa["r_proj"] = _linear(sd, f"{p}.self_attn.sdpa.r_proj")
        sa["u_bias"] = _t(sd[f"{p}.self_attn.sdpa.u_bias"])
        sa["v_bias"] = _t(sd[f"{p}.self_attn.sdpa.v_bias"])
    conv = {
        "layer_norm": _ln(sd, f"{p}.conv_layer_norm"),
        "pointwise_conv1": _pointwise(sd, f"{p}.conv.pointwise_conv1"),
        "depthwise_conv": _conv(sd, f"{p}.conv.depthwise_conv"),
        "norm": (_ln(sd, f"{p}.conv.layer_norm")
                 if f"{p}.conv.layer_norm.weight" in sd
                 else _bn_fold(sd, f"{p}.conv.batch_norm")),
        "pointwise_conv2": _pointwise(sd, f"{p}.conv.pointwise_conv2"),
    }
    return {
        "ffn1": {"layer_norm": _ln(sd, f"{p}.ffn1_layer_norm"),
                 "inner_proj": _linear(sd, f"{p}.ffn1.inner_proj"),
                 "output_proj": _linear(sd, f"{p}.ffn1.output_proj")},
        "self_attn_layer_norm": _ln(sd, f"{p}.self_attn_layer_norm"),
        "self_attn": sa,
        "conv": conv,
        "ffn2": {"layer_norm": _ln(sd, f"{p}.ffn2_layer_norm"),
                 "inner_proj": _linear(sd, f"{p}.ffn2.inner_proj"),
                 "output_proj": _linear(sd, f"{p}.ffn2.output_proj")},
        "layer_norm": _ln(sd, f"{p}.layer_norm"),
    }


def unity_tree_from_fairseq2(sd: Mapping, *, v2: bool = True) -> dict:
    """A fairseq2-keyed UnitY state dict -> the port's UnitY tree: speech
    encoder, text decoder and text encoder (where the state dict has them;
    the encoder shares the decoder's embedding), NAR (v2) or AR (v1) T2U.
    ``v2`` is taken as the JAX package takes it; the layers' keys decide.
    An expressive checkpoint adds the ECAPA prosody encoder and the T2U's
    FiLM layers and prosody projection."""
    n_enc = _num_layers(sd, r"speech_encoder\.inner\.layers\.([0-9]+)\.")
    n_adapt = _num_layers(sd, r"speech_encoder\.adaptor_layers\.([0-9]+)\.")
    adaptors = []
    for i in range(n_adapt):
        p = f"speech_encoder.adaptor_layers.{i}"
        adaptors.append({
            "residual_layer_norm": _ln(sd, f"{p}.residual_layer_norm"),
            "residual_conv": _conv(sd, f"{p}.residual_conv"),
            "self_attn_layer_norm": _ln(sd, f"{p}.self_attn_layer_norm"),
            "self_attn_conv": _conv(sd, f"{p}.self_attn_conv"),
            "self_attn": _mha(sd, f"{p}.self_attn"),
            "ffn_layer_norm": _ln(sd, f"{p}.ffn_layer_norm"),
            "ffn": {"inner_proj": _linear(sd, f"{p}.ffn.inner_proj"),
                    "output_proj": _linear(sd, f"{p}.ffn.output_proj")},
        })
    params: dict = {
        "speech_encoder": {
            "feature_projection": {
                "layer_norm": _ln(sd, "speech_encoder_frontend.post_extract_layer_norm"),
                "projection": _linear(sd, "speech_encoder_frontend.model_dim_proj"),
            },
            "encoder": [_conformer_layer_tree(sd, f"speech_encoder.inner.layers.{i}")
                        for i in range(n_enc)],
            "intermediate_ffn": {"inner_proj": _linear(sd, "speech_encoder.proj1"),
                                 "output_proj": _linear(sd, "speech_encoder.proj2")},
            # fairseq2's post-conformer LN and the adaptor's out_ln collapse to
            # inner_layer_norm (applied before the expansion) and layer_norm
            "inner_layer_norm": _ln(sd, "speech_encoder.layer_norm"),
            "adaptor": adaptors,
        },
    }
    # seamless_streaming_unity has no text decoder
    if "text_decoder.layer_norm.weight" in sd:
        params["text_decoder"] = _decoder_tree(sd, "text_decoder",
                                               "text_decoder_frontend.embed")
    if "text_encoder.layer_norm.weight" in sd:
        enc = _encoder_tree(sd, "text_encoder", "text_encoder_frontend.embed")
        if "text_decoder" in params:
            enc["embed"] = params["text_decoder"]["embed"]
        params["text_encoder"] = enc
    # NAR (v2) T2U layers carry conv1d blocks, AR (v1) ones cross-attention
    if "t2u_model.decoder.layers.0.conv1d.conv1.weight" in sd:
        params["t2u"] = _nar_t2u_tree(sd)
    elif "t2u_model.decoder.layers.0.encoder_decoder_attn.q_proj.weight" in sd:
        params["t2u"] = _ar_t2u_tree(sd)
    # the expressive models' prosody encoder (global_prosody)
    if "prosody_encoder_model.fc.weight" in sd:
        params["prosody_encoder"] = ecapa_tree_from_fairseq2(sd, prefix="prosody_encoder_model")
    return params


def _encoder_tree(sd, prefix, embed_prefix) -> dict:
    n = _num_layers(sd, rf"{prefix}\.layers\.([0-9]+)\.")
    layers = [{
        "self_attn_layer_norm": _ln(sd, f"{prefix}.layers.{i}.self_attn_layer_norm"),
        "self_attn": _mha(sd, f"{prefix}.layers.{i}.self_attn"),
        "ffn": {"layer_norm": _ln(sd, f"{prefix}.layers.{i}.ffn_layer_norm"),
                "inner_proj": _linear(sd, f"{prefix}.layers.{i}.ffn.inner_proj"),
                "output_proj": _linear(sd, f"{prefix}.layers.{i}.ffn.output_proj")},
    } for i in range(n)]
    return {"embed": _embed(sd, embed_prefix),
            "stack": {"layers": layers, "layer_norm": _ln(sd, f"{prefix}.layer_norm")}}


def _decoder_tree(sd, prefix, embed_prefix) -> dict:
    n = _num_layers(sd, rf"{prefix}\.layers\.([0-9]+)\.")
    layers = [{
        "self_attn_layer_norm": _ln(sd, f"{prefix}.layers.{i}.self_attn_layer_norm"),
        "self_attn": _mha(sd, f"{prefix}.layers.{i}.self_attn"),
        "cross_attn_layer_norm": _ln(
            sd, f"{prefix}.layers.{i}.encoder_decoder_attn_layer_norm"),
        "cross_attn": _mha(sd, f"{prefix}.layers.{i}.encoder_decoder_attn"),
        "ffn": {"layer_norm": _ln(sd, f"{prefix}.layers.{i}.ffn_layer_norm"),
                "inner_proj": _linear(sd, f"{prefix}.layers.{i}.ffn.inner_proj"),
                "output_proj": _linear(sd, f"{prefix}.layers.{i}.ffn.output_proj")},
    } for i in range(n)]
    return {"embed": _embed(sd, embed_prefix),
            "stack": {"layers": layers, "layer_norm": _ln(sd, f"{prefix}.layer_norm")}}


def _nar_t2u_tree(sd) -> dict:
    """The NAR T2U; an expressive checkpoint's FiLM layers (the duration
    predictor's, every decoder layer's) and ``prosody_proj`` where present."""
    enc = _encoder_tree(sd, "t2u_model.encoder", "t2u_model.decoder_frontend.embed")
    one = torch.ones(1, dtype=torch.float64)     # the JAX package's np.ones(1)
    vp = "t2u_model.decoder_frontend.variance_adaptor.duration_predictor"
    layers, _ = _fft_layers_tree(sd, "t2u_model.decoder")
    p = {
        "encoder": enc["stack"],
        "embed_char": _embed(sd, "t2u_model.decoder_frontend.embed_char"),
        "pos_emb_alpha_char": _t(sd.get("t2u_model.decoder_frontend.pos_emb_alpha_char",
                                        one)),
        "pos_emb_alpha": _t(sd.get("t2u_model.decoder_frontend.pos_emb_alpha", one)),
        "duration_predictor": _variance_predictor_tree(sd, vp),
        "decoder_layers": layers,
        "layer_norm": _ln(sd, "t2u_model.decoder.layer_norm"),
        "final_proj": _linear(sd, "t2u_model.final_proj"),
    }
    if "t2u_model.prosody_proj.weight" in sd:
        p["prosody_proj"] = _linear(sd, "t2u_model.prosody_proj")
    return p


def _film(sd, prefix: str) -> dict:
    return {"proj": _linear(sd, f"{prefix}.proj"), "s_gamma": _t(sd[f"{prefix}.s_gamma"]),
            "s_beta": _t(sd[f"{prefix}.s_beta"])}


def _fft_layers_tree(sd, prefix: str) -> tuple:
    """FFT layers ``{prefix}.layers.N.{self_attn, self_attn_layer_norm,
    conv1d.conv1/conv2, conv1d_layer_norm, film}`` and the stack's final
    ``layer_norm`` where it has one (the NAR T2U's; PRETSSEL's post-norm
    stacks have none) -> (list of layers, norm or None)."""
    n = _num_layers(sd, rf"{re.escape(prefix)}\.layers\.([0-9]+)\.")
    layers = []
    for i in range(n):
        p = f"{prefix}.layers.{i}"
        lp = {"self_attn": _mha(sd, f"{p}.self_attn"),
              "self_attn_layer_norm": _ln(sd, f"{p}.self_attn_layer_norm"),
              "conv1": _conv(sd, f"{p}.conv1d.conv1"),
              "conv2": _conv(sd, f"{p}.conv1d.conv2"),
              "conv_layer_norm": _ln(sd, f"{p}.conv1d_layer_norm")}
        if f"{p}.film.proj.weight" in sd:
            lp["film"] = _film(sd, f"{p}.film")
        layers.append(lp)
    norm = _ln(sd, f"{prefix}.layer_norm") if f"{prefix}.layer_norm.weight" in sd else None
    return layers, norm


def _variance_predictor_tree(sd, prefix: str) -> dict:
    def vconv(name):
        return (_conv(sd, f"{prefix}.{name}.0") if f"{prefix}.{name}.0.weight" in sd
                else _conv(sd, f"{prefix}.{name}"))

    p = {"conv1": vconv("conv1"), "ln1": _ln(sd, f"{prefix}.ln1"),
         "conv2": vconv("conv2"), "ln2": _ln(sd, f"{prefix}.ln2"),
         "proj": _linear(sd, f"{prefix}.proj")}
    if f"{prefix}.film.proj.weight" in sd:
        p["film"] = _film(sd, f"{prefix}.film")
    return p


def _ar_t2u_tree(sd) -> dict:
    """AR T2U (v1): an encoder-decoder over the unit vocabulary with the
    output projection tied to the decoder's embedding."""
    dec = _decoder_tree(sd, "t2u_model.decoder", "t2u_model.decoder_frontend.embed")
    p = {"embed": dec["embed"], "decoder": dec["stack"]}
    if "t2u_model.encoder.layer_norm.weight" in sd:
        p["encoder"] = _encoder_tree(sd, "t2u_model.encoder",
                                     "t2u_model.decoder_frontend.embed")["stack"]
    return p


# ---------------------------------------------------------------------------
# unit HiFi-GAN vocoder (raw speech-resynthesis keys)
# ---------------------------------------------------------------------------

def vocoder_tree_from_pt(sd: Mapping) -> dict:
    """Keys code_generator.{dict, spkr, lang, dur_predictor, conv_pre, ups,
    resblocks, conv_post}, the convs with weight-norm g/v pairs (reference
    vocoder/loader.py:20-37)."""
    g = "code_generator"

    def conv_wn(prefix, transpose=False):
        return _conv_wn(sd, prefix, transpose=transpose)

    n_ups = _num_layers(sd, rf"{g}\.ups\.([0-9]+)\.")
    n_res = _num_layers(sd, rf"{g}\.resblocks\.([0-9]+)\.")
    resblocks = []
    for i in range(n_res):
        n_c = _num_layers(sd, rf"{g}\.resblocks\.{i}\.convs1\.([0-9]+)\.")
        resblocks.append({
            "convs1": [conv_wn(f"{g}.resblocks.{i}.convs1.{j}") for j in range(n_c)],
            "convs2": [conv_wn(f"{g}.resblocks.{i}.convs2.{j}") for j in range(n_c)],
        })
    dp = f"{g}.dur_predictor"
    return {
        "unit_embedding": _embed(sd, f"{g}.dict"),
        "speaker_embedding": _embed(sd, f"{g}.spkr"),
        "language_embedding": _embed(sd, f"{g}.lang"),
        "dur_predictor": {"conv1": _conv(sd, f"{dp}.conv1.0"), "ln1": _ln(sd, f"{dp}.ln1"),
                          "conv2": _conv(sd, f"{dp}.conv2.0"), "ln2": _ln(sd, f"{dp}.ln2"),
                          "proj": _linear(sd, f"{dp}.proj")},
        "hifigan": {
            "conv_pre": conv_wn(f"{g}.conv_pre"),
            "upsampler": [conv_wn(f"{g}.ups.{i}", transpose=True) for i in range(n_ups)],
            "resblocks": resblocks,
            "conv_post": conv_wn(f"{g}.conv_post"),
        },
    }


def _conv_wn(sd, prefix: str, *, transpose: bool = False) -> dict:
    """A conv whose weight may be a weight-norm g/v pair (folded)."""
    if f"{prefix}.weight_g" in sd:
        w = _fold_weight_norm(sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"])
    else:
        w = _t(sd[f"{prefix}.weight"])
    p = {"weight": _convT_w(w) if transpose else _conv_w(w)}
    if f"{prefix}.bias" in sd:
        p["bias"] = _t(sd[f"{prefix}.bias"])
    return p


# ---------------------------------------------------------------------------
# ECAPA-TDNN (the expressive models' prosody encoder)
# ---------------------------------------------------------------------------

def ecapa_tree_from_fairseq2(sd: Mapping, *, prefix: str = "prosody_encoder_model"
                             ) -> dict:
    """Keys {prefix}.blocks.0 (TDNN), blocks.1..N (SE-Res2Net: tdnn1,
    res2net_block.blocks.j, tdnn2, se_block.conv1/2, shortcut where the
    widths differ), mfa, asp.{tdnn, conv}, asp_norm, fc -> the tree of
    ``models/pretssel/ecapa_tdnn.py``."""
    def tdnn(p):
        return {"conv": _conv(sd, f"{p}.conv"), "norm": _ln(sd, f"{p}.norm")}

    n_blocks = _num_layers(sd, rf"{re.escape(prefix)}\.blocks\.([0-9]+)\.")
    blocks = [tdnn(f"{prefix}.blocks.0")]
    for i in range(1, n_blocks):
        p = f"{prefix}.blocks.{i}"
        n_r = _num_layers(sd, rf"{re.escape(p)}\.res2net_block\.blocks\.([0-9]+)\.")
        b = {"tdnn1": tdnn(f"{p}.tdnn1"),
             "res2net": {"blocks": [tdnn(f"{p}.res2net_block.blocks.{j}")
                                    for j in range(n_r)]},
             "tdnn2": tdnn(f"{p}.tdnn2"),
             "se": {"conv1": _conv(sd, f"{p}.se_block.conv1"),
                    "conv2": _conv(sd, f"{p}.se_block.conv2")}}
        if f"{p}.shortcut.weight" in sd:
            b["shortcut"] = _conv(sd, f"{p}.shortcut")
        blocks.append(b)
    return {"blocks": blocks, "mfa": tdnn(f"{prefix}.mfa"),
            "asp_tdnn": tdnn(f"{prefix}.asp.tdnn"),
            "asp_conv": _conv(sd, f"{prefix}.asp.conv"),
            "asp_norm": _ln(sd, f"{prefix}.asp_norm"),
            "fc": _conv(sd, f"{prefix}.fc")}


# ---------------------------------------------------------------------------
# the PRETSSEL expressive vocoder (fairseq2 module paths)
# ---------------------------------------------------------------------------

def _lstm_tree(sd, prefix: str) -> list:
    """torch LSTM keys -> [{"wx": {weight, bias}, "wh": {weight}}] a layer,
    the two biases folded into ``wx``'s, as the JAX package folds them."""
    layers = []
    k = 0
    while f"{prefix}.weight_ih_l{k}" in sd:
        layers.append({"wx": {"weight": _lin_w(sd[f"{prefix}.weight_ih_l{k}"]),
                              "bias": _t(sd[f"{prefix}.bias_ih_l{k}"])
                              + _t(sd[f"{prefix}.bias_hh_l{k}"])},
                       "wh": {"weight": _lin_w(sd[f"{prefix}.weight_hh_l{k}"])}})
        k += 1
    return layers


def pretssel_tree_from_pt(sd: Mapping, cfg) -> dict:
    """A PRETSSEL checkpoint -> the tree of ``models/pretssel/vocoder.py``.

    ``cfg`` (a ``PretsselConfig``) decodes the reference's flat ``layers``
    list: the postnet's convs first, then the SEANet stream layers in four
    chunks, interleaved with the HiFi-GAN's conv_pre, upsamplers, resblocks
    and conv_post. The gcmvn statistics are card data, not checkpoint
    tensors: they stay at the identity for the caller to fill."""
    pn = cfg.pn_layers
    n_ups = len(cfg.hifigan.upsample_rates)
    n_k = len(cfg.hifigan.resblock_kernel_sizes)
    n_ratios = len(cfg.seanet.ratios)
    n_streams = 6 * n_ratios + 8
    chunk = n_streams // 4

    def li(s: int) -> str:
        """A stream layer's position -> its index in the flat list."""
        if s < chunk:
            idx = pn + s
        elif s < 2 * chunk:
            idx = pn + 1 + s
        elif s < 3 * chunk:
            idx = pn + 1 + n_ups + s
        else:
            idx = pn + 1 + n_ups + n_ups * n_k + s
        return f"layers.{idx}"

    def sconv(s: int) -> dict:
        return _conv_wn(sd, f"{li(s)}.conv.conv")

    def sres(s: int) -> dict:
        p = {"conv1": _conv_wn(sd, f"{li(s)}.block.1.conv.conv"),
             "conv2": _conv_wn(sd, f"{li(s)}.block.3.conv.conv")}
        if f"{li(s)}.shortcut.conv.conv.weight" in sd:
            p["shortcut"] = _conv_wn(sd, f"{li(s)}.shortcut.conv.conv")
        return p

    r = n_ratios
    seanet: dict = {
        "enc_in": sconv(0),
        "enc_blocks": [{"res": sres(1 + 3 * i), "down": sconv(3 + 3 * i)}
                       for i in range(r)],
        "enc_lstm": _lstm_tree(sd, f"{li(1 + 3 * r)}.lstm"),
        "enc_out": sconv(3 + 3 * r),
        "dec_in": sconv(4 + 3 * r),
        "dec_lstm": _lstm_tree(sd, f"{li(5 + 3 * r)}.lstm"),
        "dec_blocks": [{"up": _conv_wn(sd, f"{li(7 + 3 * r + 3 * i)}.convtr.convtr",
                                       transpose=True),
                        "res": sres(8 + 3 * r + 3 * i)} for i in range(r)],
        "dec_out": sconv(7 + 6 * r),
    }
    resblocks = []
    for i in range(n_ups):
        for j in range(n_k):
            p = f"layers.{pn + 3 * chunk + n_ups + 1 + i * n_k + j}"
            n_c = _num_layers(sd, rf"{re.escape(p)}\.convs1\.([0-9]+)\.")
            resblocks.append({"convs1": [_conv_wn(sd, f"{p}.convs1.{c}") for c in range(n_c)],
                              "convs2": [_conv_wn(sd, f"{p}.convs2.{c}") for c in range(n_c)]})
    hifigan = {
        "conv_pre": _conv_wn(sd, f"layers.{pn + chunk}"),
        "upsampler": [_conv_wn(sd, f"layers.{pn + 2 * chunk + 1 + i}", transpose=True)
                      for i in range(n_ups)],
        "resblocks": resblocks,
        "conv_post": _conv_wn(sd, f"layers.{pn + n_streams + n_ups * (1 + n_k) + 1}"),
    }
    va = "decoder_frontend.variance_adaptor"
    mean, scale = _t(sd["mean"]), _t(sd["scale"])
    return {
        "prosody_encoder": ecapa_tree_from_fairseq2(
            sd, prefix="encoder_frontend.prosody_encoder"),
        "embed_tokens": _embed(sd, "encoder_frontend.embed_tokens"),
        "embed_lang": _embed(sd, "encoder_frontend.embed_lang"),
        "pos_emb_alpha_enc": _t(sd["encoder_frontend.pos_emb_alpha"]),
        "pos_emb_alpha_dec": _t(sd["decoder_frontend.pos_emb_alpha"]),
        "encoder_layers": _fft_layers_tree(sd, "encoder")[0],
        "pitch_predictor": _variance_predictor_tree(sd, f"{va}.pitch_predictor"),
        "embed_pitch": _conv(sd, f"{va}.embed_pitch"),
        "vuv_predictor": _variance_predictor_tree(sd, f"{va}.vuv_predictor"),
        "energy_predictor": _variance_predictor_tree(sd, f"{va}.energy_predictor"),
        "embed_energy": _conv(sd, f"{va}.embed_energy"),
        "decoder_layers": _fft_layers_tree(sd, "decoder")[0],
        "final_proj": _linear(sd, "final_proj"),
        # postnet: Sequential(Conv1d, BatchNorm1d, [Tanh], Dropout), BN folded
        "postnet": [{"conv": _conv(sd, f"layers.{i}.0"), "norm": _bn_fold(sd, f"layers.{i}.1")}
                    for i in range(pn)],
        "hifigan": hifigan,
        "seanet": seanet,
        "mean": mean,
        "scale": scale,
        "gcmvn_mean": torch.zeros_like(mean),
        "gcmvn_std": torch.ones_like(scale),
    }


# ---------------------------------------------------------------------------
# the EMMA monotonic decoder (reference monotonic_decoder/loader.py:22-77)
# ---------------------------------------------------------------------------

_MONOTONIC_RULES = [
    (r"^decoder\.embed_tokens\.", "text_decoder_frontend.embed."),
    (r"^decoder\.layers\.([0-9]+)\.self_attn\.out_proj\.",
     r"text_decoder.layers.\1.self_attn.output_proj."),
    (r"^decoder\.layers\.([0-9]+)\.self_attn\.", r"text_decoder.layers.\1.self_attn."),
    (r"^decoder\.layers\.([0-9]+)\.self_attn_layer_norm\.",
     r"text_decoder.layers.\1.self_attn_layer_norm."),
    (r"^decoder\.layers\.([0-9]+)\.encoder_attn\.out_proj\.",
     r"text_decoder.layers.\1.encoder_decoder_attn.output_proj."),
    (r"^decoder\.layers\.([0-9]+)\.encoder_attn\.energy_bias",
     r"text_decoder.layers.\1.p_choose_layer.energy_bias"),
    (r"^decoder\.layers\.([0-9]+)\.encoder_attn\.source_energy_layer\.",
     r"text_decoder.layers.\1.p_choose_layer.k_energy_proj."),
    (r"^decoder\.layers\.([0-9]+)\.encoder_attn\.target_energy_layer\.",
     r"text_decoder.layers.\1.p_choose_layer.q_energy_proj."),
    (r"^decoder\.layers\.([0-9]+)\.encoder_attn\.",
     r"text_decoder.layers.\1.encoder_decoder_attn."),
    (r"^decoder\.layers\.([0-9]+)\.encoder_attn_layer_norm\.",
     r"text_decoder.layers.\1.encoder_decoder_attn_layer_norm."),
    (r"^decoder\.layers\.([0-9]+)\.fc1\.", r"text_decoder.layers.\1.ffn.inner_proj."),
    (r"^decoder\.layers\.([0-9]+)\.fc2\.", r"text_decoder.layers.\1.ffn.output_proj."),
    (r"^decoder\.layers\.([0-9]+)\.final_layer_norm\.",
     r"text_decoder.layers.\1.ffn_layer_norm."),
    (r"^decoder\.layer_norm\.", "text_decoder.layer_norm."),
    (r"^decoder\.output_projection\.", "final_proj."),
]


def monotonic_fairseq1_to_fairseq2(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A fairseq1 ``decoder.*``-keyed monotonic (EMMA) checkpoint -> the
    fairseq2 key space, as the reference's ``convert_monotonic_checkpoint``:
    the key remap (the energy layers' rules before the generic
    ``encoder_attn`` one: the first match wins), the NLLB-100 dummy-row drop,
    the control-symbol permutation (BOS, PAD, EOS, UNK) -> (PAD, UNK, BOS,
    EOS) of the first four rows, and the embedding tied to ``final_proj``.
    Unmatched keys (versions, float tensors) are dropped."""
    compiled = [(re.compile(p), r) for p, r in _MONOTONIC_RULES]
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        for rx, repl in compiled:
            if rx.match(key):
                out[rx.sub(repl, key)] = _t(val)
                break
    embeds = out["final_proj.weight"]
    if embeds.shape[0] == 256103:       # the NLLB-100 dummy token
        embeds = embeds[:-1]
    embeds = embeds.clone()
    embeds[[0, 1, 2, 3]] = embeds[[1, 3, 0, 2]].clone()
    out["final_proj.weight"] = embeds
    out["text_decoder_frontend.embed.weight"] = embeds
    return out


def monotonic_tree_from_pt(sd: Mapping[str, Any]) -> dict:
    """A monotonic decoder state dict in either key space -> the port's
    tree; fairseq2-native checkpoints are told apart as the reference does
    (a ``text_decoder.layers.0.self_attn.k_proj.weight`` key)."""
    if "text_decoder.layers.0.self_attn.k_proj.weight" not in sd:
        sd = monotonic_fairseq1_to_fairseq2(sd)
    return monotonic_tree_from_fairseq2(sd)


def monotonic_tree_from_fairseq2(sd: Mapping[str, Any]) -> dict:
    """A fairseq2-keyed monotonic decoder -> ``{"embed", "layers": [per-layer
    dicts], "layer_norm"}``. The energy MLPs are torch Sequentials (Linear,
    ReLU, ...): their linears are the indices that have a weight, in order."""
    layers = []
    for i in range(_num_layers(sd, r"text_decoder\.layers\.([0-9]+)\.")):
        p = f"text_decoder.layers.{i}"
        pc = f"{p}.p_choose_layer"
        rx = re.compile(rf"{re.escape(pc)}\.q_energy_proj\.layers\.([0-9]+)\.weight$")
        idx = sorted({int(m.group(1)) for k in sd if (m := rx.match(k))})
        layers.append({
            "self_attn_layer_norm": _ln(sd, f"{p}.self_attn_layer_norm"),
            "self_attn": _mha(sd, f"{p}.self_attn"),
            "cross_attn_layer_norm": _ln(sd, f"{p}.encoder_decoder_attn_layer_norm"),
            "cross_attn": _mha(sd, f"{p}.encoder_decoder_attn"),
            "p_choose": {
                "energy_bias": _t(sd[f"{pc}.energy_bias"]).reshape(1),
                "q_energy_proj": [_linear(sd, f"{pc}.q_energy_proj.layers.{j}")
                                  for j in idx],
                "k_energy_proj": [_linear(sd, f"{pc}.k_energy_proj.layers.{j}")
                                  for j in idx],
            },
            "ffn": {"layer_norm": _ln(sd, f"{p}.ffn_layer_norm"),
                    "inner_proj": _linear(sd, f"{p}.ffn.inner_proj"),
                    "output_proj": _linear(sd, f"{p}.ffn.output_proj")},
        })
    return {"embed": {"embedding": _t(sd["final_proj.weight"])}, "layers": layers,
            "layer_norm": _ln(sd, "text_decoder.layer_norm")}


# ---------------------------------------------------------------------------
# the standalone conformer-shaw speech encoder (a finetune's initialisation)
# ---------------------------------------------------------------------------

# fairseq1 conformer-shaw (w2v-BERT pretraining) -> fairseq2 paths, the JAX
# package's rules (reference models/conformer_shaw/loader.py:44-74)
_CONFORMER_SHAW_RULES = [
    (r"^encoder\.layers\.([0-9]+)\.self_attn\.out_proj\.",
     r"encoder.layers.\1.self_attn.output_proj."),
    (r"^encoder\.layers\.([0-9]+)\.self_attn\.rel_k_embedding\.",
     r"encoder.layers.\1.self_attn.sdpa.rel_k_embed."),
    (r"^encoder\.layers\.([0-9]+)\.conv_module\.depthwise_conv\.",
     r"encoder.layers.\1.conv.depthwise_conv."),
    (r"^encoder\.layers\.([0-9]+)\.conv_module\.layer_norm2\.",
     r"encoder.layers.\1.conv.layer_norm."),
    (r"^encoder\.layers\.([0-9]+)\.conv_module\.layer_norm\.",
     r"encoder.layers.\1.conv_layer_norm."),
    (r"^encoder\.layers\.([0-9]+)\.conv_module\.pointwise_conv1\.",
     r"encoder.layers.\1.conv.pointwise_conv1."),
    (r"^encoder\.layers\.([0-9]+)\.conv_module\.pointwise_conv2\.",
     r"encoder.layers.\1.conv.pointwise_conv2."),
    (r"^encoder\.layers\.([0-9]+)\.ffn(1|2)\.layer_norm\.",
     r"encoder.layers.\1.ffn\2_layer_norm."),
    (r"^encoder\.layers\.([0-9]+)\.ffn(1|2)\.w_1\.",
     r"encoder.layers.\1.ffn\2.inner_proj."),
    (r"^encoder\.layers\.([0-9]+)\.ffn(1|2)\.w_2\.",
     r"encoder.layers.\1.ffn\2.output_proj."),
    (r"^encoder\.layers\.([0-9]+)\.final_layer_norm\.",
     r"encoder.layers.\1.layer_norm."),
    (r"^layer_norm\.", "encoder_frontend.post_extract_layer_norm."),
    (r"^post_extract_proj\.", "encoder_frontend.model_dim_proj."),
    # fairseq2-native checkpoints pass through unchanged
    (r"^encoder_frontend\.", "encoder_frontend."),
    (r"^encoder\.", "encoder."),
]

# pretraining-only tensors (masker, quantizer, target projections): dropped
_CONFORMER_SHAW_DROP = re.compile(
    r"^(mask_emb|quantizer\.|project_q\.|mlm_proj\.|final_target_proj\.|masker\.)")


def conformer_shaw_tree_from_pt(sd: Mapping[str, Any]) -> dict:
    """A standalone conformer-shaw speech-encoder checkpoint (fairseq1
    w2v-BERT names or fairseq2 names; card ``cards/conformer_shaw.yaml``)
    -> the pieces of the port's ``speech_encoder`` that UnitY shares with
    it: {"feature_projection", "encoder"} (the conformer layers as a list)."""
    f2: Dict[str, torch.Tensor] = {}
    compiled = [(re.compile(p), r) for p, r in _CONFORMER_SHAW_RULES]
    for key, val in sd.items():
        if _CONFORMER_SHAW_DROP.match(key):
            continue
        for rx, repl in compiled:
            if rx.match(key):
                f2[rx.sub(repl, key)] = _t(val)
                break
    n = _num_layers(f2, r"encoder\.layers\.([0-9]+)\.")
    if n == 0:
        raise ValueError("no conformer encoder layers found in checkpoint")
    return {
        "feature_projection": {
            "layer_norm": _ln(f2, "encoder_frontend.post_extract_layer_norm"),
            "projection": _linear(f2, "encoder_frontend.model_dim_proj"),
        },
        "encoder": [_conformer_layer_tree(f2, f"encoder.layers.{i}") for i in range(n)],
    }


def _tree_leaves(tree, prefix: str = "") -> dict:
    """{path: tensor} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: t for key, v in tree.items()
                for k, t in _tree_leaves(v, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: t for i, v in enumerate(tree)
                for k, t in _tree_leaves(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def init_speech_encoder_from_conformer_shaw(params: dict, sd: Mapping[str, Any], *,
                                            dtype: Optional[torch.dtype] = None) -> dict:
    """``params`` with ``speech_encoder``'s frontend projection and conformer
    stack replaced by a converted conformer-shaw checkpoint, in ``dtype``
    (None: the replaced leaves' dtype) on their device; the UnitY-only
    adaptor, intermediate FFN and inner layer norm stay as they are. Raises
    ``ValueError`` where the checkpoint does not match the config (layer
    count, widths)."""
    tree = conformer_shaw_tree_from_pt(sd)
    se = dict(params["speech_encoder"])
    for key in ("feature_projection", "encoder"):
        old = _tree_leaves(se[key])
        new = _tree_leaves(tree[key])
        if set(old) != set(new) or any(tuple(old[k].shape) != tuple(new[k].shape)
                                       for k in old):
            raise ValueError(f"conformer_shaw checkpoint does not match model config at "
                             f"'{key}' (layer count / dims)")
        first = next(iter(old.values()))
        dt = dtype if dtype is not None else first.dtype
        se[key] = _tree_map(lambda t: t.to(first.device, dt), tree[key])
    return dict(params, speech_encoder=se)


# ---------------------------------------------------------------------------
# the UnitY2 forced aligner (reference models/aligner/loader.py:22-75)
# ---------------------------------------------------------------------------

def aligner_tree_from_pt(ckpt: Mapping, *,
                         char_spm_pieces: Optional[Sequence[str]] = None) -> dict:
    """The raw checkpoint (``text_emb_state``, ``unit_emb_state`` and
    ``aligner_state`` sub-dicts) or an already converted flat dict -> the
    aligner tree. With ``char_spm_pieces`` the char embedding's rows are
    reordered to sorted-SPM order (loader.py:52-56, 61-75)."""
    if "aligner_state" in ckpt:
        sd = {f"alignment_encoder.{k}": _t(v) for k, v in ckpt["aligner_state"].items()}
        sd["alignment_frontend.embed_text.weight"] = _t(ckpt["text_emb_state"]["weight"])
        sd["alignment_frontend.embed_unit.weight"] = _t(ckpt["unit_emb_state"]["weight"])
    else:
        sd = {k: _t(v) for k, v in (ckpt.get("model") or ckpt).items()}

    te = sd["alignment_frontend.embed_text.weight"].clone()
    if char_spm_pieces is not None:
        spm_order = list(char_spm_pieces)[4:]
        spm_to_dict = {ch: i for i, ch in enumerate(sorted(spm_order), start=4)}
        mapping = [0, 1, 2, 3] + [spm_to_dict[ch] for ch in spm_order]
        te[:len(mapping)] = te[mapping]

    def tower(name: str) -> list:
        # Sequential slots: a conv at 1 + 3 i (conv, relu, dropout / conv,
        # dropout, permute)
        rx = re.compile(rf"alignment_encoder\.{name}\.([0-9]+)\.weight$")
        idx = sorted({int(m.group(1)) for k in sd if (m := rx.match(k))})
        return [_conv(sd, f"alignment_encoder.{name}.{i}") for i in idx]

    return {"embed_text": {"embedding": te},
            "embed_unit": {"embedding": sd["alignment_frontend.embed_unit.weight"]},
            "t_conv": tower("t_conv"),
            "f_conv": tower("f_conv")}


# ---------------------------------------------------------------------------
# the MuToX classifier (reference toxicity/mutox/{builder.py:44-64,
# loader.py:27-35}: Sequential((Dropout, Linear 1024->512), (ReLU, Linear
# 512->128), (ReLU, Linear 128->1)) under model_all.N.1 keys)
# ---------------------------------------------------------------------------

def mutox_tree_from_pt(sd: Mapping[str, Any]) -> dict:
    n = _num_layers(sd, r"model_all\.([0-9]+)\.")
    return {"layers": [{"linear": _linear(sd, f"model_all.{i}.1")} for i in range(n)]}


# ---------------------------------------------------------------------------
# the raw-waveform XLSR wav2vec2 of unit extraction (reference
# wav2vec2_layer_output.py:23-52, through fairseq2's wav2vec2 key map)
# ---------------------------------------------------------------------------

_W2V2_RAW_RULES = [
    (r"^encoder\.pos_conv\.0\.", "encoder_frontend.pos_encoder.conv."),
    (r"^layer_norm\.", "encoder_frontend.post_extract_layer_norm."),
    (r"^post_extract_proj\.", "encoder_frontend.model_dim_proj."),
    (r"^feature_extractor\.conv_layers\.([0-9]+)\.0\.",
     r"encoder_frontend.feature_extractor.layers.\1.conv."),
    (r"^feature_extractor\.conv_layers\.([0-9]+)\.2\.1\.",
     r"encoder_frontend.feature_extractor.layers.\1.layer_norm."),
    (r"^encoder\.layers\.([0-9]+)\.self_attn\.out_proj\.",
     r"encoder.layers.\1.self_attn.output_proj."),
    (r"^encoder\.layers\.([0-9]+)\.self_attn\.", r"encoder.layers.\1.self_attn."),
    (r"^encoder\.layers\.([0-9]+)\.self_attn_layer_norm\.",
     r"encoder.layers.\1.self_attn_layer_norm."),
    (r"^encoder\.layers\.([0-9]+)\.fc1\.", r"encoder.layers.\1.ffn.inner_proj."),
    (r"^encoder\.layers\.([0-9]+)\.fc2\.", r"encoder.layers.\1.ffn.output_proj."),
    (r"^encoder\.layers\.([0-9]+)\.final_layer_norm\.",
     r"encoder.layers.\1.ffn_layer_norm."),
    (r"^encoder\.layer_norm\.", "encoder.layer_norm."),
    (r"^encoder_frontend\.", "encoder_frontend."),   # fairseq2 keys pass through
    (r"^encoder\.", "encoder."),
]


def wav2vec2_raw_tree_from_pt(sd: Mapping[str, Any]) -> dict:
    """fairseq1 or fairseq2 wav2vec2 keys -> the tree of
    ``models/unit_extractor/wav2vec2_raw.py`` (the frontend and the encoder;
    the quantizer and the pretraining heads are dropped, as the reference's
    Wav2Vec2LayerOutputModel drops them). The positional conv's weight norm
    (g over the kernel axis) is folded. The layers are a list."""
    f2: Dict[str, torch.Tensor] = {}
    compiled = [(re.compile(p), r) for p, r in _W2V2_RAW_RULES]
    for key, val in sd.items():
        key = key.removeprefix("w2v_encoder.w2v_model.")
        for rx, repl in compiled:
            if rx.match(key):
                f2[rx.sub(repl, key)] = _t(val)
                break

    fe = "encoder_frontend.feature_extractor.layers"
    n_convs = _num_layers(f2, rf"{re.escape(fe)}\.([0-9]+)\.")
    convs = [{"conv": _conv(f2, f"{fe}.{i}.conv"), "norm": _ln(f2, f"{fe}.{i}.layer_norm")}
             for i in range(n_convs)]
    n = _num_layers(f2, r"encoder\.layers\.([0-9]+)\.")
    layers = [{
        "self_attn_layer_norm": _ln(f2, f"encoder.layers.{i}.self_attn_layer_norm"),
        "self_attn": _mha(f2, f"encoder.layers.{i}.self_attn"),
        "ffn": {"layer_norm": _ln(f2, f"encoder.layers.{i}.ffn_layer_norm"),
                "inner_proj": _linear(f2, f"encoder.layers.{i}.ffn.inner_proj"),
                "output_proj": _linear(f2, f"encoder.layers.{i}.ffn.output_proj")},
    } for i in range(n)]
    return {
        "feature_extractor": convs,
        "post_extract_norm": _ln(f2, "encoder_frontend.post_extract_layer_norm"),
        "post_extract_proj": _linear(f2, "encoder_frontend.model_dim_proj"),
        "pos_conv": _conv_wn(f2, "encoder_frontend.pos_encoder.conv"),
        "encoder_norm": _ln(f2, "encoder.layer_norm"),
        "layers": layers,
    }


def load_pt_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load`` a reference checkpoint -> its state dict (the ``model``
    or ``generator`` entry), tensors kept in their dtype."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model") or ckpt.get("generator") or ckpt
    return {k: _t(v) for k, v in sd.items()}
