"""Asset card -> the port's parameters and tokenizers (counterpart of
``seamless_communication_tpu/cli/loading.py``).

``load_monotonic_decoder`` loads SeamlessStreaming's EMMA decoder from its
original ``.pt`` (either key space) or a ``.npz`` parameter file;
``load_pretssel_vocoder`` SeamlessExpressive's PRETSSEL vocoder (16 or 24
kHz, as the card's ``sample_rate`` says) from its ``.pt`` or a ``.npz``.

Two checkpoint routes:
  1. the reference's original ``.pt`` files (fairseq1 or fairseq2 keyed),
     through ``checkpoint/convert_fairseq2.py`` and ``torch.load`` alone;
  2. HF ``transformers`` checkpoints (``SeamlessM4Tv2Model`` /
     ``SeamlessM4TModel``), through ``checkpoint/convert_hf.py``; this route
     needs ``transformers``.

The trees are cast to ``dtype`` (bf16 for UnitY, fp32 for the vocoder by
default), moved to ``device`` (the CUDA card unless the caller asks for the
CPU) and, with ``quantize``, made int8 or int4 weight-only there.

Where the JAX package loads a v1 model (``seamlessM4T_large``,
``seamlessM4T_medium``) from HF with its v2 converter, which reads the v2
attention's ``distance_embedding`` and so raises ``AttributeError``, the port
uses the v1 converter.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import torch

from seamless_communication_torch.assets import load_card, resolve_asset
from seamless_communication_torch.checkpoint.convert_fairseq2 import (
    apply_unity_fixups, fairseq1_to_fairseq2_auto, is_fairseq1_unity,
    load_pt_state_dict, monotonic_tree_from_pt, pretssel_tree_from_pt,
    unity_tree_from_fairseq2, vocoder_tree_from_pt,
)
from seamless_communication_torch.checkpoint.serialize import load_params
from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.models.monotonic.model import MonotonicDecoderConfig
from seamless_communication_torch.models.pretssel.vocoder import (
    pretssel_16khz_config, pretssel_24khz_config,
)
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.models.vocoder.codehifigan import CodeHifiGanConfig
from seamless_communication_torch.ops.quantization import quantize_params
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import SentencePieceModel
from seamless_communication_torch.utils.profiling import TRACER

logger = logging.getLogger(__name__)

HF_REPO_FOR_CARD = {
    "seamlessM4T_v2_large": "facebook/seamless-m4t-v2-large",
    "seamlessM4T_large": "facebook/hf-seamless-m4t-large",
    "seamlessM4T_medium": "facebook/hf-seamless-m4t-medium",
}


def _unity_tree_from_pt(pt_path: str, card: dict, char_tok: Optional[CharTokenizer],
                        timings: dict, t0: float, device: torch.device) -> dict:
    """An original ``.pt`` -> the port's UnitY tree, with the reference
    loader's fixups for a fairseq1-keyed file (key remap, NLLB-100 dummy-row
    drop, control-symbol permutation, char reorder)."""
    sd = load_pt_state_dict(pt_path)
    t0 = TRACER.stage_end(timings, "torch_load", t0, device)
    if is_fairseq1_unity(sd):
        sd = fairseq1_to_fairseq2_auto(sd)
        pieces = ["<pad>"] + list(char_tok.spm.pieces) if char_tok is not None else None
        sd = apply_unity_fixups(sd, char_spm_pieces=pieces)
    tree = unity_tree_from_fairseq2(sd, v2="v2" in card["model_arch"])
    TRACER.stage_end(timings, "convert", t0, device)
    return tree


def load_unity_model_and_tokenizers(card_name: str, *, dtype=None,
                                    local_hf_path: Optional[str] = None,
                                    local_pt_path: Optional[str] = None,
                                    quantize: bool = False, quantize_bits: int = 8,
                                    device=None, timings: Optional[dict] = None):
    """-> (params, UnitYConfig, NllbTokenizer, UnitTokenizer, CharTokenizer or
    None), the params on ``device``.

    The checkpoint: ``local_pt_path`` if given, else HF (``local_hf_path``,
    else the card's HF repo), else the card's original ``.pt`` (gated ones
    through ``SEAMLESS_GATED_ASSETS``). ``timings``, where given, gets the
    wall seconds of the stages: torch_load (reading the ``.pt``), convert
    (key remap, fixups, layouts; from HF the whole conversion), transfer
    (the cast and the move to the device), quantize."""
    device = resolve_device(device)
    dtype = dtype or torch.bfloat16
    timings = {} if timings is None else timings
    card = load_card(card_name)
    cfg = get_arch(card["model_arch"])
    char_tok = None
    if "char_tokenizer" in card:
        char_tok = CharTokenizer.from_file(resolve_asset(card["char_tokenizer"]))

    t0 = time.perf_counter()
    src = local_hf_path or HF_REPO_FOR_CARD.get(card_name)
    if local_pt_path or src is None:
        pt = local_pt_path or card.get("checkpoint")
        if pt is None or (not local_pt_path and str(pt).endswith("gated=true")):
            raise ValueError(
                f"card {card_name} has no HF mapping and its checkpoint is gated; "
                f"pass local_pt_path / --gated-model-dir (SEAMLESS_GATED_ASSETS) or "
                f"local_hf_path")
        tree = _unity_tree_from_pt(resolve_asset(str(pt)), card, char_tok, timings, t0,
                                   device)
    else:
        from seamless_communication_torch.checkpoint.convert_hf import (
            convert_hf_seamless_m4t_v1, convert_hf_seamless_m4t_v2,
        )
        if card["model_arch"].endswith("v2"):
            from transformers import SeamlessM4Tv2Model
            tree = convert_hf_seamless_m4t_v2(SeamlessM4Tv2Model.from_pretrained(src))
        else:
            from transformers import SeamlessM4TModel
            tree = convert_hf_seamless_m4t_v1(SeamlessM4TModel.from_pretrained(src))
        TRACER.stage_end(timings, "convert", t0, device)
    t0 = time.perf_counter()
    params = params_to(tree, device, dtype)
    del tree
    t0 = TRACER.stage_end(timings, "transfer", t0, device)
    if quantize:
        params = quantize_params(params, bits=quantize_bits)
        TRACER.stage_end(timings, "quantize", t0, device)

    spm_path = resolve_asset(card.get("tokenizer", f"{src}/sentencepiece.bpe.model"))
    langs = [f"__{lang}__" for lang in card.get("langs", [])]
    text_tok = NllbTokenizer(SentencePieceModel.from_file(spm_path), langs=langs)
    unit_tok = UnitTokenizer(card.get("num_units", 10000), card.get("unit_langs", []),
                             card["model_arch"])
    return params, cfg, text_tok, unit_tok, char_tok


def load_vocoder(card_name: str = "vocoder_v2", *, dtype=None,
                 local_hf_path: Optional[str] = None,
                 local_pt_path: Optional[str] = None, device=None):
    """-> (vocoder params on ``device``, CodeHifiGanConfig, lang_spkr_idx_map).

    ``local_pt_path``, or the card's checkpoint where it is already a local
    file or in the asset cache, loads the original unit HiFi-GAN ``.pt``;
    otherwise the HF v2 release's vocoder (``local_hf_path``, else the
    public repo) through ``transformers``."""
    device = resolve_device(device)
    dtype = dtype or torch.float32
    card = load_card(card_name)
    cfg = CodeHifiGanConfig()
    idx_map = (card.get("model_config") or {}).get("lang_spkr_idx_map", {})

    pt = local_pt_path
    if pt is None and not local_hf_path:
        ckpt = str(card.get("checkpoint", ""))
        if ckpt and not ckpt.endswith("gated=true"):
            cache = os.environ.get("SEAMLESS_CACHE",
                                   os.path.expanduser("~/.cache/seamless_tpu"))
            for cand in (ckpt, os.path.join(cache, ckpt.rstrip("/").split("/")[-1])):
                if os.path.exists(cand):
                    pt = cand
                    break
    if pt is not None:
        tree = vocoder_tree_from_pt(load_pt_state_dict(pt))
    else:
        from transformers import SeamlessM4Tv2Model

        from seamless_communication_torch.checkpoint.convert_hf import (
            convert_hf_code_hifigan,
        )
        model = SeamlessM4Tv2Model.from_pretrained(
            local_hf_path or "facebook/seamless-m4t-v2-large")
        tree = convert_hf_code_hifigan(model.vocoder)
    return params_to(tree, device, dtype), cfg, idx_map


def load_monotonic_decoder(card_name: str = "seamless_streaming_monotonic_decoder", *,
                           dtype=None, local_pt_path: Optional[str] = None, device=None,
                           timings: Optional[dict] = None):
    """-> (monotonic decoder params on ``device`` in ``dtype`` (bf16 by
    default), MonotonicDecoderConfig()), dense_1b being the one released
    arch. The checkpoint: ``local_pt_path``, else the card's; a ``.pt`` file
    converts through ``monotonic_tree_from_pt``, anything else loads as the
    port's parameter file. ``timings`` gets the stages' wall seconds
    (torch_load, convert, transfer)."""
    device = resolve_device(device)
    dtype = dtype or torch.bfloat16
    timings = {} if timings is None else timings
    card = load_card(card_name)
    path = resolve_asset(str(local_pt_path or card["checkpoint"]))
    t0 = time.perf_counter()
    if path.endswith(".pt"):
        sd = load_pt_state_dict(path)
        t0 = TRACER.stage_end(timings, "torch_load", t0, device)
        tree = monotonic_tree_from_pt(sd)
        del sd
    else:
        tree = load_params(path)
    t0 = TRACER.stage_end(timings, "convert", t0, device)
    params = params_to(tree, device, dtype)
    del tree
    TRACER.stage_end(timings, "transfer", t0, device)
    return params, MonotonicDecoderConfig()


def load_pretssel_vocoder(card_name: str = "vocoder_pretssel", *, dtype=None,
                          local_pt_path: Optional[str] = None, device=None,
                          timings: Optional[dict] = None):
    """-> (PRETSSEL params on ``device`` in ``dtype`` (fp32 by default),
    PretsselConfig, the card's ``model_config`` (langs, gcmvn_stats),
    sample rate). The card's ``sample_rate`` (24000 by default) picks the 16
    kHz or the 24 kHz config. The checkpoint: ``local_pt_path``, else the
    card's (the gated ``pretssel_melhifigan_wm*.pt`` through
    ``SEAMLESS_GATED_ASSETS``); a ``.pt`` converts through
    ``pretssel_tree_from_pt``, anything else loads as the port's parameter
    file. The vocoder's gcmvn statistics stay at the identity, as the JAX
    package leaves them. ``timings`` gets the stages' wall seconds
    (torch_load, convert, transfer)."""
    device = resolve_device(device)
    dtype = dtype or torch.float32
    timings = {} if timings is None else timings
    card = load_card(card_name)
    sample_rate = int(card.get("sample_rate", 24000))
    cfg = pretssel_16khz_config() if sample_rate == 16000 else pretssel_24khz_config()
    path = resolve_asset(str(local_pt_path or card["checkpoint"]))
    t0 = time.perf_counter()
    if path.endswith(".pt"):
        sd = load_pt_state_dict(path)
        t0 = TRACER.stage_end(timings, "torch_load", t0, device)
        tree = pretssel_tree_from_pt(sd, cfg)
        del sd
    else:
        tree = load_params(path)
    t0 = TRACER.stage_end(timings, "convert", t0, device)
    params = params_to(tree, device, dtype)
    del tree
    TRACER.stage_end(timings, "transfer", t0, device)
    return params, cfg, card.get("model_config") or {}, sample_rate
