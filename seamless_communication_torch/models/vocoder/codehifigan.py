"""Unit-code HiFi-GAN vocoder (counterpart of
``seamless_communication_tpu/models/vocoder/codehifigan.py``).

unit ids -> 1280-d unit embeddings -> duration predictor and duration repeat
(static-length hard upsample) -> concat [lang ; units ; spkr] channel-wise
(1792 channels) -> HiFi-GAN (320x upsample: 50 Hz units to 16 kHz audio).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seamless_communication_torch.models.unity.t2u import (
    durations_from_log, variance_predictor, variance_predictor_init,
)
from seamless_communication_torch.models.vocoder.hifigan import (
    HifiGanConfig, hifigan_forward, hifigan_init,
)
from seamless_communication_torch.ops.modules import embedding, embedding_init
from seamless_communication_torch.ops.upsample import hard_upsample


class CodeHifiGanConfig(NamedTuple):
    num_units: int = 10000
    unit_embed_dim: int = 1280
    num_langs: int = 36
    lang_embed_dim: int = 256
    num_spkrs: int = 200
    spkr_embed_dim: int = 256
    dur_predictor_hidden: int = 1280
    dur_predictor_kernel: int = 3
    hifigan: HifiGanConfig = HifiGanConfig()


def code_hifigan_init(gen: torch.Generator, cfg: CodeHifiGanConfig, *,
                      dtype=torch.float32, device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "unit_embedding": embedding_init(gen, cfg.num_units, cfg.unit_embed_dim, **kw),
        "speaker_embedding": embedding_init(gen, cfg.num_spkrs, cfg.spkr_embed_dim,
                                            **kw),
        "language_embedding": embedding_init(gen, cfg.num_langs, cfg.lang_embed_dim,
                                             **kw),
        "dur_predictor": variance_predictor_init(
            gen, cfg.unit_embed_dim, cfg.dur_predictor_hidden,
            cfg.dur_predictor_kernel, **kw),
        "hifigan": hifigan_init(gen, cfg.hifigan, **kw),
    }


class VocoderOutput(NamedTuple):
    waveform: torch.Tensor        # (B, max_units * 320)
    sample_lengths: torch.Tensor  # (B,)


def code_hifigan_forward(params: dict, cfg: CodeHifiGanConfig, units: torch.Tensor,
                         unit_lengths: torch.Tensor, lang_id: torch.Tensor,
                         spkr_id: torch.Tensor, *, dur_prediction: bool = True,
                         max_unit_len: Optional[int] = None) -> VocoderOutput:
    """units (B, U) raw unit ids; lang_id/spkr_id (B,) int ids. With
    ``dur_prediction`` each unit repeats by its predicted duration, up to
    ``max_unit_len`` frames (default U * 4); ``sample_lengths`` is the
    uncapped frame total times the upsampling."""
    B, U = units.shape
    x = embedding(params["unit_embedding"], units.clamp(0, cfg.num_units - 1))
    valid = torch.arange(U, device=units.device)[None, :] < unit_lengths[:, None]
    if dur_prediction:
        log_dur = variance_predictor(params["dur_predictor"], x, valid)
        dur = durations_from_log(log_dur, valid)
        x, total = hard_upsample(x, dur, max_unit_len or U * 4)
    else:
        x = x * valid[..., None].to(x.dtype)
        total = unit_lengths
    T = x.shape[1]
    lang = embedding(params["language_embedding"], lang_id)[:, None, :]
    spkr = embedding(params["speaker_embedding"], spkr_id)[:, None, :]
    feats = torch.cat([lang.expand(B, T, -1).to(x.dtype), x,
                       spkr.expand(B, T, -1).to(x.dtype)], dim=-1)
    wav = hifigan_forward(params["hifigan"], feats, cfg.hifigan)
    return VocoderOutput(wav, total * cfg.hifigan.total_upsample)
