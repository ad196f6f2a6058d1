"""UnitY model functions for the speech-to-text path (counterpart of
``seamless_communication_tpu/models/unity/model.py``): parameter init for the
speech encoder and the text decoder, ``encode_speech`` and the beam-search
step of the X2T view."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seamless_communication_torch.models.nllb.model import (
    text_decoder_cache, text_decoder_init, text_decoder_step,
)
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.models.wav2vec2.encoder import (
    speech_encoder_forward, speech_encoder_init,
)
from seamless_communication_torch.ops.masks import lengths_to_padding_mask


def unity_init(gen: torch.Generator, cfg: UnitYConfig, *, dtype=torch.float32,
               device=None) -> dict:
    """Random parameters of the speech encoder and the text decoder, drawn
    from ``gen`` (which must live on ``device``)."""
    return {"speech_encoder": speech_encoder_init(gen, cfg.speech, dtype=dtype,
                                                  device=device),
            "text_decoder": text_decoder_init(gen, cfg.nllb, dtype=dtype,
                                              device=device)}


class EncoderOutput(NamedTuple):
    seqs: torch.Tensor      # (B, S, D)
    lengths: torch.Tensor   # (B,)

    @property
    def padding_mask(self) -> torch.Tensor:
        return lengths_to_padding_mask(self.lengths, self.seqs.shape[1])


def encode_speech(params: dict, cfg: UnitYConfig, fbank: torch.Tensor,
                  frame_lens: torch.Tensor) -> EncoderOutput:
    seqs, lens = speech_encoder_forward(params["speech_encoder"], fbank, frame_lens,
                                        cfg.speech)
    return EncoderOutput(seqs, lens)


def make_text_decode_step(params: dict, cfg: UnitYConfig, enc: EncoderOutput):
    """The beam-search ``step_fn(tok_t, cache, step, beam_src)`` and the cache
    factory ``cache_fn(max_len, kv_int8)`` of the X2T view."""
    mask = enc.padding_mask
    dec = params["text_decoder"]

    def step_fn(tok_t, cache, step: int, beam_src: Optional[torch.Tensor] = None):
        return text_decoder_step(dec, tok_t, cache, step, cfg.nllb,
                                 enc_padding_mask=mask, beam_src=beam_src)

    def cache_fn(max_len: int, kv_int8: bool = False):
        return text_decoder_cache(dec, cfg.nllb, enc.seqs, max_len, kv_int8=kv_int8)

    return step_fn, cache_fn
