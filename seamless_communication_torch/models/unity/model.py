"""UnitY model functions (counterpart of
``seamless_communication_tpu/models/unity/model.py``): parameter init for the
speech encoder, the text decoder, the T2U (NAR for v2, AR for v1) and the
text encoder; ``encode_speech`` and ``encode_text``; the beam-search step of
the X2T view (full-vocabulary or candidate form); the full-sequence
re-decode ``decode_text``; ``project``, the tied output projection; and
``t2u_nar`` (with the prosody embedding and FiLM condition of an expressive
model); ``encode_prosody``, the expressive models' ECAPA embedding. The AR
T2U's decode is in ``inference/generator.py``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seamless_communication_torch.models.nllb.model import (
    text_decoder_cache, text_decoder_forward, text_decoder_init, text_decoder_step,
    text_decoder_step_topk, text_encoder_forward, text_encoder_init,
)
from seamless_communication_torch.models.pretssel.ecapa_tdnn import (
    ecapa_forward, ecapa_init,
)
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.models.unity.t2u import (
    NarT2UOutput, ar_t2u_init, nar_t2u_forward, nar_t2u_init,
)
from seamless_communication_torch.models.wav2vec2.encoder import (
    speech_encoder_forward, speech_encoder_init,
)
from seamless_communication_torch.ops.masks import lengths_to_padding_mask
from seamless_communication_torch.ops.transformer import tied_projection


def unity_init(gen: torch.Generator, cfg: UnitYConfig, *, dtype=torch.float32,
               device=None) -> dict:
    """Random parameters of the speech encoder, the text decoder, (where the
    config has them) the NAR or the AR T2U, the text encoder and the ECAPA
    prosody encoder, drawn from ``gen`` in that order (``gen`` must live on
    ``device``). The text encoder shares the decoder's ``embed`` dict, as
    NLLB ties the two tables; it and the prosody encoder are drawn last, so
    the other parts are the same draws with or without them."""
    kw = dict(dtype=dtype, device=device)
    params = {"speech_encoder": speech_encoder_init(gen, cfg.speech, **kw),
              "text_decoder": text_decoder_init(gen, cfg.nllb, **kw)}
    if cfg.nar_t2u is not None:
        params["t2u"] = nar_t2u_init(gen, cfg.nar_t2u, **kw)
    elif cfg.ar_t2u is not None:
        params["t2u"] = ar_t2u_init(gen, cfg.ar_t2u, **kw)
    if cfg.use_text_encoder:
        params["text_encoder"] = text_encoder_init(
            gen, cfg.nllb, tie_embed=params["text_decoder"]["embed"], **kw)
    if cfg.ecapa is not None:
        params["prosody_encoder"] = ecapa_init(gen, cfg.ecapa, **kw)
    return params


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


def encode_text(params: dict, cfg: UnitYConfig, ids: torch.Tensor,
                lengths: torch.Tensor) -> EncoderOutput:
    seqs, _ = text_encoder_forward(params["text_encoder"], ids, lengths, cfg.nllb)
    return EncoderOutput(seqs, lengths)


def decode_text(params: dict, cfg: UnitYConfig, ids: torch.Tensor, enc: EncoderOutput,
                *, self_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence text decode -> (B, T, D) features, the T2U's input."""
    mask = (lengths_to_padding_mask(self_lengths, ids.shape[1])
            if self_lengths is not None else None)
    return text_decoder_forward(params["text_decoder"], ids, enc.seqs, cfg.nllb,
                                enc_padding_mask=enc.padding_mask,
                                self_padding_mask=mask)


def project(params: dict, features: torch.Tensor) -> torch.Tensor:
    """(B, T, D) decoder features -> (B, T, V) fp32 logits through the tied
    text embedding."""
    return tied_projection(params["text_decoder"]["embed"], features)


def make_text_decode_step(params: dict, cfg: UnitYConfig, enc: EncoderOutput, *,
                          candidates: Optional[int] = None):
    """The beam-search ``step_fn(tok_t, cache, step, beam_src)`` and the cache
    factory ``cache_fn(max_len, kv_int8, kv_bits)`` of the X2T view.

    ``candidates=k``: ``step_fn`` returns each beam's top-k candidates
    ``(log-probs, ids, cache)`` for ``beam_search(candidate_mode=True)``
    (``text_decoder_step_topk``) instead of the full-vocabulary logits."""
    mask = enc.padding_mask
    dec = params["text_decoder"]

    if candidates is not None:
        def step_fn(tok_t, cache, step: int, beam_src: Optional[torch.Tensor] = None):
            return text_decoder_step_topk(dec, tok_t, cache, step, cfg.nllb, candidates,
                                          enc_padding_mask=mask, beam_src=beam_src)
    else:
        def step_fn(tok_t, cache, step: int, beam_src: Optional[torch.Tensor] = None):
            return text_decoder_step(dec, tok_t, cache, step, cfg.nllb,
                                     enc_padding_mask=mask, beam_src=beam_src)

    def cache_fn(max_len: int, kv_int8: bool = False, kv_bits: int = 8):
        return text_decoder_cache(dec, cfg.nllb, enc.seqs, max_len, kv_int8=kv_int8,
                                  kv_bits=kv_bits)

    return step_fn, cache_fn


def t2u_nar(params: dict, cfg: UnitYConfig, text_dec_out: torch.Tensor,
            text_lens: torch.Tensor, char_ids: torch.Tensor, char_counts: torch.Tensor,
            *, max_unit_len: int, duration_factor: float = 1.0,
            prosody_embed: Optional[torch.Tensor] = None,
            film_cond: Optional[torch.Tensor] = None) -> NarT2UOutput:
    return nar_t2u_forward(params["t2u"], cfg.nar_t2u, text_dec_out, text_lens,
                           char_ids, char_counts, max_unit_len=max_unit_len,
                           duration_factor=duration_factor,
                           prosody_embed=prosody_embed, film_cond=film_cond)


def encode_prosody(params: dict, cfg: UnitYConfig, fbank: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """A gcmvn-normalised fbank (B, T, 80) -> (B, 1, prosody_dim) ECAPA
    embedding: the T2U's ``prosody_proj`` input and its FiLM condition."""
    mask = lengths_to_padding_mask(lengths, fbank.shape[1])
    emb = ecapa_forward(params["prosody_encoder"], fbank, cfg.ecapa, padding_mask=mask)
    return emb[:, None, :]
