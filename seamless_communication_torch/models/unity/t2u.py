"""Text-to-unit models (counterpart of
``seamless_communication_tpu/models/unity/t2u.py``).

The AR T2U of the v1 models: a transformer encoder over the text decoder's
features and a KV-cached transformer decoder over unit tokens with a tied
embedding, decoded by beam search (``inference/generator.py``).

The NAR T2U of UnitY2: a 6-layer transformer encoder over the text
decoder's features, then a char-level NAR decoder: upsample the features to
char length by each token's char count, add char embeddings and
alpha-scaled sinusoidal positions, predict per-char durations (variance
predictor), upsample to unit length, run the post-LN FFT layers
(self-attention + two same-padded convs) and project to the unit
vocabulary.

``nar_t2u_train`` is the teacher-forced NAR pass of finetuning: the
ground-truth per-char durations upsample to units, and the duration
predictor's raw output is returned for its loss.

The expressive models (Prosody UnitY2) condition the NAR T2U on the ECAPA
prosody embedding: ``prosody_proj`` of it is added to the encoder's output,
and FiLM layers (``models/unity/film.py``) modulate the duration
predictor's hidden states and every FFT layer's output.

Upsampled lengths are static (``max_unit_len``) with validity masks, as in
the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seamless_communication_torch.models.unity.film import film, film_init
from seamless_communication_torch.ops import attention as attn_ops
from seamless_communication_torch.ops.masks import (
    apply_padding_mask, lengths_to_padding_mask, padding_bias,
)
from seamless_communication_torch.ops.modules import (
    conv1d, conv1d_init, embedding, embedding_init, layer_norm, layer_norm_init,
    linear, linear_init,
)
from seamless_communication_torch.ops.positional import sinusoidal_positions
from seamless_communication_torch.ops.transformer import (
    TransformerConfig, decoder_cache_init, embedding_frontend, tied_projection,
    transformer_decoder_step, transformer_encoder, transformer_stack_init,
)
from seamless_communication_torch.ops.upsample import hard_upsample
from seamless_communication_torch.parallel.collectives import whole_channels


class NarT2UConfig(NamedTuple):
    model_dim: int = 1024
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 16
    ffn_inner_dim: int = 8192
    unit_vocab_size: int = 10082
    char_vocab_size: int = 10943
    conv_kernel_size: int = 7
    dur_predictor_hidden: int = 256
    dur_predictor_kernel: int = 3
    pad_idx: int = 1                 # unit vocab: bos=0 pad=1 eos=2 unk=3
    char_pad_idx: int = 1
    pos_pad_idx: int = 1             # sinusoidal-table offset = unit pad
    max_seq_len: int = 4096
    # expressive (FiLM) conditioning: 0 disables; expressivity_nar: 512
    film_cond_dim: int = 0
    prosody_proj_dim: int = 0        # the ECAPA embedding's dim, projected and added

    def enc_cfg(self) -> TransformerConfig:
        return TransformerConfig(self.model_dim, self.num_encoder_layers,
                                 self.num_heads, self.ffn_inner_dim, "relu",
                                 self.unit_vocab_size, self.pad_idx,
                                 self.max_seq_len, False)


# ---------------------------------------------------------------------------
# Variance predictor
# ---------------------------------------------------------------------------

def variance_predictor_init(gen: torch.Generator, dim: int, hidden: int, kernel: int,
                            *, film_cond_dim: int = 0, dtype=torch.float32,
                            device=None) -> dict:
    """``film_cond_dim`` > 0 adds a FiLM layer over the hidden states."""
    kw = dict(dtype=dtype, device=device)
    p = {"conv1": conv1d_init(gen, dim, hidden, kernel, **kw),
         "ln1": layer_norm_init(hidden, **kw),
         "conv2": conv1d_init(gen, hidden, hidden, kernel, **kw),
         "ln2": layer_norm_init(hidden, **kw),
         "proj": linear_init(gen, hidden, 1, **kw)}
    if film_cond_dim:
        p["film"] = film_init(gen, film_cond_dim, hidden, **kw)
    return p


def variance_predictor(p: dict, x: torch.Tensor, padding_mask: Optional[torch.Tensor],
                       *, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, D) -> (B, T) raw predictions; ``cond`` (B, 1, C) drives the
    FiLM layer where the parameters have one."""
    h = apply_padding_mask(x, padding_mask)
    h = torch.relu(conv1d(p["conv1"], h, padding="SAME"))
    # ln1 normalises all the hidden channels: a conv1 split over "model"
    # gives each rank its own, gathered here (conv2 takes its part again)
    h = layer_norm(p["ln1"], whole_channels(h, p["conv1"]))
    h = apply_padding_mask(h, padding_mask)
    h = torch.relu(conv1d(p["conv2"], h, padding="SAME"))
    h = layer_norm(p["ln2"], h)
    if "film" in p and cond is not None:
        h = film(p["film"], h, cond)
    return linear(p["proj"], h)[..., 0]


def durations_from_log(log_dur: torch.Tensor, padding_mask: Optional[torch.Tensor], *,
                       duration_factor: float = 1.0, min_duration: int = 1
                       ) -> torch.Tensor:
    """clamp(round((exp(d) - 1) * factor), min) as int32, pad positions 0."""
    dur = torch.round(torch.expm1(log_dur.float()) * duration_factor)
    dur = dur.clamp_min(min_duration).to(torch.int32)
    if padding_mask is not None:
        dur = torch.where(padding_mask, dur, 0)
    return dur


# ---------------------------------------------------------------------------
# Post-LN FFT decoder layer
# ---------------------------------------------------------------------------

def fft_layer_init(gen: torch.Generator, cfg: NarT2UConfig, *, dtype=torch.float32,
                   device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    d = cfg.model_dim
    p = {"self_attn": attn_ops.mha_init(gen, d, cfg.num_heads, **kw),
         "self_attn_layer_norm": layer_norm_init(d, **kw),
         "conv1": conv1d_init(gen, d, d, cfg.conv_kernel_size, **kw),
         "conv2": conv1d_init(gen, d, d, cfg.conv_kernel_size, **kw),
         "conv_layer_norm": layer_norm_init(d, **kw)}
    if cfg.film_cond_dim:
        p["film"] = film_init(gen, cfg.film_cond_dim, d, **kw)
    return p


def fft_layer(p: dict, x: torch.Tensor, bias: Optional[torch.Tensor],
              padding_mask: Optional[torch.Tensor], cfg: NarT2UConfig, *,
              cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = attn_ops.multi_head_attention(p["self_attn"], x, x, cfg.num_heads, bias=bias)
    x = layer_norm(p["self_attn_layer_norm"], x + h)
    res = x
    h = apply_padding_mask(x, padding_mask)
    h = conv1d(p["conv1"], h, padding="SAME")
    h = torch.relu(apply_padding_mask(h, padding_mask))
    h = conv1d(p["conv2"], h, padding="SAME")
    x = layer_norm(p["conv_layer_norm"], res + h)
    if "film" in p and cond is not None:
        x = film(p["film"], x, cond)
    return x


# ---------------------------------------------------------------------------
# NAR T2U model
# ---------------------------------------------------------------------------

def nar_t2u_init(gen: torch.Generator, cfg: NarT2UConfig, *, dtype=torch.float32,
                 device=None) -> dict:
    """Random parameters; ``decoder_layers`` is a list of per-layer dicts (the
    JAX package stacks them for its layer scan). An expressive config adds
    the FiLM layers and ``prosody_proj``."""
    kw = dict(dtype=dtype, device=device)
    p = {
        "encoder": transformer_stack_init(gen, cfg.enc_cfg(), **kw),
        "embed_char": embedding_init(gen, cfg.char_vocab_size, cfg.model_dim, **kw),
        "pos_emb_alpha_char": torch.ones((1,), **kw),
        "pos_emb_alpha": torch.ones((1,), **kw),
        "duration_predictor": variance_predictor_init(
            gen, cfg.model_dim, cfg.dur_predictor_hidden, cfg.dur_predictor_kernel,
            film_cond_dim=cfg.film_cond_dim, **kw),
        "decoder_layers": [fft_layer_init(gen, cfg, **kw)
                           for _ in range(cfg.num_decoder_layers)],
        "layer_norm": layer_norm_init(cfg.model_dim, **kw),
        "final_proj": linear_init(gen, cfg.model_dim, cfg.unit_vocab_size, **kw),
    }
    if cfg.prosody_proj_dim:
        p["prosody_proj"] = linear_init(gen, cfg.prosody_proj_dim, cfg.model_dim, **kw)
    return p


class NarT2UOutput(NamedTuple):
    unit_logits: torch.Tensor   # (B, U_max, unit_vocab) fp32
    unit_lengths: torch.Tensor  # (B,)
    durations: torch.Tensor     # (B, C_max) predicted per-char durations
    char_lengths: torch.Tensor  # (B,)


def _alpha_sin_pos(x: torch.Tensor, alpha: torch.Tensor, pad_idx: int) -> torch.Tensor:
    T, D = x.shape[1], x.shape[2]
    table = sinusoidal_positions(T + pad_idx + 2, D, padding_idx=pad_idx,
                                 dtype=x.dtype, device=x.device)
    pos = table[pad_idx + 1: pad_idx + 1 + T]
    return x + alpha.to(x.dtype) * pos[None]


def nar_t2u_decode(params: dict, cfg: NarT2UConfig, enc: torch.Tensor,
                   char_ids: torch.Tensor, char_counts: torch.Tensor, *,
                   max_unit_len: int, duration_factor: float = 1.0,
                   film_cond: Optional[torch.Tensor] = None) -> NarT2UOutput:
    """Char-level NAR decode of T2U-encoder features ``enc`` (B, T, D).
    ``char_ids`` (B, C_max) char token ids; ``char_counts`` (B, T) chars per
    subword token (0 on pads), both from the host char frontend;
    ``film_cond`` (B, 1, C) the FiLM condition of an expressive model."""
    C = char_ids.shape[1]
    char_hidden, char_total = hard_upsample(enc, char_counts, C)
    char_mask = lengths_to_padding_mask(char_total, C)
    char_emb = embedding(params["embed_char"], char_ids, scale=cfg.model_dim ** 0.5)
    char_hidden = _alpha_sin_pos(char_hidden, params["pos_emb_alpha_char"],
                                 cfg.pos_pad_idx) + char_emb

    log_dur = variance_predictor(params["duration_predictor"], char_hidden, char_mask,
                                 cond=film_cond)
    dur = durations_from_log(log_dur, char_mask, duration_factor=duration_factor)

    x, unit_total = hard_upsample(char_hidden, dur, max_unit_len)
    unit_total = torch.clamp_max(unit_total, max_unit_len)
    x = _alpha_sin_pos(x, params["pos_emb_alpha"], cfg.pos_pad_idx)
    unit_mask = lengths_to_padding_mask(unit_total, max_unit_len)
    bias = padding_bias(unit_mask)
    for lp in params["decoder_layers"]:
        x = fft_layer(lp, x, bias, unit_mask, cfg, cond=film_cond)
    x = layer_norm(params["layer_norm"], x)
    logits = linear(params["final_proj"], x).float()
    return NarT2UOutput(logits, unit_total, dur, char_total)


def nar_t2u_forward(params: dict, cfg: NarT2UConfig, text_dec_out: torch.Tensor,
                    text_lens: torch.Tensor, char_ids: torch.Tensor,
                    char_counts: torch.Tensor, *, max_unit_len: int,
                    duration_factor: float = 1.0,
                    prosody_embed: Optional[torch.Tensor] = None,
                    film_cond: Optional[torch.Tensor] = None) -> NarT2UOutput:
    """The full NAR T2U pass: the encoder over the text decoder's features
    (plus ``prosody_proj`` of ``prosody_embed`` (B, 1, P) where the model
    has one), then the char-level NAR decode."""
    enc = _encode(params, cfg, text_dec_out, text_lens, prosody_embed)
    return nar_t2u_decode(params, cfg, enc, char_ids, char_counts,
                          max_unit_len=max_unit_len, duration_factor=duration_factor,
                          film_cond=film_cond)


def _encode(params: dict, cfg: NarT2UConfig, text_dec_out: torch.Tensor,
            text_lens: torch.Tensor, prosody_embed: Optional[torch.Tensor]
            ) -> torch.Tensor:
    text_mask = lengths_to_padding_mask(text_lens, text_dec_out.shape[1])
    enc = transformer_encoder(params["encoder"], text_dec_out, cfg.enc_cfg(),
                              padding_mask=text_mask)
    if prosody_embed is not None and "prosody_proj" in params:
        enc = enc + linear(params["prosody_proj"], prosody_embed)
    return enc


class NarT2UTrainOutput(NamedTuple):
    unit_logits: torch.Tensor   # (B, U_max, unit_vocab) fp32 (ground-truth durations)
    log_dur_pred: torch.Tensor  # (B, C_max) the duration predictor's raw output
    unit_lengths: torch.Tensor  # (B,) from the ground-truth durations
    char_mask: torch.Tensor     # (B, C_max) True on real chars


def nar_t2u_train(params: dict, cfg: NarT2UConfig, text_dec_out: torch.Tensor,
                  text_lens: torch.Tensor, char_ids: torch.Tensor,
                  char_counts: torch.Tensor, gt_durations: torch.Tensor, *,
                  max_unit_len: int, prosody_embed: Optional[torch.Tensor] = None,
                  film_cond: Optional[torch.Tensor] = None) -> NarT2UTrainOutput:
    """The teacher-forced NAR T2U pass of finetuning: the encoder over the
    text decoder's features, the char-level upsampling by ``char_counts``
    with the char embedding and positions, the duration predictor's raw
    log-durations, then the upsampling by the ground-truth durations
    ``gt_durations`` (B, C_max) (0 past each row's chars, the total capped
    at ``max_unit_len``), the FFT layers and ``final_proj``; an expressive
    model's ``prosody_embed`` and ``film_cond`` as in ``nar_t2u_forward``."""
    enc = _encode(params, cfg, text_dec_out, text_lens, prosody_embed)
    C = char_ids.shape[1]
    char_hidden, char_total = hard_upsample(enc, char_counts, C)
    char_mask = lengths_to_padding_mask(char_total, C)
    char_emb = embedding(params["embed_char"], char_ids, scale=cfg.model_dim ** 0.5)
    char_hidden = _alpha_sin_pos(char_hidden, params["pos_emb_alpha_char"],
                                 cfg.pos_pad_idx) + char_emb

    log_dur = variance_predictor(params["duration_predictor"], char_hidden, char_mask,
                                 cond=film_cond)

    dur = torch.where(char_mask, gt_durations.to(torch.int32), 0)
    x, unit_total = hard_upsample(char_hidden, dur, max_unit_len)
    unit_total = torch.clamp_max(unit_total, max_unit_len)
    x = _alpha_sin_pos(x, params["pos_emb_alpha"], cfg.pos_pad_idx)
    unit_mask = lengths_to_padding_mask(unit_total, max_unit_len)
    bias = padding_bias(unit_mask)
    for lp in params["decoder_layers"]:
        x = fft_layer(lp, x, bias, unit_mask, cfg, cond=film_cond)
    x = layer_norm(params["layer_norm"], x)
    logits = linear(params["final_proj"], x).float()
    return NarT2UTrainOutput(logits, log_dur, unit_total, char_mask)


# ---------------------------------------------------------------------------
# AR T2U model (v1)
# ---------------------------------------------------------------------------

class ArT2UConfig(NamedTuple):
    model_dim: int = 1024
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 16
    ffn_inner_dim: int = 8192
    unit_vocab_size: int = 10082
    pad_idx: int = 1
    eos_idx: int = 2
    unk_idx: int = 3
    bos_idx: int = 0
    max_seq_len: int = 2048

    def enc_cfg(self) -> TransformerConfig:
        return TransformerConfig(self.model_dim, self.num_encoder_layers,
                                 self.num_heads, self.ffn_inner_dim, "relu",
                                 self.unit_vocab_size, self.pad_idx,
                                 self.max_seq_len, False)

    def dec_cfg(self) -> TransformerConfig:
        return TransformerConfig(self.model_dim, self.num_decoder_layers,
                                 self.num_heads, self.ffn_inner_dim, "relu",
                                 self.unit_vocab_size, self.pad_idx,
                                 self.max_seq_len, True)


def ar_t2u_init(gen: torch.Generator, cfg: ArT2UConfig, *, dtype=torch.float32,
                device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {"encoder": transformer_stack_init(gen, cfg.enc_cfg(), **kw),
            "embed": embedding_init(gen, cfg.unit_vocab_size, cfg.model_dim, **kw),
            "decoder": transformer_stack_init(gen, cfg.dec_cfg(), **kw)}


def ar_t2u_encode(params: dict, cfg: ArT2UConfig, text_dec_out: torch.Tensor,
                  text_lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder over the text decoder's features -> ((B, T, D) output,
    (B, T) padding mask, True on real positions)."""
    mask = lengths_to_padding_mask(text_lens, text_dec_out.shape[1])
    return transformer_encoder(params["encoder"], text_dec_out, cfg.enc_cfg(),
                               padding_mask=mask), mask


def ar_t2u_decoder_step(params: dict, tok_t: torch.Tensor, cache, step: int,
                        cfg: ArT2UConfig, *,
                        enc_padding_mask: Optional[torch.Tensor] = None,
                        beam_src: Optional[torch.Tensor] = None):
    """One KV-cached unit decode step -> ((B, V) fp32 logits through the
    tied embedding, cache); with an int8 cache, a ``beam_src`` and tensors
    on the card, each layer's self-attention is a decode-attention kernel
    (``transformer_decoder_step``)."""
    x = embedding_frontend(params["embed"], tok_t, cfg.dec_cfg(), start_step=step)
    h, cache = transformer_decoder_step(params["decoder"], x, cache, step,
                                        cfg.dec_cfg(), enc_padding_mask=enc_padding_mask,
                                        beam_src=beam_src)
    return tied_projection(params["embed"], h)[:, 0], cache


def ar_t2u_cache(params: dict, cfg: ArT2UConfig, enc_out: torch.Tensor, max_len: int,
                 kv_int8: bool = False):
    return decoder_cache_init(params["decoder"], cfg.dec_cfg(), enc_out, max_len,
                              kv_int8=kv_int8)
