"""NLLB text decoder (counterpart of the decoder half of
``seamless_communication_tpu/models/nllb/model.py``): the KV-cached step of
the beam search and the full-sequence re-decode. dense_1b is 24 layers,
1024-d, ffn 8192, vocab 256102, with the output projection tied to the
embedding."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seamless_communication_torch.ops.modules import embedding_init
from seamless_communication_torch.ops.transformer import (
    TransformerConfig, decoder_cache_init, embedding_frontend, tied_projection,
    transformer_decoder, transformer_decoder_step, transformer_stack_init,
)


class NllbConfig(NamedTuple):
    dim: int = 1024
    num_encoder_layers: int = 24
    num_decoder_layers: int = 24
    num_heads: int = 16
    ffn_inner_dim: int = 8192
    vocab_size: int = 256102
    pad_idx: int = 0
    eos_idx: int = 3
    unk_idx: int = 1
    max_seq_len: int = 4096
    activation: str = "relu"

    def dec_cfg(self) -> TransformerConfig:
        return TransformerConfig(self.dim, self.num_decoder_layers, self.num_heads,
                                 self.ffn_inner_dim, self.activation, self.vocab_size,
                                 self.pad_idx, self.max_seq_len, True)


def text_decoder_init(gen: torch.Generator, cfg: NllbConfig, *, dtype=torch.float32,
                      device=None) -> dict:
    return {"embed": embedding_init(gen, cfg.vocab_size, cfg.dim, dtype=dtype,
                                    device=device),
            "stack": transformer_stack_init(gen, cfg.dec_cfg(), dtype=dtype,
                                            device=device)}


def text_decoder_forward(params: dict, ids: torch.Tensor, enc_out: torch.Tensor,
                         cfg: NllbConfig, *,
                         enc_padding_mask: Optional[torch.Tensor] = None,
                         self_padding_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Full-sequence decode -> (B, T, D) features (before the projection)."""
    x = embedding_frontend(params["embed"], ids, cfg.dec_cfg(),
                           padding_mask=self_padding_mask)
    return transformer_decoder(params["stack"], x, cfg.dec_cfg(), enc_out=enc_out,
                               enc_padding_mask=enc_padding_mask,
                               self_padding_mask=self_padding_mask)


def text_decoder_step(params: dict, tok_t: torch.Tensor, cache, step: int,
                      cfg: NllbConfig, *,
                      enc_padding_mask: Optional[torch.Tensor] = None,
                      beam_src: Optional[torch.Tensor] = None):
    """One KV-cached decode step -> ((B, V) fp32 logits, cache)."""
    x = embedding_frontend(params["embed"], tok_t, cfg.dec_cfg(), start_step=step)
    h, cache = transformer_decoder_step(params["stack"], x, cache, step, cfg.dec_cfg(),
                                        enc_padding_mask=enc_padding_mask,
                                        beam_src=beam_src)
    return tied_projection(params["embed"], h)[:, 0], cache


def text_decoder_cache(params: dict, cfg: NllbConfig, enc_out: torch.Tensor,
                       max_len: int, *, kv_int8: bool = False, kv_bits: int = 8):
    return decoder_cache_init(params["stack"], cfg.dec_cfg(), enc_out, max_len,
                              kv_int8=kv_int8, kv_bits=kv_bits)
