"""NLLB text encoder and decoder (counterpart of
``seamless_communication_tpu/models/nllb/model.py``): the text encoder of the
text-input tasks, the KV-cached step of the beam search (full-vocabulary or
candidate form) and the full-sequence re-decode. dense_1b is 24 + 24 layers,
1024-d, ffn 8192, vocab 256102, with the encoder's embedding, the decoder's
and the output projection tied to one table."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seamless_communication_torch.ops.kernels.vocab_topk import (
    float_vocab_topk, int8_vocab_topk_v2,
)
from seamless_communication_torch.ops.masks import lengths_to_padding_mask
from seamless_communication_torch.ops.modules import embedding_init
from seamless_communication_torch.ops.transformer import (
    TransformerConfig, decoder_cache_init, embedding_frontend, tied_projection,
    transformer_decoder, transformer_decoder_step, transformer_encoder,
    transformer_stack_init,
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

    def enc_cfg(self) -> TransformerConfig:
        return TransformerConfig(self.dim, self.num_encoder_layers, self.num_heads,
                                 self.ffn_inner_dim, self.activation, self.vocab_size,
                                 self.pad_idx, self.max_seq_len, False)

    def dec_cfg(self) -> TransformerConfig:
        return TransformerConfig(self.dim, self.num_decoder_layers, self.num_heads,
                                 self.ffn_inner_dim, self.activation, self.vocab_size,
                                 self.pad_idx, self.max_seq_len, True)


def text_encoder_init(gen: torch.Generator, cfg: NllbConfig, *, dtype=torch.float32,
                      device=None, tie_embed: Optional[dict] = None) -> dict:
    """``tie_embed``: the decoder's ``embed`` dict to share instead of drawing
    a table of its own."""
    embed = tie_embed if tie_embed is not None else embedding_init(
        gen, cfg.vocab_size, cfg.dim, dtype=dtype, device=device)
    return {"embed": embed,
            "stack": transformer_stack_init(gen, cfg.enc_cfg(), dtype=dtype,
                                            device=device)}


def text_decoder_init(gen: torch.Generator, cfg: NllbConfig, *, dtype=torch.float32,
                      device=None) -> dict:
    return {"embed": embedding_init(gen, cfg.vocab_size, cfg.dim, dtype=dtype,
                                    device=device),
            "stack": transformer_stack_init(gen, cfg.dec_cfg(), dtype=dtype,
                                            device=device)}


def text_encoder_forward(params: dict, ids: torch.Tensor, lengths: torch.Tensor,
                         cfg: NllbConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) source ids with (B,) lengths -> ((B, S, D) encoder output,
    (B, S) padding mask, True on real positions)."""
    mask = lengths_to_padding_mask(lengths, ids.shape[1])
    x = embedding_frontend(params["embed"], ids, cfg.enc_cfg(), padding_mask=mask)
    return transformer_encoder(params["stack"], x, cfg.enc_cfg(), padding_mask=mask), mask


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


def text_decoder_step_topk(params: dict, tok_t: torch.Tensor, cache, step: int,
                           cfg: NllbConfig, k: int, *,
                           enc_padding_mask: Optional[torch.Tensor] = None,
                           beam_src: Optional[torch.Tensor] = None):
    """One KV-cached decode step in candidate form -> ((B, k) top
    log-probabilities, (B, k) int32 vocabulary ids, cache). With an int8 tied
    embedding the projection, the logsumexp and the top-k are one call of
    ``int8_vocab_topk_v2`` (a kernel on the card), which reads the int8 table
    as it is; without one, ``float_vocab_topk`` in plain PyTorch, as the JAX
    package does on every backend."""
    x = embedding_frontend(params["embed"], tok_t, cfg.dec_cfg(), start_step=step)
    h, cache = transformer_decoder_step(params["stack"], x, cache, step, cfg.dec_cfg(),
                                        enc_padding_mask=enc_padding_mask,
                                        beam_src=beam_src)
    h1 = h[:, 0].contiguous()
    embed = params["embed"]
    if "embedding_i8" in embed:
        vals, idx, logz = int8_vocab_topk_v2(h1, embed["embedding_i8"],
                                             embed["row_scale"], k)
    else:
        vals, idx, logz = float_vocab_topk(h1, embed["embedding"], k)
    return vals - logz[:, None], idx, cache


def text_decoder_cache(params: dict, cfg: NllbConfig, enc_out: torch.Tensor,
                       max_len: int, *, kv_int8: bool = False, kv_bits: int = 8):
    return decoder_cache_init(params["stack"], cfg.dec_cfg(), enc_out, max_len,
                              kv_int8=kv_int8, kv_bits=kv_bits)
