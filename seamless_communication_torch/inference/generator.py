"""Text generation of the UnitY model (counterpart of the text pass of
``seamless_communication_tpu/inference/generator.py``): beam search of the
text hypothesis from the encoder output."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from seamless_communication_torch.models.unity import model as unity
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.ops.beam_search import (
    BeamSearchOptions, BeamSearchResult, beam_search,
)
from seamless_communication_torch.text.nllb import NllbTokenizer


@dataclass
class SequenceGeneratorOptions:
    """The JAX package's defaults (reference generator.py:59-84)."""
    beam_size: int = 5
    soft_max_seq_len: tuple[int, int] = (1, 200)
    hard_max_seq_len: int = 1024
    len_penalty: float = 1.0
    unk_penalty: float = 0.0
    kv_cache_int8: Optional[bool] = None  # None: int8 KV on the card, fp KV on the CPU


def _bucket(n: int, step: int = 64) -> int:
    return max(step, int(math.ceil(n / step)) * step)


def _resolve_kv_int8(opts: SequenceGeneratorOptions, device: torch.device) -> bool:
    if opts.kv_cache_int8 is not None:
        return opts.kv_cache_int8
    return device.type == "cuda"


class UnitYGenerator:
    """Beam-search text generator over a UnitY parameter tree on ``device``."""

    def __init__(self, params: dict, cfg: UnitYConfig, text_tokenizer: NllbTokenizer,
                 text_opts: Optional[SequenceGeneratorOptions] = None, *,
                 device: torch.device):
        self.params = params
        self.cfg = cfg
        self.text_tokenizer = text_tokenizer
        self.text_opts = text_opts or SequenceGeneratorOptions()
        self.device = device
        self.last_result: Optional[BeamSearchResult] = None

    def generate_text(self, enc: unity.EncoderOutput, tgt_lang: str, *,
                      opts_override: Optional[SequenceGeneratorOptions] = None):
        """Beam-search text tokens. Returns (tokens (B, T), lengths (B,),
        scores (B,)) of the best hypotheses, as numpy arrays."""
        topts = opts_override or self.text_opts
        a, b = topts.soft_max_seq_len
        max_len = _bucket(min(topts.hard_max_seq_len, a * int(enc.seqs.shape[1]) + b))
        nllb = self.cfg.nllb
        opts = BeamSearchOptions(beam_size=topts.beam_size, max_len=max_len,
                                 len_penalty=topts.len_penalty,
                                 unk_penalty=topts.unk_penalty, pad_idx=nllb.pad_idx,
                                 unk_idx=nllb.unk_idx, eos_idx=nllb.eos_idx)
        K = opts.beam_size
        B = enc.seqs.shape[0]
        enc_bk = unity.EncoderOutput(torch.repeat_interleave(enc.seqs, K, dim=0),
                                     torch.repeat_interleave(enc.lengths, K, dim=0))
        step_fn, cache_fn = unity.make_text_decode_step(self.params, self.cfg, enc_bk)
        cache = cache_fn(max_len, _resolve_kv_int8(topts, self.device))
        prefix = torch.as_tensor(np.tile(self.text_tokenizer.target_prefix(tgt_lang),
                                         (B, 1)), device=self.device)
        prefix_len = torch.full((B,), prefix.shape[1], dtype=torch.int32,
                                device=self.device)
        res = beam_search(step_fn, cache, prefix, prefix_len, opts, nllb.vocab_size)
        self.last_result = res
        return (res.tokens[:, 0].cpu().numpy(), res.lengths[:, 0].cpu().numpy(),
                res.scores[:, 0].cpu().numpy())
