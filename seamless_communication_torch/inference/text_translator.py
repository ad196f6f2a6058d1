"""Standalone NLLB text translation (counterpart of
``seamless_communication_tpu/inference/text_translator.py``): an NLLB
encoder and decoder pair with the beam search, for text-to-text serving
without any speech components. It runs on the CUDA card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.inference.generator import (
    SequenceGeneratorOptions, _bucket,
)
from seamless_communication_torch.models.nllb.model import (
    NllbConfig, text_decoder_cache, text_decoder_step, text_encoder_forward,
)
from seamless_communication_torch.ops.beam_search import BeamSearchOptions, beam_search
from seamless_communication_torch.text.nllb import NllbTokenizer


class TextTranslator:
    """T2TT over an NLLB encoder and decoder parameter pair. The decoder's
    self-attention cache is fp, as the JAX package's default."""

    def __init__(self, enc_params: dict, dec_params: dict, cfg: NllbConfig,
                 tokenizer: NllbTokenizer, opts: Optional[SequenceGeneratorOptions] = None,
                 *, device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.enc_params = params_to(enc_params, self.device)
        self.dec_params = params_to(dec_params, self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.opts = opts or SequenceGeneratorOptions()

    @torch.inference_mode()
    def translate(self, texts: Sequence[str], src_lang: str, tgt_lang: str) -> List[str]:
        ids_list = [self.tokenizer.encode_source(t, src_lang) for t in texts]
        lens = np.array([len(i) for i in ids_list], np.int64)
        T = _bucket(int(lens.max()), 16)
        arr = np.full((len(texts), T), self.cfg.pad_idx, np.int64)
        for i, s in enumerate(ids_list):
            arr[i, :len(s)] = s
        a, b = self.opts.soft_max_seq_len
        max_len = _bucket(min(self.opts.hard_max_seq_len, a * T + b))
        K = self.opts.beam_size
        opts = BeamSearchOptions(
            beam_size=K, max_len=max_len, len_penalty=self.opts.len_penalty,
            unk_penalty=self.opts.unk_penalty, pad_idx=self.cfg.pad_idx,
            unk_idx=self.cfg.unk_idx, eos_idx=self.cfg.eos_idx)
        ids = torch.as_tensor(arr, device=self.device)
        lengths = torch.as_tensor(lens, device=self.device)
        enc_out, mask = text_encoder_forward(self.enc_params, ids, lengths, self.cfg)
        enc_bk = torch.repeat_interleave(enc_out, K, dim=0)
        mask_bk = torch.repeat_interleave(mask, K, dim=0)

        def step_fn(tok_t, cache, step: int, beam_src: Optional[torch.Tensor] = None):
            return text_decoder_step(self.dec_params, tok_t, cache, step, self.cfg,
                                     enc_padding_mask=mask_bk, beam_src=beam_src)

        cache = text_decoder_cache(self.dec_params, self.cfg, enc_bk, max_len)
        prefix = torch.as_tensor(np.tile(self.tokenizer.target_prefix(tgt_lang),
                                         (len(texts), 1)), device=self.device)
        prefix_len = torch.full((len(texts),), prefix.shape[1], dtype=torch.int32,
                                device=self.device)
        res = beam_search(step_fn, cache, prefix, prefix_len, opts, self.cfg.vocab_size)
        tokens, res_lens = res.tokens[:, 0].cpu().numpy(), res.lengths[:, 0].cpu().numpy()
        return [self.tokenizer.decode(tokens[i, :res_lens[i]]) for i in range(len(texts))]
