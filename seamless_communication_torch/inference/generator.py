"""Two-pass generation of the UnitY model (counterpart of
``seamless_communication_tpu/inference/generator.py``).

Pass 1: beam search of the text hypothesis from the speech or text encoder
        output, with the optional step processors (banned sequences, n-gram
        repeat block); with ``SEAMLESS_CANDIDATE_BEAM=1`` (and no unk
        penalty or step processor) in candidate mode, over each beam's top
        2K+1 tokens from the fused vocabulary kernel.
Pass 2: re-decode the best hypothesis through the text decoder (full
        sequence) to get its features, run the T2U on them and detokenize
        the units: the NAR T2U of the v2 models (argmax; an expressive
        model's conditioned on the ECAPA embedding of the source's
        gcmvn-normalised fbank), or the AR T2U of
        the v1 models, a beam search over unit tokens from the prefix
        [eos, lang] over its KV-cached decoder (int8 KV on the card: the
        decode-attention kernel at every layer of every step).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from seamless_communication_torch.models.unity import model as unity
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.models.unity.t2u import (
    ar_t2u_cache, ar_t2u_decoder_step, ar_t2u_encode,
)
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.ops.beam_search import (
    BeamSearchOptions, BeamSearchResult, beam_search, make_banned_sequence_processor,
    make_ngram_repeat_block,
)
from seamless_communication_torch.text.char_frontend import text_to_char_seqs
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.utils.profiling import TRACER


def remove_consecutive_repeated_ngrams(seq: list, min_size: int = 1,
                                       max_size: int = 40) -> list:
    """Drop immediately repeated n-grams from a token list."""
    drop = set()
    for n in range(min_size, max_size + 1):
        for i in range(len(seq) - 2 * n + 1):
            if seq[i:i + n] == seq[i + n:i + 2 * n]:
                drop.update(range(i, i + n))
    return [tok for i, tok in enumerate(seq) if i not in drop]


@dataclass
class SequenceGeneratorOptions:
    """The JAX package's defaults (its inference/generator.py:51-67)."""
    beam_size: int = 5
    soft_max_seq_len: tuple[int, int] = (1, 200)
    hard_max_seq_len: int = 1024
    len_penalty: float = 1.0
    unk_penalty: float = 0.0
    no_repeat_ngram_size: Optional[int] = None  # n-gram repeat block
    kv_cache_int8: Optional[bool] = None  # None: int8 KV on the card, fp KV on the CPU
    kv_cache_bits: int = 8                # 4: packed-int4 self-attention KV


def _bucket(n: int, step: int = 64) -> int:
    return max(step, int(math.ceil(n / step)) * step)


def _resolve_kv(opts: SequenceGeneratorOptions, device: torch.device
                ) -> tuple[bool, int]:
    """(quantized KV?, bits per cached value): int8 KV on the card unless
    the options say otherwise; ``kv_cache_bits`` applies to a quantized
    cache only."""
    kv_int8 = (opts.kv_cache_int8 if opts.kv_cache_int8 is not None
               else device.type == "cuda")
    return kv_int8, (opts.kv_cache_bits if kv_int8 else 8)


class UnitYGenerator:
    """Two-pass generator over a UnitY parameter tree on ``device``."""

    def __init__(self, params: dict, cfg: UnitYConfig, text_tokenizer: NllbTokenizer,
                 unit_tokenizer: Optional[UnitTokenizer] = None,
                 char_tokenizer: Optional[CharTokenizer] = None,
                 text_opts: Optional[SequenceGeneratorOptions] = None,
                 unit_opts: Optional[SequenceGeneratorOptions] = None, *,
                 device: torch.device):
        """``unit_opts``: the AR T2U's beam (size, length penalty, n-gram
        block, KV cache); its maximum length is ``generate_units``'s
        ``max_unit_len``, as in the JAX package, so its length fields are
        not read."""
        self.params = params
        self.cfg = cfg
        self.text_tokenizer = text_tokenizer
        self.unit_tokenizer = unit_tokenizer
        self.char_tokenizer = char_tokenizer
        self.text_opts = text_opts or SequenceGeneratorOptions()
        self.unit_opts = unit_opts or SequenceGeneratorOptions()
        self.device = device
        self.last_result: Optional[BeamSearchResult] = None
        self.last_unit_result: Optional[BeamSearchResult] = None   # AR T2U
        # wall seconds of the re-decode, the prosody encoder (expressive
        # models) and the T2U in the last generate_units
        self.last_timings: dict = {}

    def generate_text(self, enc: unity.EncoderOutput, tgt_lang: str, *,
                      src_len_hint: Optional[int] = None,
                      banned: Optional[tuple] = None,
                      opts_override: Optional[SequenceGeneratorOptions] = None):
        """Beam-search text tokens. Returns (tokens (B, T), lengths (B,),
        scores (B,)) of the best hypotheses, as numpy arrays.

        ``src_len_hint``: the source length for the soft maximum length, in
        place of the encoder output's. ``banned``: ((N, M) int array, (N,)
        lengths) token sequences the beam must not complete
        (``make_banned_sequence_processor``)."""
        topts = opts_override or self.text_opts
        a, b = topts.soft_max_seq_len
        src = src_len_hint or int(enc.seqs.shape[1])
        max_len = _bucket(min(topts.hard_max_seq_len, a * src + b))
        nllb = self.cfg.nllb
        opts = BeamSearchOptions(beam_size=topts.beam_size, max_len=max_len,
                                 len_penalty=topts.len_penalty,
                                 unk_penalty=topts.unk_penalty, pad_idx=nllb.pad_idx,
                                 unk_idx=nllb.unk_idx, eos_idx=nllb.eos_idx)
        K = opts.beam_size
        B = enc.seqs.shape[0]
        enc_bk = unity.EncoderOutput(torch.repeat_interleave(enc.seqs, K, dim=0),
                                     torch.repeat_interleave(enc.lengths, K, dim=0))
        # the JAX package's switch for candidate mode, read per call; exact
        # only without an unk penalty and without step processors
        cand = (os.environ.get("SEAMLESS_CANDIDATE_BEAM") == "1"
                and banned is None and not topts.no_repeat_ngram_size
                and topts.unk_penalty == 0.0)
        procs = []
        if banned:
            procs.append(make_banned_sequence_processor(
                torch.as_tensor(np.asarray(banned[0]), device=self.device),
                torch.as_tensor(np.asarray(banned[1]), device=self.device),
                nllb.vocab_size))
        if topts.no_repeat_ngram_size:
            procs.append(make_ngram_repeat_block(topts.no_repeat_ngram_size,
                                                 nllb.vocab_size))
        step_fn, cache_fn = unity.make_text_decode_step(
            self.params, self.cfg, enc_bk, candidates=(2 * K + 1) if cand else None)
        kv_int8, kv_bits = _resolve_kv(topts, self.device)
        cache = cache_fn(max_len, kv_int8, kv_bits)
        prefix = torch.as_tensor(np.tile(self.text_tokenizer.target_prefix(tgt_lang),
                                         (B, 1)), device=self.device)
        prefix_len = torch.full((B,), prefix.shape[1], dtype=torch.int32,
                                device=self.device)
        res = beam_search(step_fn, cache, prefix, prefix_len, opts, nllb.vocab_size,
                          processors=procs, candidate_mode=cand)
        self.last_result = res
        return (res.tokens[:, 0].cpu().numpy(), res.lengths[:, 0].cpu().numpy(),
                res.scores[:, 0].cpu().numpy())

    def generate_units(self, text_tokens: np.ndarray, text_lens: np.ndarray,
                       enc: unity.EncoderOutput, tgt_lang: str, *,
                       duration_factor: float = 1.0, max_unit_len: int = 2048,
                       ngram_filtering: bool = False,
                       prosody_fbank: Optional[np.ndarray] = None,
                       prosody_lens: Optional[np.ndarray] = None,
                       unit_opts_override: Optional[SequenceGeneratorOptions] = None
                       ) -> List[List[int]]:
        """Pass 2: re-decode the text, run the T2U (NAR or AR), detokenize
        to raw units. Returns one list of unit ids per utterance.
        ``unit_opts_override``: the AR T2U's beam options for this call.

        ``prosody_fbank`` (B, T, 80), ``prosody_lens`` (B,): the source's
        gcmvn-normalised fbank, which an expressive model (one with a
        ``prosody_encoder``) requires; its ECAPA embedding (the wall of
        ``last_timings["prosody_encoder"]``) is the NAR T2U's prosody input
        and FiLM condition. Other models ignore it."""
        expressive = "prosody_encoder" in self.params
        if expressive and prosody_fbank is None:
            raise ValueError("expressive model (prosody_encoder present) requires "
                             "prosody_fbank for unit generation")
        dev = self.device
        self.last_timings = {}
        t0 = time.perf_counter()
        max_text = int(text_lens.max())
        T = _bucket(max_text, 16)
        ids = np.asarray(text_tokens[:, :T])
        # the final column is trimmed before the re-decode, as in the
        # reference: the longest rows lose their trailing EOS position
        t2u_lens = text_lens - (text_lens == max_text)
        lens = torch.as_tensor(t2u_lens, device=dev)
        feats = unity.decode_text(self.params, self.cfg, torch.as_tensor(ids, device=dev),
                                  enc, self_lengths=lens)
        t0 = TRACER.stage_end(self.last_timings, "redecode", t0, dev)
        if self.cfg.nar_t2u is not None:
            char_ids, _, char_counts = text_to_char_seqs(
                self.text_tokenizer, self.char_tokenizer, ids,
                max_char_len=_bucket(max_text * 12, 64))
            prosody = None
            if expressive:
                prosody = unity.encode_prosody(
                    self.params, self.cfg,
                    torch.as_tensor(np.asarray(prosody_fbank, np.float32), device=dev),
                    torch.as_tensor(np.asarray(prosody_lens, np.int64), device=dev))
                t0 = TRACER.stage_end(self.last_timings, "prosody_encoder", t0, dev)
            out = unity.t2u_nar(self.params, self.cfg, feats, lens,
                                torch.as_tensor(char_ids, device=dev),
                                torch.as_tensor(char_counts, device=dev),
                                max_unit_len=max_unit_len,
                                duration_factor=duration_factor,
                                prosody_embed=prosody, film_cond=prosody)
            units = out.unit_logits.argmax(dim=-1).cpu().numpy()
            unit_lens = out.unit_lengths.cpu().numpy()
            raw = self.unit_tokenizer.decode(units)     # offset -4, EOS -> pad
        else:
            res = self._ar_units(feats, lens, tgt_lang, max_unit_len,
                                 unit_opts_override or self.unit_opts)
            raw = self.unit_tokenizer.decode(res.tokens[:, 0].cpu().numpy())
            raw = raw[:, 1:]    # the lang symbol the decoder keeps at position 0
            # the hypothesis is [eos, lang, units..., eos]: 3 tokens not units
            unit_lens = np.maximum(res.lengths[:, 0].cpu().numpy() - 3, 0)
        TRACER.stage_end(self.last_timings, "t2u", t0, dev)
        out_units = []
        for b in range(raw.shape[0]):
            u = [int(t) for t in raw[b, :unit_lens[b]]
                 if 0 <= t < self.unit_tokenizer.num_units]
            if ngram_filtering:
                u = remove_consecutive_repeated_ngrams(u)
            out_units.append(u)
        return out_units

    def _ar_units(self, feats: torch.Tensor, lens: torch.Tensor, tgt_lang: str,
                  max_len: int, uopts: SequenceGeneratorOptions) -> BeamSearchResult:
        """The AR T2U's beam search over unit tokens: the encoder over the
        re-decoded features, then ``uopts.beam_size`` beams from the prefix
        [eos, lang] up to ``max_len`` tokens over the KV-cached decoder,
        with the n-gram block where the options ask for it."""
        tcfg = self.cfg.ar_t2u
        t2u = self.params["t2u"]
        K = uopts.beam_size
        enc, mask = ar_t2u_encode(t2u, tcfg, feats, lens)
        enc_bk = torch.repeat_interleave(enc, K, dim=0)
        mask_bk = torch.repeat_interleave(mask, K, dim=0)
        # the AR T2U's cache is int8 or fp: the packed-int4 option is the
        # text decoder's only, as in the JAX package
        kv_int8, _ = _resolve_kv(uopts, self.device)
        cache = ar_t2u_cache(t2u, tcfg, enc_bk, max_len, kv_int8)

        def step_fn(tok_t, cache, step: int, beam_src: Optional[torch.Tensor] = None):
            return ar_t2u_decoder_step(t2u, tok_t, cache, step, tcfg,
                                       enc_padding_mask=mask_bk, beam_src=beam_src)

        V = tcfg.unit_vocab_size
        procs = ([make_ngram_repeat_block(uopts.no_repeat_ngram_size, V)]
                 if uopts.no_repeat_ngram_size else [])
        opts = BeamSearchOptions(beam_size=K, max_len=max_len,
                                 len_penalty=uopts.len_penalty, pad_idx=tcfg.pad_idx,
                                 unk_idx=tcfg.unk_idx, eos_idx=tcfg.eos_idx,
                                 bos_idx=tcfg.bos_idx)
        B = feats.shape[0]
        prefix = torch.tensor([[tcfg.eos_idx, self.unit_tokenizer.lang_to_index(tgt_lang)]],
                              dtype=torch.int32, device=self.device).repeat(B, 1)
        prefix_len = torch.full((B,), 2, dtype=torch.int32, device=self.device)
        res = beam_search(step_fn, cache, prefix, prefix_len, opts, V, processors=procs)
        self.last_unit_result = res
        return res
