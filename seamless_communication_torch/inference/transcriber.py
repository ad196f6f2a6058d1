"""Transcriber: ASR with word-level timestamps and confidences (counterpart of
``seamless_communication_tpu/inference/transcriber.py``; reference
inference/transcriber.py).

The speech goes through the Translator's host fbank and speech encoder, the
text through its beam search (K1 at every step of every decoder layer on the
card; K6 in each conformer layer with ``SEAMLESS_FUSED_ATTN=1``). The best
hypothesis is then decoded again over the full sequence, returning the last
decoder layer's cross-attention probabilities, which are median-filtered to
align each token to an encoder frame. Long audio is cut by ``VADSegmenter``;
the optional denoiser is ``denoise/denoiser.py``'s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np
import torch

from seamless_communication_torch.inference.generator import (
    SequenceGeneratorOptions, _bucket,
)
from seamless_communication_torch.inference.translator import Translator
from seamless_communication_torch.models.nllb.model import (
    text_decoder_cache, text_decoder_step,
)
from seamless_communication_torch.models.unity import model as unity
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.ops import attention as attn_ops
from seamless_communication_torch.ops.masks import (
    causal_mask, lengths_to_padding_mask, padding_bias,
)
from seamless_communication_torch.ops.modules import layer_norm, linear
from seamless_communication_torch.ops.transformer import (
    _ACTIVATIONS, embedding_frontend, tied_projection,
)
from seamless_communication_torch.segment.vad import VADSegmenter
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import SPM_SPACE


@dataclass
class TranscriptionToken:
    text: str
    time_s: float
    prob: float


@dataclass
class Transcription:
    tokens: List[TranscriptionToken] = field(default_factory=list)

    @property
    def text(self) -> str:
        return "".join(t.text for t in self.tokens).replace(SPM_SPACE, " ").strip()

    def words(self) -> List[TranscriptionToken]:
        """Subword tokens merged into words at the ▁ boundaries: a word's
        time is its first subword's, its probability the smallest."""
        words: List[TranscriptionToken] = []
        for t in self.tokens:
            if t.text.startswith(SPM_SPACE) or not words:
                words.append(TranscriptionToken(t.text.replace(SPM_SPACE, ""),
                                                t.time_s, t.prob))
            else:
                words[-1].text += t.text
                words[-1].prob = min(words[-1].prob, t.prob)
        return [w for w in words if w.text]


def decode_with_cross_attn(params: dict, cfg: UnitYConfig, ids: torch.Tensor,
                           enc: unity.EncoderOutput, *,
                           self_lengths: Optional[torch.Tensor] = None):
    """Full-sequence text decode of ``ids`` (B, T) -> ((B, T, V) fp32 logits,
    the LAST decoder layer's (B, H, T, S) cross-attention probabilities).
    The JAX package scans the stacked layers; here the loop runs over the
    layer list."""
    tcfg = cfg.nllb.dec_cfg()
    embed = params["text_decoder"]["embed"]
    x = embedding_frontend(embed, ids, tcfg, padding_mask=(
        lengths_to_padding_mask(self_lengths, ids.shape[1])
        if self_lengths is not None else None))
    self_bias = causal_mask(x.shape[1], device=x.device)[None, None]
    cross_bias = padding_bias(enc.padding_mask)
    act = _ACTIVATIONS[tcfg.activation]
    stack = params["text_decoder"]["stack"]
    probs = None
    for lp in stack["layers"]:
        z = layer_norm(lp["self_attn_layer_norm"], x)
        x = x + attn_ops.multi_head_attention(lp["self_attn"], z, z, tcfg.num_heads,
                                              bias=self_bias)
        z = layer_norm(lp["cross_attn_layer_norm"], x)
        kv = attn_ops.cross_attention_precompute(lp["cross_attn"], enc.seqs,
                                                 tcfg.num_heads)
        y, probs = attn_ops.cross_attention_step(lp["cross_attn"], z, kv, tcfg.num_heads,
                                                 bias=cross_bias, return_probs=True)
        x = x + y
        z = layer_norm(lp["ffn"]["layer_norm"], x)
        x = x + linear(lp["ffn"]["output_proj"], act(linear(lp["ffn"]["inner_proj"], z)))
    x = layer_norm(stack["layer_norm"], x)
    return tied_projection(embed, x), probs


def _median_filter(x: np.ndarray, k: int = 7) -> np.ndarray:
    """Median filter along the last (source) axis, the edges repeated."""
    if k <= 1:
        return x
    pad = k // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    out = np.empty_like(x)
    for i in range(x.shape[-1]):
        out[..., i] = np.median(xp[..., i:i + k], axis=-1)
    return out


class Transcriber:
    """ASR with timestamps over a UnitY tree, on the CUDA card unless
    ``device`` says otherwise."""

    # seconds of source audio an encoder frame: the 10 ms fbank hop x 2
    # (frame stacking) x 8 (the adaptor's stride)
    SECONDS_PER_ENC_FRAME = 0.16

    def __init__(self, params: dict, cfg: UnitYConfig, text_tokenizer: NllbTokenizer, *,
                 denoiser=None, chunk_size_sec: float = 20.0,
                 text_opts: Optional[SequenceGeneratorOptions] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """``text_opts``: the beam search's options (the JAX package's
        defaults where not given)."""
        self.cfg = cfg
        self.text_tokenizer = text_tokenizer
        self.denoiser = denoiser
        self.segmenter = VADSegmenter(chunk_size_sec=chunk_size_sec)
        self.translator = Translator(params, cfg, text_tokenizer, text_opts=text_opts,
                                     device=device)
        self.params = self.translator.params
        self.device = self.translator.device

    def _encode(self, wav: np.ndarray) -> unity.EncoderOutput:
        fbank, flens = self.translator._audio_to_fbank(wav, 16000)
        return unity.encode_speech(self.params, self.cfg,
                                   torch.as_tensor(fbank, device=self.device),
                                   torch.as_tensor(flens, device=self.device))

    @torch.inference_mode()
    def transcribe(self, waveform: np.ndarray, src_lang: str, *,
                   sample_rate: int = 16000, denoise: bool = False) -> Transcription:
        """Tokens with their times (s from the input's start) and
        probabilities. Inputs longer than ``chunk_size_sec`` are split by the
        VAD; spans under 400 samples are skipped."""
        wav = np.asarray(waveform, np.float32)
        if denoise and self.denoiser is not None:
            wav = self.denoiser.denoise(wav, sample_rate)
        chunk_samples = int(self.segmenter.chunk_size_sec * sample_rate)
        if len(wav) > chunk_samples:
            spans = self.segmenter.segment_long_input(wav) or [(0, len(wav))]
        else:
            spans = [(0, len(wav))]
        result = Transcription()
        for start, end in spans:
            seg = wav[start:end]
            if len(seg) < 400:
                continue
            offset = start / sample_rate
            result.tokens.extend(TranscriptionToken(t.text, t.time_s + offset, t.prob)
                                 for t in self._transcribe_segment(seg, src_lang).tokens)
        return result

    @torch.inference_mode()
    def lid_scores(self, waveform: np.ndarray, *, topk: int = 5) -> dict:
        """Language identification: the probabilities of the language tokens
        at the first decode position after the prefix [eos], the ``topk``
        largest (reference unity_lib's LID scores)."""
        enc = self._encode(np.asarray(waveform, np.float32))
        nllb = self.cfg.nllb
        cache = text_decoder_cache(self.params["text_decoder"], nllb, enc.seqs, 4)
        tok = torch.full((enc.seqs.shape[0], 1), nllb.eos_idx, dtype=torch.int64,
                         device=self.device)
        logits, _ = text_decoder_step(self.params["text_decoder"], tok, cache, 0, nllb,
                                      enc_padding_mask=enc.padding_mask)
        probs = torch.softmax(logits[0].float(), dim=-1).cpu().numpy()
        scores = {lang: float(probs[tid])
                  for lang, tid in self.text_tokenizer.lang_to_id.items()}
        return dict(sorted(scores.items(), key=lambda kv: -kv[1])[:topk])

    def _transcribe_segment(self, wav: np.ndarray, src_lang: str) -> Transcription:
        enc = self._encode(wav)
        tokens, tok_lens, _ = self.translator.generator.generate_text(enc, src_lang)
        T = _bucket(int(tok_lens.max()), 16)
        logits, cross = decode_with_cross_attn(
            self.params, self.cfg, torch.as_tensor(tokens[:, :T], device=self.device),
            enc, self_lengths=torch.as_tensor(tok_lens, device=self.device))
        probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
        attn = _median_filter(cross.float().mean(dim=1).cpu().numpy())   # (B, T, S)
        out = Transcription()
        L = int(tok_lens[0])
        enc_len = int(enc.lengths[0])
        for t in range(1, L - 1):       # skip the [eos, lang] prefix and the final eos
            tok_id = int(tokens[0, t + 1])
            if tok_id in (0, 2, 3):
                continue
            # the attention row of the step that produced token t + 1 is row t
            frame = int(np.argmax(attn[0, t, :enc_len]))
            out.tokens.append(TranscriptionToken(self.text_tokenizer.id_to_token(tok_id),
                                                 frame * self.SECONDS_PER_ENC_FRAME,
                                                 float(probs[0, t, tok_id])))
        return out
