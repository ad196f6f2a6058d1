"""Translator: the entry point of the port (counterpart of
``seamless_communication_tpu/inference/translator.py``).

Speech input (``s2st``, ``s2tt``, ``asr``): audio -> host fbank (80-mel,
2**15 scale, per-utterance standardization) -> speech encoder. Text input
(``t2st``, ``t2tt``): source tokens -> NLLB text encoder. Then the
beam-search text decode -> detokenization; for the speech outputs (``s2st``,
``t2st``) the re-decode, the host char frontend, the NAR T2U and the unit
HiFi-GAN vocoder. It runs on the CUDA card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from seamless_communication_torch.audio.fbank import FbankConfig, fbank_numpy
from seamless_communication_torch.audio.wav import read_wav, resample
from seamless_communication_torch.device import resolve_device
from seamless_communication_torch.inference.generator import (
    SequenceGeneratorOptions, UnitYGenerator, _bucket, stage_end,
)
from seamless_communication_torch.models.unity import model as unity
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.models.vocoder.codehifigan import (
    CodeHifiGanConfig, code_hifigan_forward,
)
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer

TEXT_TASKS = ("s2tt", "asr", "t2tt")         # text out
SPEECH_TASKS = ("s2st", "t2st")               # speech out
TEXT_INPUT_TASKS = ("t2tt", "t2st")


@dataclass
class BatchedSpeechOutput:
    """Units and waveforms of an ``s2st`` request, one of each per input."""
    units: List[List[int]]
    audio_wavs: List[np.ndarray]
    sample_rate: int = 16000


def params_to(params, device: torch.device):
    """``params`` with every tensor on ``device`` (shared subtrees stay
    shared)."""
    seen: dict = {}

    def walk(node):
        if isinstance(node, torch.Tensor):
            return node.to(device)
        if isinstance(node, dict):
            if id(node) not in seen:
                seen[id(node)] = {k: walk(v) for k, v in node.items()}
            return seen[id(node)]
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


class Translator:
    def __init__(self, params: dict, cfg: UnitYConfig, text_tokenizer: NllbTokenizer,
                 unit_tokenizer: Optional[UnitTokenizer] = None,
                 char_tokenizer: Optional[CharTokenizer] = None,
                 vocoder_params: Optional[dict] = None,
                 vocoder_cfg: Optional[CodeHifiGanConfig] = None,
                 lang_spkr_idx_map: Optional[dict] = None, *,
                 text_opts: Optional[SequenceGeneratorOptions] = None,
                 fbank_cfg: FbankConfig = FbankConfig(),
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.text_tokenizer = text_tokenizer
        self.vocoder_params = (None if vocoder_params is None
                               else params_to(vocoder_params, self.device))
        self.vocoder_cfg = vocoder_cfg
        self.lang_spkr_idx_map = lang_spkr_idx_map or {}
        self.fbank_cfg = fbank_cfg
        self.generator = UnitYGenerator(self.params, cfg, text_tokenizer, unit_tokenizer,
                                        char_tokenizer, text_opts, device=self.device)
        # wall seconds of each stage of the last predict(): encoder (speech
        # or text, the host front end included), text_decode and, for s2st
        # and t2st, redecode, t2u (the char frontend included) and vocoder
        self.last_timings: Dict[str, float] = {}

    def _audio_to_fbank(self, audio: Union[str, np.ndarray, Sequence],
                        sample_rate: int) -> tuple[np.ndarray, np.ndarray]:
        items = audio if isinstance(audio, (list, tuple)) else [audio]
        wavs = []
        for a in items:
            if isinstance(a, str):
                w, r = read_wav(a)
                wavs.append(resample(w, r, self.fbank_cfg.sample_rate))
            else:
                wavs.append(resample(np.asarray(a, np.float32), sample_rate,
                                     self.fbank_cfg.sample_rate))
        # per-utterance global mean/std; an empty input passes unnormalized
        feats = [((f - f.mean()) / (f.std() + 1e-7)).astype(np.float32)
                 if f.size else f.astype(np.float32)
                 for f in (fbank_numpy(w, self.fbank_cfg) for w in wavs)]
        lens = np.array([f.shape[0] for f in feats], np.int32)
        out = np.zeros((len(feats), _bucket(int(lens.max()), 128),
                        self.fbank_cfg.num_mel_bins), np.float32)
        for i, f in enumerate(feats):
            out[i, :f.shape[0]] = f
        return out, lens

    def _encode_text_input(self, input: Union[str, Sequence[str]], src_lang: str
                           ) -> unity.EncoderOutput:
        """Source texts -> text encoder output: each text as [lang, tokens,
        eos], the rows padded with ``pad_idx`` to a multiple of 16."""
        texts = input if isinstance(input, (list, tuple)) else [input]
        ids = [self.text_tokenizer.encode_source(t, src_lang) for t in texts]
        lens = np.array([len(i) for i in ids], np.int32)
        arr = np.full((len(ids), _bucket(int(lens.max()), 16)),
                      self.text_tokenizer.vocab_info.pad_idx, np.int64)
        for i, row in enumerate(ids):
            arr[i, :len(row)] = row
        return unity.encode_text(self.params, self.cfg,
                                 torch.as_tensor(arr, device=self.device),
                                 torch.as_tensor(lens, device=self.device))

    @torch.inference_mode()
    def predict(self, input, task_str: str, tgt_lang: str, *,
                src_lang: Optional[str] = None, sample_rate: int = 16000,
                spkr: int = -1, duration_factor: float = 1.0,
                text_generation_opts: Optional[SequenceGeneratorOptions] = None,
                ngram_filtering: bool = False, max_unit_len: int = 2048
                ) -> tuple[List[str], Optional[BatchedSpeechOutput]]:
        """Returns (texts, None) for a text-output task and (texts,
        BatchedSpeechOutput) for ``s2st``/``t2st``: one text, unit list and
        waveform per input. Speech input is a waveform (a path, an array at
        ``sample_rate``, or a list of them); text input is a string or a list
        of strings in ``src_lang``, which it requires."""
        task = task_str.lower()
        if task not in TEXT_TASKS + SPEECH_TASKS:
            raise ValueError(f"unknown task {task_str!r}; expected one of "
                             f"{', '.join(TEXT_TASKS + SPEECH_TASKS)}")
        if task in TEXT_INPUT_TASKS and src_lang is None:
            raise ValueError("src_lang required for text input")
        self.last_timings = {}
        t0 = time.perf_counter()
        if task in TEXT_INPUT_TASKS:
            enc = self._encode_text_input(input, src_lang)
        else:
            fbank, flens = self._audio_to_fbank(input, sample_rate)
            enc = unity.encode_speech(self.params, self.cfg,
                                      torch.as_tensor(fbank, device=self.device),
                                      torch.as_tensor(flens, device=self.device))
        t0 = stage_end(self.last_timings, "encoder", t0, self.device)
        # ASR: the target language is the source language
        text_lang = (src_lang or tgt_lang) if task == "asr" else tgt_lang
        tokens, tok_lens, _ = self.generator.generate_text(
            enc, text_lang, opts_override=text_generation_opts)
        texts = [self.text_tokenizer.decode(tokens[b, :tok_lens[b]])
                 for b in range(tokens.shape[0])]
        t0 = stage_end(self.last_timings, "text_decode", t0, self.device)
        if task in TEXT_TASKS:
            return texts, None

        units = self.generator.generate_units(
            tokens, tok_lens, enc, tgt_lang, duration_factor=duration_factor,
            max_unit_len=max_unit_len, ngram_filtering=ngram_filtering)
        self.last_timings.update(self.generator.last_timings)
        t0 = time.perf_counter()
        audio_wavs: List[np.ndarray] = []
        if self.vocoder_params is not None:
            audio_wavs = self.synthesize(units, tgt_lang, spkr=spkr)
        stage_end(self.last_timings, "vocoder", t0, self.device)
        return texts, BatchedSpeechOutput(units=units, audio_wavs=audio_wavs)

    @torch.inference_mode()
    def synthesize(self, units: List[List[int]], tgt_lang: str, *, spkr: int = -1
                   ) -> List[np.ndarray]:
        """Unit lists -> fp32 waveforms, one utterance at a time: units
        bucketed to 32, each repeated by its predicted duration up to 4 frames
        a unit in all; language and speaker ids from ``lang_spkr_idx_map``."""
        lang_map = self.lang_spkr_idx_map.get("multilingual", {})
        spkr_map = self.lang_spkr_idx_map.get("multispkr", {})
        lang_id = lang_map.get(tgt_lang, 0)
        spkrs = spkr_map.get(tgt_lang, [0])
        spkr_id = spkrs[spkr] if 0 <= spkr < len(spkrs) else spkrs[-1]

        def ids(values):
            return torch.as_tensor(np.asarray(values), device=self.device)

        out = []
        for u in units:
            if len(u) == 0:
                out.append(np.zeros((0,), np.float32))
                continue
            U = _bucket(len(u), 32)
            arr = np.zeros((1, U), np.int64)
            arr[0, :len(u)] = u
            res = code_hifigan_forward(self.vocoder_params, self.vocoder_cfg, ids(arr),
                                       ids([len(u)]), ids([lang_id]), ids([spkr_id]),
                                       max_unit_len=U * 4)
            n = int(res.sample_lengths[0])
            out.append(res.waveform[0, :n].float().cpu().numpy())
        return out
