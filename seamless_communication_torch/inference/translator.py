"""Translator: the entry point of the port (counterpart of
``seamless_communication_tpu/inference/translator.py``).

Speech-to-text translation (``s2tt``) and speech recognition (``asr``):
audio -> host fbank (80-mel, 2**15 scale, per-utterance standardization) ->
speech encoder -> beam-search text decode -> detokenization. It runs on the
CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from seamless_communication_torch.audio.fbank import FbankConfig, fbank_numpy
from seamless_communication_torch.audio.wav import read_wav, resample
from seamless_communication_torch.device import resolve_device
from seamless_communication_torch.inference.generator import (
    SequenceGeneratorOptions, UnitYGenerator, _bucket,
)
from seamless_communication_torch.models.unity import model as unity
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.text.nllb import NllbTokenizer

TEXT_TASKS = ("s2tt", "asr")
# tasks of the JAX package that later slices of the port add
LATER_TASKS = {"s2st": "slice 2 (NAR T2U and the unit vocoder)",
               "t2st": "slice 3 (the text encoder), after slice 2",
               "t2tt": "slice 3 (the text encoder)"}


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
                 *, text_opts: Optional[SequenceGeneratorOptions] = None,
                 fbank_cfg: FbankConfig = FbankConfig(),
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.text_tokenizer = text_tokenizer
        self.fbank_cfg = fbank_cfg
        self.generator = UnitYGenerator(self.params, cfg, text_tokenizer, text_opts,
                                        device=self.device)

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

    @torch.inference_mode()
    def predict(self, input, task_str: str, tgt_lang: str, *,
                src_lang: Optional[str] = None, sample_rate: int = 16000,
                text_generation_opts: Optional[SequenceGeneratorOptions] = None
                ) -> tuple[List[str], None]:
        """Returns (texts, None): one text per input waveform (a path, an
        array at ``sample_rate``, or a list of them)."""
        task = task_str.lower()
        if task in LATER_TASKS:
            raise NotImplementedError(f"task {task_str!r} is not ported yet: it comes "
                                      f"with {LATER_TASKS[task]}")
        if task not in TEXT_TASKS:
            raise ValueError(f"unknown task {task_str!r}; expected one of "
                             f"{', '.join(TEXT_TASKS + tuple(LATER_TASKS))}")
        fbank, flens = self._audio_to_fbank(input, sample_rate)
        enc = unity.encode_speech(self.params, self.cfg,
                                  torch.as_tensor(fbank, device=self.device),
                                  torch.as_tensor(flens, device=self.device))
        # ASR: the target language is the source language
        text_lang = (src_lang or tgt_lang) if task == "asr" else tgt_lang
        tokens, tok_lens, _ = self.generator.generate_text(
            enc, text_lang, opts_override=text_generation_opts)
        return [self.text_tokenizer.decode(tokens[b, :tok_lens[b]])
                for b in range(tokens.shape[0])], None
