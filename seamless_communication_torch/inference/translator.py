"""Translator: the entry point of the port (counterpart of
``seamless_communication_tpu/inference/translator.py``).

Speech input (``s2st``, ``s2tt``, ``asr``): audio -> host fbank (80-mel,
2**15 scale, per-utterance or per-mel-bin standardization), or precomputed
raw log-mels (:class:`FbankInput`) -> speech encoder. Text input (``t2st``,
``t2tt``): source tokens -> NLLB text encoder. Then the beam-search text
decode -> detokenization; for the speech outputs (``s2st``, ``t2st``) the
re-decode, the T2U (the v2 models' host char frontend and NAR T2U, or the v1
models' AR T2U beam search) and the unit HiFi-GAN vocoder. With
``apply_mintox`` the outputs are checked for added toxicity against the
source (ETOX) and the offending items re-generated with the toxic words
banned in the beam (MinTox). An expressive model's T2U takes the source's
gcmvn-normalised fbank as ``prosody_encoder_input`` (its waveform comes
from ``inference/pretssel_generator.py``). It runs on the CUDA card unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from seamless_communication_torch.audio.fbank import (
    FbankConfig, fbank_numpy, normalize_per_mel_bin,
)
from seamless_communication_torch.audio.wav import read_wav, resample
from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.inference.generator import (
    SequenceGeneratorOptions, UnitYGenerator, _bucket,
)
from seamless_communication_torch.models.unity import model as unity
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.models.vocoder.codehifigan import (
    CodeHifiGanConfig, code_hifigan_forward,
)
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.utils.profiling import TRACER


class Task(enum.Enum):
    S2ST = enum.auto()
    S2TT = enum.auto()
    T2ST = enum.auto()
    T2TT = enum.auto()
    ASR = enum.auto()


class Modality(enum.Enum):
    SPEECH = "speech"
    TEXT = "text"


def get_modalities_from_task_str(task_str: str) -> tuple[Modality, Modality]:
    """(input modality, output modality) of a task name, in any case."""
    try:
        task = Task[task_str.upper()]
    except KeyError:
        valid = ", ".join(t.name.lower() for t in Task)
        raise ValueError(f"unknown task {task_str!r}; expected one of: {valid}") from None
    speech_in = task in (Task.S2ST, Task.S2TT, Task.ASR)
    speech_out = task in (Task.S2ST, Task.T2ST)
    return (Modality.SPEECH if speech_in else Modality.TEXT,
            Modality.SPEECH if speech_out else Modality.TEXT)


TEXT_TASKS = ("s2tt", "asr", "t2tt")         # text out
SPEECH_TASKS = ("s2st", "t2st")               # speech out
TEXT_INPUT_TASKS = ("t2tt", "t2st")


@dataclass
class BatchedSpeechOutput:
    """Units and waveforms of an ``s2st`` request, one of each per input."""
    units: List[List[int]]
    audio_wavs: List[np.ndarray]
    sample_rate: int = 16000


@dataclass
class FbankInput:
    """Precomputed raw log-mel features: ``fbank`` (B, T, n_mels) zero-padded,
    ``lengths`` (B,); a length of 0 marks a corrupted input. ``predict``
    applies the Translator's fbank normalization itself."""
    fbank: np.ndarray
    lengths: np.ndarray


class Translator:
    def __init__(self, params: dict, cfg: UnitYConfig, text_tokenizer: NllbTokenizer,
                 unit_tokenizer: Optional[UnitTokenizer] = None,
                 char_tokenizer: Optional[CharTokenizer] = None,
                 vocoder_params: Optional[dict] = None,
                 vocoder_cfg: Optional[CodeHifiGanConfig] = None,
                 lang_spkr_idx_map: Optional[dict] = None, *,
                 text_opts: Optional[SequenceGeneratorOptions] = None,
                 unit_opts: Optional[SequenceGeneratorOptions] = None,
                 fbank_cfg: FbankConfig = FbankConfig(),
                 normalize_fbank: str = "utterance",
                 apply_mintox: bool = False, etox_checker=None,
                 device: Optional[Union[str, torch.device]] = None):
        """``normalize_fbank``: "utterance" (one mean and standard deviation
        over the utterance) or "per_mel_bin". ``unit_opts``: the AR T2U's
        beam options (v1 models). ``apply_mintox`` needs an
        ``etox_checker`` (``toxicity.etox.ETOXBadWordChecker``)."""
        if apply_mintox and etox_checker is None:
            raise ValueError("apply_mintox=True requires an etox_checker "
                             "(toxicity.etox.ETOXBadWordChecker)")
        self.normalize_fbank = normalize_fbank
        self.apply_mintox = apply_mintox
        self.etox_checker = etox_checker
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
                                        char_tokenizer, text_opts, unit_opts,
                                        device=self.device)
        # wall seconds of each stage of the last predict(): encoder (speech
        # or text, the host front end included), text_decode and, for s2st
        # and t2st, redecode, t2u (the char frontend included) and vocoder;
        # of a MinTox check, its ASR and re-run passes
        self.last_timings: Dict[str, float] = {}
        self.last_mintox_timings: Dict[str, float] = {}

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
        feats = [self._normalize(fbank_numpy(w, self.fbank_cfg)) for w in wavs]
        return self._pad_feats(feats, np.array([f.shape[0] for f in feats], np.int32))

    def _normalize(self, f: np.ndarray) -> np.ndarray:
        """The Translator's fbank normalization of one utterance's (T, n_mels)
        log-mels; an empty input passes unnormalized."""
        if not f.size:
            return f.astype(np.float32)
        if self.normalize_fbank == "utterance":
            return ((f - f.mean()) / (f.std() + 1e-7)).astype(np.float32)
        if self.normalize_fbank == "per_mel_bin":
            return normalize_per_mel_bin(f)
        return f.astype(np.float32)

    def _normalize_fbank_batch(self, fb: FbankInput) -> tuple[np.ndarray, np.ndarray]:
        """The normalization of precomputed raw log-mels, over each item's
        valid frames; a 0-length item becomes one frame of zeros."""
        lens = np.asarray(fb.lengths, np.int32)
        feats = [self._normalize(np.asarray(fb.fbank[i, :n], np.float32))
                 for i, n in enumerate(lens)]
        return self._pad_feats(feats, np.maximum(lens, 1))

    def _pad_feats(self, feats, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
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
                unit_generation_opts: Optional[SequenceGeneratorOptions] = None,
                banned_sequences: Optional[tuple] = None,
                ngram_filtering: bool = False, max_unit_len: int = 2048,
                prosody_encoder_input: Optional[np.ndarray] = None,
                prosody_input_lens: Optional[np.ndarray] = None,
                src_text: Optional[str] = None,
                _apply_mintox: Optional[bool] = None
                ) -> tuple[List[str], Optional[BatchedSpeechOutput]]:
        """Returns (texts, None) for a text-output task and (texts,
        BatchedSpeechOutput) for ``s2st``/``t2st``: one text, unit list and
        waveform per input. Speech input is a waveform (a path, an array at
        ``sample_rate``, or a list of them) or an :class:`FbankInput`; text
        input is a string or a list of strings in ``src_lang``, which it
        requires.

        ``unit_generation_opts``: the AR T2U's beam options for this call
        (v1 models). ``prosody_encoder_input``: the gcmvn-normalised source
        fbank, (T, 80) or (B, T, 80), which an expressive model's T2U
        requires; ``prosody_input_lens`` (B,) its valid frames (all of them
        where not given). ``banned_sequences``: ((N, M) int array, (N,) lengths)
        token sequences the text beam must not complete. With MinTox on
        (``apply_mintox``, or ``_apply_mintox`` for this call) the source
        text is ``src_text``, the text input, or the ASR of the speech input
        in ``src_lang``."""
        get_modalities_from_task_str(task_str)      # raises on an unknown task
        task = task_str.lower()
        if task in TEXT_INPUT_TASKS and src_lang is None:
            raise ValueError("src_lang required for text input")
        self.last_timings = {}
        t0 = time.perf_counter()
        # the "encoder" stage is two spans: the host front end up to the
        # copy to the card (speech input), then the encoder
        if task in TEXT_INPUT_TASKS:
            span = TRACER.begin("predict.encoder") if TRACER.on else None
            enc = self._encode_text_input(input, src_lang)
        else:
            span = TRACER.begin("predict.fbank") if TRACER.on else None
            if isinstance(input, FbankInput):
                fbank, flens = self._normalize_fbank_batch(input)
            else:
                fbank, flens = self._audio_to_fbank(input, sample_rate)
            if span is not None:
                TRACER.end(span)
                span = TRACER.begin("predict.encoder")
            enc = unity.encode_speech(self.params, self.cfg,
                                      torch.as_tensor(fbank, device=self.device),
                                      torch.as_tensor(flens, device=self.device))
        t0 = TRACER.stage_end(self.last_timings, "encoder", t0, self.device, span)
        # ASR: the target language is the source language
        text_lang = (src_lang or tgt_lang) if task == "asr" else tgt_lang
        span = TRACER.begin("predict.text_decode") if TRACER.on else None
        tokens, tok_lens, _ = self.generator.generate_text(
            enc, text_lang, banned=banned_sequences, opts_override=text_generation_opts)
        texts = [self.text_tokenizer.decode(tokens[b, :tok_lens[b]])
                 for b in range(tokens.shape[0])]
        t0 = TRACER.stage_end(self.last_timings, "text_decode", t0, self.device, span)
        do_mintox = self.apply_mintox if _apply_mintox is None else _apply_mintox
        if task in TEXT_TASKS:
            if do_mintox:
                texts, _ = self._run_mintox(
                    input, task, tgt_lang, src_lang, src_text, texts, None,
                    sample_rate=sample_rate, banned_base=banned_sequences)
            return texts, None

        pf = pl = None
        if prosody_encoder_input is not None:
            pf = np.asarray(prosody_encoder_input, np.float32)
            if pf.ndim == 2:
                pf = pf[None]
            pl = (np.asarray(prosody_input_lens, np.int32)
                  if prosody_input_lens is not None
                  else np.full((pf.shape[0],), pf.shape[1], np.int32))
        units = self.generator.generate_units(
            tokens, tok_lens, enc, tgt_lang, duration_factor=duration_factor,
            max_unit_len=max_unit_len, ngram_filtering=ngram_filtering,
            prosody_fbank=pf, prosody_lens=pl,
            unit_opts_override=unit_generation_opts)
        self.last_timings.update(self.generator.last_timings)
        if do_mintox:
            texts, units = self._run_mintox(
                input, task, tgt_lang, src_lang, src_text, texts, units,
                sample_rate=sample_rate, banned_base=banned_sequences,
                duration_factor=duration_factor, max_unit_len=max_unit_len,
                ngram_filtering=ngram_filtering,
                prosody_encoder_input=prosody_encoder_input,
                prosody_input_lens=prosody_input_lens)
        t0 = time.perf_counter()
        audio_wavs: List[np.ndarray] = []
        if self.vocoder_params is not None:
            audio_wavs = self.synthesize(units, tgt_lang, spkr=spkr)
        TRACER.stage_end(self.last_timings, "vocoder", t0, self.device)
        return texts, BatchedSpeechOutput(units=units, audio_wavs=audio_wavs)

    def _run_mintox(self, input, task: str, tgt_lang: str, src_lang: Optional[str],
                    src_text: Optional[str], texts: List[str], units, *,
                    sample_rate: int, banned_base, **regen_kwargs):
        """MinTox: find toxicity the outputs add to the source text and
        re-generate the offending items with the toxic words banned in the
        beam (merged with the caller's ``banned_base``). Returns (texts,
        units). The passes run with the Translator's own generation options,
        as in the JAX package. Their wall seconds go to
        ``last_mintox_timings``: ``asr`` and ``rerun``, where they ran;
        ``last_timings`` keeps the first pass's stages."""
        from seamless_communication_torch.toxicity.mintox import mintox_pipeline

        timings, self.last_mintox_timings = self.last_timings, {}
        t0 = time.perf_counter()
        if src_text is not None:
            src_texts = [str(src_text)] * len(texts)
        elif task in TEXT_INPUT_TASKS:
            items = input if isinstance(input, (list, tuple)) else [input]
            src_texts = [str(t) for t in items]
        else:
            if src_lang is None:
                raise ValueError("`src_lang` must be specified when "
                                 "`apply_mintox` is True (or pass src_text)")
            src_texts, _ = self.predict(input, "asr", src_lang, src_lang=src_lang,
                                        sample_rate=sample_rate, _apply_mintox=False)
            t0 = TRACER.stage_end(self.last_mintox_timings, "asr", t0, self.device)

        def rerun(indices, banned):
            # the whole batch again with the bans, then the offending items;
            # banned is ((N, M) right-aligned array, (N,) lengths)
            if banned_base is not None:
                rows = [np.asarray(banned_base[0]), np.asarray(banned[0])]
                M = max(r.shape[1] for r in rows)
                banned = (np.concatenate([np.pad(r, ((0, 0), (M - r.shape[1], 0)),
                                                 constant_values=-1) for r in rows]),
                          np.concatenate([np.asarray(banned_base[1]),
                                          np.asarray(banned[1])]))
            t1 = time.perf_counter()
            texts2, speech2 = self.predict(input, task, tgt_lang, src_lang=src_lang,
                                           sample_rate=sample_rate,
                                           banned_sequences=banned, _apply_mintox=False,
                                           **regen_kwargs)
            TRACER.stage_end(self.last_mintox_timings, "rerun", t1, self.device)
            u2 = speech2.units if speech2 is not None else None
            return ([texts2[i] for i in indices],
                    [u2[i] for i in indices] if u2 is not None else None)

        out = mintox_pipeline(checker=self.etox_checker,
                              text_tokenizer=self.text_tokenizer, src_texts=src_texts,
                              original_texts=texts, original_units=units,
                              src_lang=src_lang or tgt_lang, tgt_lang=tgt_lang,
                              rerun_fn=rerun)
        self.last_timings = timings
        return out

    @torch.inference_mode()
    def synthesize(self, units: List[List[int]], tgt_lang: str, *, spkr: int = -1,
                   dur_prediction: bool = True) -> List[np.ndarray]:
        """Unit lists -> fp32 waveforms, one utterance at a time: units
        bucketed to 32, each repeated by its predicted duration up to 4 frames
        a unit in all (one frame a unit without ``dur_prediction``); language
        and speaker ids from ``lang_spkr_idx_map``."""
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
                                       dur_prediction=dur_prediction, max_unit_len=U * 4)
            n = int(res.sample_lengths[0])
            out.append(res.waveform[0, :n].float().cpu().numpy())
        return out
