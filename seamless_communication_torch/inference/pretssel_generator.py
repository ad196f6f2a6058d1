"""The PRETSSEL generator (counterpart of
``seamless_communication_tpu/inference/pretssel_generator.py``): unit lists
-> expressive waveforms. Each list is deduplicated (``unique_consecutive``),
offset by the 4 control symbols, its durations doubled, a trailing EOS unit
of duration 0 appended; the source's gcmvn-normalised fbank is the prosody
input. One utterance at a time, the units padded to a multiple of 8 (at
least 8) and the mel frames to a multiple of 64 (at least 64), the JAX
package's shape buckets."""

from __future__ import annotations

import time
from typing import List, Optional, Union

import numpy as np
import torch

from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.models.pretssel.vocoder import (
    PretsselConfig, pretssel_cond, pretssel_premel, pretssel_wave_synth,
)
from seamless_communication_torch.utils.profiling import TRACER

EOS_UNIT = 2        # the unit vocabulary's EOS; pad = 1


def unique_consecutive(units: List[int]) -> tuple[List[int], List[int]]:
    """(units with consecutive repeats merged, each one's run length)."""
    out, durs = [], []
    for u in units:
        if out and out[-1] == u:
            durs[-1] += 1
        else:
            out.append(u)
            durs.append(1)
    return out, durs


def unit_batch(units: List[int], *, eos: bool = True
               ) -> tuple[np.ndarray, np.ndarray, int, int]:
    """One utterance's raw units -> ((1, U) tokens padded with 1, (1, U)
    durations padded with 0, the number of tokens, the mel frames to
    compute): +4 offset, durations x2, with ``eos`` an EOS of duration 0
    (the streaming agent's chunks have none); U a multiple of 8 (at least
    8), the mel frames a multiple of 64 (at least 64)."""
    uniq, durs = unique_consecutive(units)
    toks = [u + 4 for u in uniq] + [EOS_UNIT] * eos
    durs = [d * 2 for d in durs] + [0] * eos
    U = max(8, -(-len(toks) // 8) * 8)
    u_arr = np.ones((1, U), np.int64)
    d_arr = np.zeros((1, U), np.int64)
    u_arr[0, :len(toks)] = toks
    d_arr[0, :len(durs)] = durs
    return u_arr, d_arr, len(toks), max(64, -(-sum(durs) // 64) * 64)


class PretsselGenerator:
    def __init__(self, params: dict, cfg: PretsselConfig, *, lang_to_index: dict,
                 sample_rate: int = 16000,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.lang_to_index = lang_to_index
        self.sample_rate = sample_rate
        # wall seconds of the last predict's two halves, summed over its
        # utterances: premel (the prosody encoder and the mel) and wave_synth
        self.last_timings: dict = {}
        self.last_mel_frames: List[int] = []   # each utterance's mel frames

    @torch.inference_mode()
    def predict(self, units_batch: List[List[int]], tgt_lang: str,
                prosody_fbank: np.ndarray, prosody_lens: np.ndarray, *,
                duration_factor: float = 1.0) -> List[np.ndarray]:
        """Raw unit lists -> fp32 waveforms, one an utterance (an empty list
        gives an empty waveform). ``prosody_fbank`` (B, T, 80) and
        ``prosody_lens`` (B,): the sources' gcmvn-normalised fbanks. An
        unknown ``tgt_lang`` takes language 0. ``duration_factor`` is taken
        and does nothing, as in the JAX package: the durations are given.
        Each utterance is ``pretssel_forward``'s composition, its two halves
        timed apart."""
        del duration_factor
        dev = self.device
        lang = torch.tensor([self.lang_to_index.get(tgt_lang, 0)], device=dev)
        self.last_timings = {"premel": 0.0, "wave_synth": 0.0}
        self.last_mel_frames = []
        wavs = []
        for b, units in enumerate(units_batch):
            if not units:
                wavs.append(np.zeros(0, np.float32))
                self.last_mel_frames.append(0)
                continue
            u_arr, d_arr, n, M = unit_batch(units)
            t0 = time.perf_counter()
            cond = pretssel_cond(
                self.params, self.cfg,
                torch.as_tensor(np.asarray(prosody_fbank[b:b + 1], np.float32), device=dev),
                torch.as_tensor(np.asarray(prosody_lens[b:b + 1], np.int64), device=dev),
                lang)
            mel, mel_total, mmask = pretssel_premel(
                self.params, self.cfg, torch.as_tensor(u_arr, device=dev),
                torch.tensor([n], device=dev), torch.as_tensor(d_arr, device=dev), cond,
                max_mel_len=M)
            frames = int(mel_total[0])
            t0 = self._add(t0, "premel")
            _, wav = pretssel_wave_synth(self.params, self.cfg, mel, mmask)
            n_samples = frames * self.cfg.hifigan.total_upsample
            wavs.append(wav[0, :n_samples].float().cpu().numpy())
            self._add(t0, "wave_synth")
            self.last_mel_frames.append(frames)
        return wavs

    def _add(self, t0: float, name: str) -> float:
        part: dict = {}
        now = TRACER.stage_end(part, name, t0, self.device)
        self.last_timings[name] += part[name]
        return now
