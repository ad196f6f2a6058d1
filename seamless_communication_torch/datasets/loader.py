"""Finetune data loading (counterpart of
``seamless_communication_tpu/datasets/loader.py``): JSON-lines manifests of
{"source": {"audio_local_path", "lang"}, "target": {"text", "lang",
"units"?, "char_durations"?}} entries -> padded batches of numpy arrays,
which the trainer's ``batch_to`` moves to the device.

The fbank runs on the host in numpy (``audio/fbank.py fbank_numpy``), as in
the JAX loader, so the device step is compute alone.
"""

from __future__ import annotations

import json
from typing import Iterator, List

import numpy as np

from seamless_communication_torch.audio.fbank import fbank_numpy
from seamless_communication_torch.audio.wav import read_wav, resample
from seamless_communication_torch.text.nllb import NllbTokenizer

UNIT_BOS, UNIT_PAD, UNIT_EOS, UNIT_OFFSET = 0, 1, 2, 4


def _bucket(n: int, step: int) -> int:
    return max(step, -(-n // step) * step)


def read_manifest(path: str) -> List[dict]:
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                items.append(json.loads(line))
    return items


class _Reiterable:
    """Each iteration a fresh generator: the trainer's epochs each read the
    manifest again (a bare generator would be empty after the first)."""

    def __init__(self, make):
        self._make = make

    def __iter__(self):
        return self._make()


def manifest_batches(path: str, text_tokenizer: NllbTokenizer, *,
                     batch_size: int = 8, max_frames: int = 1024,
                     max_tokens: int = 128, load_units: bool = False,
                     max_units: int = 512, char_tokenizer=None):
    """Finetune batches, re-iterable across epochs: fbank (B, T, 80),
    fbank_lens, prev_tokens, target_tokens, target_lens (the teacher-forced
    shift of each target's ids). T is a multiple of 128 frames, the token
    axis of 16.

    ``load_units=True`` (AR-T2U SPEECH_TO_SPEECH) adds prev_units,
    target_units and unit_lens from each entry's ``target.units`` (+4 for
    the control symbols, framed by bos and eos; unit bos=0, pad=1, eos=2,
    unk=3).

    ``load_units=True, char_tokenizer=...`` (NAR-T2U S2S) adds instead
    char_ids and char_counts (the host char frontend over the previous
    tokens), target_durations (the entry's ``target.char_durations``) and
    the duration-expanded ``target_units`` (+4, pad=1, no bos or eos)."""
    return _Reiterable(lambda: _manifest_batches(
        path, text_tokenizer, batch_size=batch_size, max_frames=max_frames,
        max_tokens=max_tokens, load_units=load_units, max_units=max_units,
        char_tokenizer=char_tokenizer))


def _manifest_batches(path: str, text_tokenizer: NllbTokenizer, *,
                      batch_size: int, max_frames: int, max_tokens: int,
                      load_units: bool, max_units: int, char_tokenizer
                      ) -> Iterator[dict]:
    nar = load_units and char_tokenizer is not None
    items = read_manifest(path)
    for i in range(0, len(items), batch_size):
        chunk = items[i:i + batch_size]
        feats, flens, tgt_ids, unit_ids = [], [], [], []
        raw_units, durations = [], []
        for it in chunk:
            src = it["source"]
            if "audio_local_path" not in src:
                raise ValueError("text-source finetuning requires audio manifests")
            wav, sr = read_wav(src["audio_local_path"])
            f = fbank_numpy(resample(wav, sr, 16000))
            f = (f - f.mean()) / (f.std() + 1e-7)
            feats.append(f[:max_frames])
            flens.append(min(f.shape[0], max_frames))
            tgt = it["target"]
            tgt_ids.append(text_tokenizer.encode_target(tgt["text"], tgt["lang"])[:max_tokens])
            if load_units:
                raw = tgt.get("units")
                if raw is None:
                    raise ValueError(
                        "SPEECH_TO_SPEECH finetuning needs target.units in "
                        "the manifest (m4t_prepare_dataset --extract_units)")
                if nar:
                    durs = tgt.get("char_durations")
                    if durs is None:
                        raise ValueError(
                            "NAR S2S finetuning needs target.char_durations "
                            "(m4t_prepare_dataset --aligner_pt)")
                    raw_units.append([int(u) for u in raw[:max_units]])
                    durations.append([int(d) for d in durs])
                else:
                    unit_ids.append([UNIT_BOS] + [int(u) + UNIT_OFFSET for u in raw[:max_units]]
                                    + [UNIT_EOS])

        B = len(chunk)
        T = _bucket(max(flens), 128)
        L = _bucket(max(len(t) for t in tgt_ids), 16)
        pad = text_tokenizer.vocab_info.pad_idx
        fb = np.zeros((B, T, 80), np.float32)
        pv = np.full((B, L), pad, np.int32)
        tg = np.full((B, L), pad, np.int32)
        tl = np.zeros((B,), np.int32)
        for b in range(B):
            fb[b, :flens[b]] = feats[b][:flens[b]]
            ids = tgt_ids[b]
            # teacher forcing: prev = ids[:-1], target = ids[1:]
            pv[b, :len(ids) - 1] = ids[:-1]
            tg[b, :len(ids) - 1] = ids[1:]
            tl[b] = len(ids) - 1
        batch = {"fbank": fb, "fbank_lens": np.asarray(flens, np.int32),
                 "prev_tokens": pv, "target_tokens": tg, "target_lens": tl}
        if load_units and not nar:
            U = _bucket(max(len(u) for u in unit_ids) - 1, 32)
            pu = np.full((B, U), UNIT_PAD, np.int32)
            tu = np.full((B, U), UNIT_PAD, np.int32)
            ul = np.zeros((B,), np.int32)
            for b, ids in enumerate(unit_ids):
                n = len(ids) - 1
                pu[b, :n] = ids[:-1]
                tu[b, :n] = ids[1:]
                ul[b] = n
            batch.update(prev_units=pu, target_units=tu, unit_lens=ul)
        elif nar:
            from seamless_communication_torch.text.char_frontend import text_to_char_seqs

            # the char frontend over the previous positions ([eos, lang,
            # toks...]): char_counts lines up with prev_tokens, the positions
            # whose decoder features the NAR T2U upsamples
            C = _bucket(max(len(d) for d in durations), 64)
            char_ids, char_lens, char_counts = text_to_char_seqs(
                text_tokenizer, char_tokenizer, pv, max_char_len=C)
            td = np.zeros((B, C), np.int32)
            for b, durs in enumerate(durations):
                if len(durs) != int(char_lens[b]):
                    raise ValueError(
                        f"char_durations length {len(durs)} != the char "
                        f"frontend's {int(char_lens[b])} chars for row {b} — "
                        "manifest prepared with a different char tokenizer, "
                        "or max_tokens truncated the text")
                td[b, :len(durs)] = durs
            # the unit grid is capped at max_units (the trainer upsamples to
            # target_units.shape[1] frames); frames past it stay UNIT_PAD
            U = _bucket(min(max(sum(d) for d in durations), max_units), 32)
            tu = np.full((B, U), UNIT_PAD, np.int32)
            for b, units in enumerate(raw_units):
                n = min(len(units), sum(durations[b]), U)
                tu[b, :n] = np.asarray(units[:n], np.int32) + UNIT_OFFSET
            batch.update(char_ids=np.asarray(char_ids, np.int32),
                         char_counts=np.asarray(char_counts, np.int32),
                         target_durations=td, target_units=tu)
        yield batch
