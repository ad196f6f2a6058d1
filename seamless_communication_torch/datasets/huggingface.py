"""Finetuning dataset builders (counterpart of
``seamless_communication_tpu/datasets/huggingface.py``): FLEURS
speech-to-speech pairs (with target unit extraction) and GigaSpeech ASR,
written as the JSON-lines manifests that ``datasets/loader.py`` reads.

Both read through the ``datasets`` package (``load_dataset``), which the
port does not require: it is imported when a builder is called. Where there
is no network, ``datasets`` must find the data in its local cache.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np

from seamless_communication_torch.audio.wav import write_wav

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class LangPairSample:
    source_audio: str
    source_lang: str
    source_text: str
    target_audio: Optional[str]
    target_lang: str
    target_text: str
    target_units: Optional[List[int]] = None
    # per-char unit durations over the target text's char tokens (the
    # aligner's output): the NAR-T2U S2S training target
    char_durations: Optional[List[int]] = None

    def to_manifest(self) -> dict:
        entry = {
            "source": {"audio_local_path": self.source_audio,
                       "lang": self.source_lang, "text": self.source_text},
            "target": {"text": self.target_text, "lang": self.target_lang},
        }
        if self.target_units is not None:
            entry["target"]["units"] = self.target_units
        if self.char_durations is not None:
            entry["target"]["char_durations"] = self.char_durations
        return entry


def write_manifest(samples: Iterable[LangPairSample], path: str) -> int:
    n = 0
    with open(path, "w") as f:
        for s in samples:
            f.write(json.dumps(s.to_manifest()) + "\n")
            n += 1
    logger.info("wrote %d samples to %s", n, path)
    return n


def build_fleurs_s2s(source_lang: str, target_lang: str, split: str, out_dir: str, *,
                     unit_extractor=None, aligner=None,
                     max_samples: Optional[int] = None) -> List[LangPairSample]:
    """FLEURS utterances of two languages paired by sample id, written as
    WAVs under ``out_dir``; with ``unit_extractor`` the target speech's
    units, with ``aligner`` its units and per-char durations."""
    import datasets

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    src = datasets.load_dataset("google/fleurs", source_lang, split=split)
    tgt = datasets.load_dataset("google/fleurs", target_lang, split=split)
    tgt_by_id = {ex["id"]: ex for ex in tgt}

    samples: List[LangPairSample] = []
    for ex in src:
        if max_samples and len(samples) >= max_samples:
            break
        pair = tgt_by_id.get(ex["id"])
        if pair is None:
            continue
        spath = out / f"src_{ex['id']}.wav"
        tpath = out / f"tgt_{ex['id']}.wav"
        write_wav(str(spath), np.asarray(ex["audio"]["array"], np.float32),
                  ex["audio"]["sampling_rate"])
        write_wav(str(tpath), np.asarray(pair["audio"]["array"], np.float32),
                  pair["audio"]["sampling_rate"])
        target_wav = np.asarray(pair["audio"]["array"], np.float32)
        units = None
        if unit_extractor is not None:
            units = unit_extractor.predict(target_wav)[0]
        durations = None
        if aligner is not None:
            if units is None:
                units = aligner.extract_units(aligner.prepare_audio(target_wav))
            durs, _ = aligner.extract_alignment([int(u) for u in units],
                                                pair["transcription"])
            durations = [int(d) for d in np.asarray(durs).reshape(-1)]
        samples.append(LangPairSample(
            source_audio=str(spath), source_lang=source_lang,
            source_text=ex["transcription"], target_audio=str(tpath),
            target_lang=target_lang, target_text=pair["transcription"],
            target_units=units, char_durations=durations))
    return samples


def build_gigaspeech_asr(split: str, out_dir: str, *,
                         max_samples: Optional[int] = None) -> List[LangPairSample]:
    """A GigaSpeech ("xs") ASR manifest: English speech to its text, the
    punctuation tags spelled out and the text lower-cased."""
    import datasets

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    ds = datasets.load_dataset("speechcolab/gigaspeech", "xs", split=split)

    samples: List[LangPairSample] = []
    for i, ex in enumerate(ds):
        if max_samples and len(samples) >= max_samples:
            break
        path = out / f"giga_{i}.wav"
        write_wav(str(path), np.asarray(ex["audio"]["array"], np.float32),
                  ex["audio"]["sampling_rate"])
        text = ex["text"].replace(" <COMMA>", ",").replace(" <PERIOD>", ".").lower()
        samples.append(LangPairSample(
            source_audio=str(path), source_lang="eng", source_text=text,
            target_audio=None, target_lang="eng", target_text=text))
    return samples
