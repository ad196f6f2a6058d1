"""Prepare the mExpresso English -> X expressive evaluation manifests
(counterpart of ``seamless_communication_tpu/cli/prepare_mexpresso.py``;
reference cli/expressivity/data/prepare_mexpresso.py): the released mExpresso
target-text TSVs joined with the English Expresso read speech, downsampled
from 48 kHz to mono 16 kHz, one TSV a (subset, language) with the
reference's columns. csv in place of pandas, the port's WAV reader and
polyphase resampler in place of torchaudio, threads in place of a process
pool.

    python3 -m seamless_communication_torch.cli.prepare_mexpresso OUT_DIR \\
        [--existing-expresso-root DIR] [--cache-dir DIR]

The dataset archives are the ``mexpresso_text`` and ``expresso`` cards'
and must already be on disk (``assets.resolve_asset``: a path, or the URL's
file name in the cache directory); nothing is downloaded.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import re
import tarfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger("prepare_mexpresso")

# the released styles (reference prepare_mexpresso.py)
WHITELIST_STYLE = [
    "default", "default_emphasis", "default_essentials", "confused", "happy",
    "sad", "enunciated", "whisper", "laughing",
]
MEXPRESSO_LANGS = ["spa", "fra", "ita", "cmn", "deu"]


def _fetch_dataset(card_name: str, cache_dir: Path) -> Path:
    """The extracted directory of the dataset archive an asset card names
    (extracted into ``cache_dir`` once)."""
    from seamless_communication_torch.assets import load_card, resolve_asset

    tar_path = resolve_asset(load_card(card_name)["uri"], cache_dir=str(cache_dir))
    out = cache_dir / Path(tar_path).stem
    if not out.exists():
        logger.info("extracting %s -> %s", tar_path, out)
        with tarfile.open(tar_path) as tf:
            tf.extractall(out, filter="data")
    return out


def build_en_manifest_from_oss(oss_root: Path, output_folder: Path) -> List[Dict[str, str]]:
    """English Expresso read speech -> 16 kHz mono WAVs and manifest rows."""
    from seamless_communication_torch.audio.wav import read_wav, resample, write_wav

    rows: List[Dict[str, str]] = []
    with open(oss_root / "read_transcriptions.txt") as fin:
        for line in fin:
            uid, text = line.strip().split("\t")
            sps = uid.split("_")
            speaker, style = sps[0], "_".join(sps[1:-1])
            if style not in WHITELIST_STYLE:
                continue
            text = re.sub(r" <.*?>", "", text)
            text = re.sub(r"<.*?> ", "", text)
            orig = (oss_root / "audio_48khz" / "read" / speaker / style.split("_")[0]
                    / "base" / f"{uid}.wav")
            rows.append({"id": uid, "speaker": speaker, "text": text,
                         "orig_audio": str(orig), "label": style})

    missing = [r["orig_audio"] for r in rows if not os.path.isfile(r["orig_audio"])]
    if missing:
        raise FileNotFoundError(f"missing audio: {missing[0]}")

    target_root = output_folder / "audio_16khz_wav"
    target_root.mkdir(parents=True, exist_ok=True)

    def convert(row: Dict[str, str]) -> None:
        out = target_root / row["speaker"] / (row["id"] + ".wav")
        out.parent.mkdir(parents=True, exist_ok=True)
        wav, sr = read_wav(row["orig_audio"])
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        write_wav(str(out), resample(wav, sr, 16000), 16000)
        row["audio"] = str(out)

    logger.info("converting %d files from 48 kHz to mono 16 kHz", len(rows))
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as ex:
        list(ex.map(convert, rows))

    manifest = output_folder / "en_manifest.tsv"
    with open(manifest, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()), delimiter="\t",
                           quoting=csv.QUOTE_NONE)
        w.writeheader()
        w.writerows(rows)
    logger.info("output %d rows to %s", len(rows), manifest)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="Prepare mExpresso Eng-XXX S2T manifests")
    parser.add_argument("output_folder", type=lambda p: Path(p).resolve())
    parser.add_argument("--existing-expresso-root", type=str, default=None,
                        help="root holding read_transcriptions.txt and audio_48khz where "
                             "Expresso is already extracted")
    parser.add_argument("--cache-dir", type=str, default=None)
    args = parser.parse_args(argv)

    cache = Path(args.cache_dir or os.environ.get(
        "SEAMLESS_CACHE", os.path.expanduser("~/.cache/seamless_tpu")))
    cache.mkdir(parents=True, exist_ok=True)
    mexpresso_path = _fetch_dataset("mexpresso_text", cache) / "mexpresso_text"
    en_root = (Path(args.existing_expresso_root) if args.existing_expresso_root
               else _fetch_dataset("expresso", cache) / "expresso")
    en_rows = build_en_manifest_from_oss(en_root, args.output_folder / "En_Expresso")
    en_by_id = {r["id"]: r for r in en_rows}

    out_cols = ["id", "src_audio", "src_speaker", "src_text", "src_lang",
                "tgt_text", "tgt_lang", "label"]
    for subset in ["dev", "test"]:
        for lang in MEXPRESSO_LANGS:
            src_tsv = mexpresso_path / f"{subset}_mexpresso_{lang}.tsv"
            with open(src_tsv) as f:
                released = list(csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE))
            joined, missing = [], []
            for row in released:
                en = en_by_id.get(row["id"])
                if en is None:
                    missing.append(row["id"])
                    continue
                joined.append({
                    "id": row["id"], "src_audio": en["audio"],
                    "src_speaker": en["speaker"], "src_text": en["text"],
                    "src_lang": "eng", "tgt_text": row["text"],
                    "tgt_lang": lang, "label": en["label"]})
            if missing:
                raise RuntimeError(
                    f"{subset}_mexpresso_{lang}: {len(missing)} released ids missing "
                    "from the built En Expresso manifest (a partial Expresso extract, "
                    f"or a style outside WHITELIST_STYLE): {missing[:10]}"
                    f"{'...' if len(missing) > 10 else ''}")
            out_path = args.output_folder / f"{subset}_mexpresso_eng_{lang}.tsv"
            with open(out_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=out_cols, delimiter="\t",
                                   quoting=csv.QUOTE_NONE)
                w.writeheader()
                w.writerows(joined)
            logger.info("output %d rows to %s", len(joined), out_path)


if __name__ == "__main__":
    main()
