"""asr_etox: transcribe a TSV manifest of audio files and score each
transcript's toxicity by the NLLB word lists (counterpart of
``seamless_communication_tpu/cli/asr_etox.py``; reference
cli/toxicity/etox/asr_etox.py).

    python3 -m seamless_communication_torch.cli.asr_etox DATA.tsv OUT.tsv \\
        --lang eng [--model_name CARD | whisper_<checkpoint>] \\
        [--etox_dataset nllb-200_twl.zip|DIR] [--device cuda|cpu]

The ASR is the port's M4T ``Translator`` (K1 at every decode step on the
card), or a local HF Whisper checkpoint for a model name ``whisper_<path>``.
The flags are the JAX package's, plus ``--device`` (the CUDA card unless it
says ``cpu``) and ``--local_pt_path``.
"""

from __future__ import annotations

import argparse
import csv
import logging
from pathlib import Path
from typing import Optional, Sequence

from seamless_communication_torch.device import resolve_device

logger = logging.getLogger("asr_etox")


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s -- %(name)s: %(message)s")
    parser = argparse.ArgumentParser(description="ASR-ETOX: toxicity level of speech inputs")
    parser.add_argument("data_file", type=Path, help="input TSV manifest of audio files")
    parser.add_argument("output_file", type=Path)
    parser.add_argument("--lang", type=str, required=True,
                        help="language of the speech to transcribe")
    parser.add_argument("--audio_root_dir", type=str, default="")
    parser.add_argument("--audio_column", type=str, default="audio")
    parser.add_argument("--model_name", type=str, default="seamlessM4T_v2_large",
                        help="M4T card name, or 'whisper_<checkpoint>' for a local "
                             "Whisper checkpoint")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--local_hf_path", type=str, default=None)
    parser.add_argument("--local_pt_path", type=str, default=None,
                        help="the M4T model's original .pt checkpoint on disk")
    parser.add_argument("--etox_dataset", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="where to run: the CUDA card by default, or cpu")
    args, _unknown = parser.parse_known_args(argv)
    device = resolve_device(args.device)

    from seamless_communication_torch.audio.wav import read_wav, resample
    from seamless_communication_torch.cli import eval_utils
    from seamless_communication_torch.cli.etox import _load_checker

    if args.model_name.startswith("whisper_"):
        transcribe_batch = eval_utils.make_whisper_transcriber(
            args.model_name.split("_", 1)[1], lang=args.lang, device=device)
    else:
        transcribe_batch = eval_utils.make_m4t_transcriber(
            args.model_name, lang=args.lang, local_hf_path=args.local_hf_path,
            local_pt_path=args.local_pt_path, batch_size=args.batch_size,
            device=device)
    checker = _load_checker(args.etox_dataset, None, lang=args.lang)

    with open(args.data_file) as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    logger.info("running ASR-ETOX over %d rows", len(rows))
    with open(args.output_file, "w", encoding="utf-8") as outf:
        print("text", "toxicity", "bad_words", sep="\t", file=outf)
        for i in range(0, len(rows), args.batch_size):
            wavs = []
            for row in rows[i:i + args.batch_size]:
                wav, sr = read_wav(str(Path(args.audio_root_dir) / row[args.audio_column]))
                wavs.append(resample(wav, sr, 16000))
            for text in transcribe_batch(wavs):
                bad = checker.get_bad_words(text=text, lang=args.lang)
                print(text, len(bad), ",".join(bad), sep="\t", file=outf)
    logger.info("wrote %s", args.output_file)


if __name__ == "__main__":
    main()
