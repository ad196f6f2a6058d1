"""run_asr_bleu: ASR-BLEU of a generation directory (``hypotheses.txt`` and
``wavs/<i>.wav``, as ``expressivity_evaluate`` writes it) against a TSV's
``tgt_text`` (counterpart of ``seamless_communication_tpu/cli/run_asr_bleu.py``;
reference cli/expressivity/evaluate/run_asr_bleu.py).

    python3 -m seamless_communication_torch.cli.run_asr_bleu GEN_DIR DATA.tsv \\
        --tgt_lang eng [--whisper_model CHECKPOINT] [--asr_model_name CARD] \\
        [--output scores.json] [--device cuda|cpu]

The ASR is a local HF Whisper checkpoint where ``--whisper_model`` names one,
else the port's M4T ASR (``make_m4t_transcriber``). The flags are the JAX
package's, plus ``--device`` and ``--local_pt_path``.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path
from typing import Optional, Sequence

from seamless_communication_torch.device import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, score, print the result as JSON (and write it to
    ``--output``); returns it."""
    parser = argparse.ArgumentParser(description="ASR-BLEU over generated wavs")
    parser.add_argument("generation_dir", type=str,
                        help="expressivity_evaluate's output directory (wavs/ and "
                             "hypotheses.txt)")
    parser.add_argument("data_file", type=str,
                        help="the evaluation TSV with the tgt_text references")
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--whisper_model", type=str, default=None,
                        help="local HF Whisper checkpoint; by default the port's M4T ASR")
    parser.add_argument("--asr_model_name", type=str, default="seamlessM4T_v2_large")
    parser.add_argument("--local_hf_path", type=str, default=None)
    parser.add_argument("--local_pt_path", type=str, default=None,
                        help="the M4T ASR model's original .pt checkpoint on disk")
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="where to run: the CUDA card by default, or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from seamless_communication_torch.audio.wav import read_wav, resample
    from seamless_communication_torch.cli import eval_utils

    gen = Path(args.generation_dir)
    with open(args.data_file) as f:
        refs = [row["tgt_text"] for row in csv.DictReader(f, delimiter="\t")]
    wavs = []
    for i in range(len(refs)):
        wav, sr = read_wav(str(gen / "wavs" / f"{i}.wav"))
        wavs.append(resample(wav, sr, 16000))

    if args.whisper_model:
        transcribe = eval_utils.make_whisper_transcriber(
            args.whisper_model, lang=args.tgt_lang, device=device)
    else:
        transcribe = eval_utils.make_m4t_transcriber(
            args.asr_model_name, lang=args.tgt_lang, local_hf_path=args.local_hf_path,
            local_pt_path=args.local_pt_path, device=device)
    score = eval_utils.compute_asr_bleu(wavs, refs, transcribe=transcribe,
                                        lang=args.tgt_lang)
    result = {"asr_bleu": score, "num_utterances": len(refs)}
    print(json.dumps(result))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
