"""expressivity_evaluate: SeamlessExpressive S2ST over a TSV manifest,
writing the waveforms and hypotheses that ASR-BLEU and the vocal-style
scores read (counterpart of
``seamless_communication_tpu/cli/expressivity_evaluate.py``; reference
cli/expressivity/evaluate/evaluate.py).

    python3 -m seamless_communication_torch.cli.expressivity_evaluate DATA.tsv \\
        --tgt_lang fra [--model_name CARD] [--vocoder_name CARD] \\
        [--local_pt_path FILE.pt] [--output_path DIR] [--device cuda|cpu]

Each row's audio gets the two fbank normalizations: per utterance for the
translation, the vocoder card's gcmvn statistics for the prosody encoder and
PRETSSEL (``inference/pretssel_generator.py``). ``wavs/<i>.wav`` and
``hypotheses.txt`` land in ``--output_path``. The flags are the JAX
package's, plus ``--device`` (the CUDA card unless it says ``cpu``) and
``--local_pt_path``.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from seamless_communication_torch.device import resolve_device

logger = logging.getLogger("expressivity_evaluate")


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Parse ``argv``, translate every row, write the outputs; returns the
    hypotheses."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s -- %(name)s: %(message)s")
    parser = argparse.ArgumentParser(description="SeamlessExpressive evaluation")
    parser.add_argument("data_file", type=str, help="TSV with 'audio', 'tgt_text'")
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--audio_root_dir", type=str, default="")
    parser.add_argument("--model_name", type=str, default="seamless_expressivity")
    parser.add_argument("--vocoder_name", type=str, default="vocoder_pretssel")
    parser.add_argument("--duration_factor", type=float, default=1.0)
    parser.add_argument("--output_path", type=str, default="expressive_eval")
    parser.add_argument("--local_hf_path", type=str, default=None)
    parser.add_argument("--local_pt_path", type=str, default=None,
                        help="the expressive UnitY's .pt checkpoint on disk")
    parser.add_argument("--gated_model_dir", type=str, default=None,
                        help="directory of the gated checkpoints (m2m_expressive_unity.pt, "
                             "pretssel_melhifigan_wm*.pt); sets SEAMLESS_GATED_ASSETS")
    parser.add_argument("--device", type=str, default=None,
                        help="where to run: the CUDA card by default, or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.gated_model_dir:
        os.environ["SEAMLESS_GATED_ASSETS"] = args.gated_model_dir

    from seamless_communication_torch.audio.fbank import fbank_numpy
    from seamless_communication_torch.audio.wav import read_wav, resample, write_wav
    from seamless_communication_torch.cli import loading
    from seamless_communication_torch.inference.pretssel_generator import PretsselGenerator
    from seamless_communication_torch.inference.translator import Translator

    params, cfg, text_tok, unit_tok, char_tok = loading.load_unity_model_and_tokenizers(
        args.model_name, local_hf_path=args.local_hf_path,
        local_pt_path=args.local_pt_path, device=device)
    translator = Translator(params, cfg, text_tok, unit_tok, char_tok, device=device)
    voc_params, voc_cfg, mc, sample_rate = loading.load_pretssel_vocoder(
        args.vocoder_name, device=device)
    stats = mc.get("gcmvn_stats", {})
    gcmvn_mean = np.asarray(stats.get("mean", np.zeros(80)))
    gcmvn_std = np.asarray(stats.get("std", np.ones(80)))
    generator = PretsselGenerator(
        voc_params, voc_cfg, sample_rate=sample_rate,
        lang_to_index={lang: i for i, lang in enumerate(mc.get("langs", []))},
        device=device)

    out = Path(args.output_path)
    (out / "wavs").mkdir(parents=True, exist_ok=True)
    hyps: List[str] = []
    with open(args.data_file) as f:
        for i, row in enumerate(csv.DictReader(f, delimiter="\t")):
            wav, sr = read_wav(str(Path(args.audio_root_dir) / row["audio"]))
            wav = resample(wav, sr, 16000)
            gcmvn = ((fbank_numpy(wav) - gcmvn_mean[None]) / gcmvn_std[None]
                     ).astype(np.float32)
            texts, speech = translator.predict(
                wav, "s2st", args.tgt_lang, duration_factor=args.duration_factor,
                prosody_encoder_input=gcmvn)
            wavs = generator.predict(speech.units, args.tgt_lang, gcmvn[None],
                                     np.array([gcmvn.shape[0]]),
                                     duration_factor=args.duration_factor)
            write_wav(str(out / "wavs" / f"{i}.wav"), wavs[0], sample_rate)
            hyps.append(str(texts[0]))
    with open(out / "hypotheses.txt", "w") as f:
        f.write("\n".join(hyps))
    logger.info("wrote %d hypotheses and waveforms to %s", len(hyps), out)
    return hyps


if __name__ == "__main__":
    main()
