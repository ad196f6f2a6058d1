"""m4t_predict: one S2ST, S2TT, T2ST, T2TT or ASR request from the command line
(counterpart of ``seamless_communication_tpu/cli/predict.py``; reference
cli/m4t/predict/predict.py).

    python3 -m seamless_communication_torch.cli.predict INPUT TASK TGT_LANG \\
        [--src_lang LANG] [--model_name CARD] [--local_pt_path FILE.pt] \\
        [--vocoder_name CARD] \\
        [--output_path out.wav] [--device cuda|cpu] ...

The flags are the JAX package's, plus ``--device`` (the CUDA card unless it
says ``cpu``) and ``--local_pt_path``: the model's original ``.pt`` checkpoint
on disk, the route that needs no ``transformers`` (a card's ``checkpoint:``
naming a local ``.pt`` does the same, for the vocoder's card too). The
translated text is logged; a speech output is written as a 16-bit WAV.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, NamedTuple, Optional, Sequence

logger = logging.getLogger("m4t_predict")


def add_inference_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("input", type=str, help="audio WAV path or text")
    parser.add_argument("task", type=str, help="s2st | s2tt | t2st | t2tt | asr")
    parser.add_argument("tgt_lang", type=str)
    parser.add_argument("--src_lang", type=str, default=None)
    parser.add_argument("--model_name", type=str, default="seamlessM4T_v2_large")
    parser.add_argument("--vocoder_name", type=str, default="vocoder_v2")
    parser.add_argument("--output_path", type=str, default="out.wav")
    parser.add_argument("--local_hf_path", type=str, default=None,
                        help="local HF checkpoint directory (needs transformers)")
    parser.add_argument("--local_pt_path", type=str, default=None,
                        help="the model's original .pt checkpoint on disk")
    parser.add_argument("--device", type=str, default=None,
                        help="where to run: the CUDA card by default, or cpu")
    parser.add_argument("--text_generation_beam_size", type=int, default=5)
    parser.add_argument("--text_generation_max_len_a", type=int, default=1)
    parser.add_argument("--text_generation_max_len_b", type=int, default=200)
    parser.add_argument("--text_unk_blocking", action="store_true")
    parser.add_argument("--text_generation_ngram_blocking", action="store_true",
                        help="block repeated n-grams in text decoding "
                             "(size = --no_repeat_ngram_size)")
    parser.add_argument("--no_repeat_ngram_size", type=int, default=4)
    parser.add_argument("--unit_generation_beam_size", type=int, default=5,
                        help="AR T2U beam (v1 models)")
    parser.add_argument("--unit_generation_max_len_a", type=int, default=25)
    parser.add_argument("--unit_generation_max_len_b", type=int, default=50)
    parser.add_argument("--unit_generation_ngram_blocking", action="store_true")
    parser.add_argument("--unit_generation_ngram_filtering", action="store_true")
    parser.add_argument("--duration_factor", type=float, default=1.0)
    parser.add_argument("--spkr", type=int, default=-1)
    parser.add_argument("--quantize", action="store_true",
                        help="weight-only quantization of the UnitY model")
    parser.add_argument("--quantize_bits", type=int, default=8, choices=(4, 8),
                        help="with --quantize: 8 (per-column scales) or 4 "
                             "(group-128 scales, lossier)")
    parser.add_argument("--apply_mintox", action="store_true",
                        help="MinTox added-toxicity mitigation (requires "
                             "--etox_dataset)")
    parser.add_argument("--etox_dataset", type=str, default=None,
                        help="local nllb-200_twl.zip (or extracted dir)")
    return parser


class PredictResult(NamedTuple):
    texts: List[str]
    speech: object                 # BatchedSpeechOutput or None
    translator: object             # the Translator that served the request
    load_timings: dict             # the UnitY load's stages, seconds


def main(argv: Optional[Sequence[str]] = None) -> PredictResult:
    """Parse ``argv`` (``sys.argv[1:]`` when None), load the model (and the
    vocoder for a speech output), serve the request, log the text and write
    the WAV. Returns the texts, the speech output, the Translator and the
    seconds of the model load's stages."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s -- %(name)s: %(message)s")
    parser = argparse.ArgumentParser(
        description="M4T inference: S2ST, S2TT, T2ST, T2TT, ASR")
    add_inference_arguments(parser)
    args = parser.parse_args(argv)
    if args.apply_mintox and not args.etox_dataset:
        parser.error("--apply_mintox requires --etox_dataset")

    from seamless_communication_torch.audio.wav import write_wav
    from seamless_communication_torch.cli import loading
    from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
    from seamless_communication_torch.inference.translator import (
        Modality, Translator, get_modalities_from_task_str,
    )

    _, out_mod = get_modalities_from_task_str(args.task)
    timings: dict = {}
    params, cfg, text_tok, unit_tok, char_tok = loading.load_unity_model_and_tokenizers(
        args.model_name, local_hf_path=args.local_hf_path,
        local_pt_path=args.local_pt_path, quantize=args.quantize,
        quantize_bits=args.quantize_bits, device=args.device, timings=timings)
    logger.info("Loaded %s: %s", args.model_name, ", ".join(
        f"{k} {v:.2f} s" for k, v in timings.items()))
    voc_params = voc_cfg = None
    idx_map = {}
    if out_mod is Modality.SPEECH:
        voc_params, voc_cfg, idx_map = loading.load_vocoder(
            args.vocoder_name, local_hf_path=args.local_hf_path,
            device=args.device)

    opts = SequenceGeneratorOptions(
        beam_size=args.text_generation_beam_size,
        soft_max_seq_len=(args.text_generation_max_len_a, args.text_generation_max_len_b),
        unk_penalty=(1e9 if args.text_unk_blocking else 0.0),
        no_repeat_ngram_size=(args.no_repeat_ngram_size
                              if args.text_generation_ngram_blocking else None))
    unit_opts = SequenceGeneratorOptions(
        beam_size=args.unit_generation_beam_size,
        soft_max_seq_len=(args.unit_generation_max_len_a, args.unit_generation_max_len_b),
        no_repeat_ngram_size=(args.no_repeat_ngram_size
                              if args.unit_generation_ngram_blocking else None))
    checker = None
    if args.apply_mintox:
        from seamless_communication_torch.toxicity.etox import load_etox_checker
        checker = load_etox_checker(args.etox_dataset)
    translator = Translator(params, cfg, text_tok, unit_tok, char_tok,
                            vocoder_params=voc_params, vocoder_cfg=voc_cfg,
                            lang_spkr_idx_map=idx_map, text_opts=opts,
                            unit_opts=unit_opts, apply_mintox=args.apply_mintox,
                            etox_checker=checker, device=args.device)
    texts, speech = translator.predict(
        args.input, args.task, args.tgt_lang, src_lang=args.src_lang,
        duration_factor=args.duration_factor, spkr=args.spkr,
        ngram_filtering=args.unit_generation_ngram_filtering)

    logger.info("Translated text: %s", texts[0])
    if speech is not None and speech.audio_wavs:
        write_wav(args.output_path, speech.audio_wavs[0], speech.sample_rate)
        logger.info("Saved waveform to %s", args.output_path)
    return PredictResult(texts, speech, translator, timings)


if __name__ == "__main__":
    main()
