"""expressivity_predict: one SeamlessExpressive S2ST request from the command
line (counterpart of ``seamless_communication_tpu/cli/expressivity_predict.py``;
reference cli/expressivity/predict/predict.py).

    python3 -m seamless_communication_torch.cli.expressivity_predict INPUT.wav \\
        --tgt_lang LANG [--model_name CARD] [--vocoder_name CARD] \\
        [--local_pt_path FILE.pt] [--output_path out.wav] [--device cuda|cpu] ...

The expressive UnitY translates the audio (the Translator normalises its
fbank per utterance); the source fbank normalised by the vocoder card's
gcmvn statistics is the prosody input of the T2U and of PRETSSEL, which
synthesizes the units at the card's sample rate. The flags are the JAX
package's, plus ``--device`` (the CUDA card unless it says ``cpu``),
``--local_pt_path`` (the UnitY's ``.pt`` on disk; a card's ``checkpoint:``
naming a local ``.pt`` does the same, for the vocoder's card too),
``--quantize`` (int8) and the text decode's length limits of
``cli/predict.py``. ``duration_factor`` scales the T2U's predicted
durations; PRETSSEL takes it and does nothing with it.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

logger = logging.getLogger("expressivity_predict")


class ExpressivityResult(NamedTuple):
    texts: List[str]
    units: List[List[int]]
    waveform: np.ndarray           # the first utterance's, as written
    sample_rate: int
    translator: object             # the Translator that served the request
    generator: object              # the PretsselGenerator
    load_timings: dict             # the UnitY load's stages, seconds


def main(argv: Optional[Sequence[str]] = None) -> ExpressivityResult:
    """Parse ``argv`` (``sys.argv[1:]`` when None), load the expressive UnitY
    and PRETSSEL, translate, write the WAV. Returns the texts, units,
    waveform, the Translator and generator, and the load's stages."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s -- %(name)s: %(message)s")
    parser = argparse.ArgumentParser(description="SeamlessExpressive inference")
    parser.add_argument("input", type=str, help="audio WAV path")
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--model_name", type=str, default="seamless_expressivity")
    parser.add_argument("--vocoder_name", type=str, default="vocoder_pretssel")
    parser.add_argument("--output_path", type=str, default="out.wav")
    parser.add_argument("--duration_factor", type=float, default=1.0)
    parser.add_argument("--local_hf_path", type=str, default=None,
                        help="local HF checkpoint directory (needs transformers)")
    parser.add_argument("--local_pt_path", type=str, default=None,
                        help="the expressive UnitY's .pt checkpoint on disk")
    parser.add_argument("--gated_model_dir", type=str, default=None,
                        help="dir with gated checkpoints (m2m_expressive_unity.pt, "
                             "pretssel_melhifigan_wm*.pt); sets SEAMLESS_GATED_ASSETS")
    parser.add_argument("--device", type=str, default=None,
                        help="where to run: the CUDA card by default, or cpu")
    parser.add_argument("--text_generation_max_len_a", type=int, default=1)
    parser.add_argument("--text_generation_max_len_b", type=int, default=200)
    parser.add_argument("--quantize", action="store_true",
                        help="int8 weight-only quantization of the UnitY model")
    args = parser.parse_args(argv)
    if args.gated_model_dir:
        os.environ["SEAMLESS_GATED_ASSETS"] = args.gated_model_dir

    from seamless_communication_torch.audio.fbank import fbank_numpy
    from seamless_communication_torch.audio.wav import read_wav, resample, write_wav
    from seamless_communication_torch.cli import loading
    from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
    from seamless_communication_torch.inference.pretssel_generator import (
        PretsselGenerator,
    )
    from seamless_communication_torch.inference.translator import Translator

    timings: dict = {}
    params, cfg, text_tok, unit_tok, char_tok = loading.load_unity_model_and_tokenizers(
        args.model_name, local_hf_path=args.local_hf_path,
        local_pt_path=args.local_pt_path, quantize=args.quantize, device=args.device,
        timings=timings)
    logger.info("Loaded %s: %s", args.model_name, ", ".join(
        f"{k} {v:.2f} s" for k, v in timings.items()))
    opts = SequenceGeneratorOptions(
        soft_max_seq_len=(args.text_generation_max_len_a, args.text_generation_max_len_b))
    translator = Translator(params, cfg, text_tok, unit_tok, char_tok, text_opts=opts,
                            device=args.device)
    voc_params, voc_cfg, mc, sample_rate = loading.load_pretssel_vocoder(
        args.vocoder_name, device=args.device)
    stats = mc.get("gcmvn_stats", {})
    gcmvn_mean = np.asarray(stats.get("mean", np.zeros(80)))
    gcmvn_std = np.asarray(stats.get("std", np.ones(80)))
    generator = PretsselGenerator(voc_params, voc_cfg, sample_rate=sample_rate,
                                  lang_to_index={lang: i for i, lang in
                                                 enumerate(mc.get("langs", []))},
                                  device=args.device)

    wav, sr = read_wav(args.input)
    wav = resample(wav, sr, 16000)
    # the prosody input: the fbank normalised by the card's gcmvn statistics
    # (the Translator normalises its own copy per utterance)
    fbank = fbank_numpy(wav)
    gcmvn = ((fbank - gcmvn_mean[None]) / gcmvn_std[None]).astype(np.float32)
    texts, speech = translator.predict(wav, "s2st", args.tgt_lang,
                                       duration_factor=args.duration_factor,
                                       prosody_encoder_input=gcmvn)
    logger.info("Translated text: %s", texts[0])
    wavs = generator.predict(speech.units, args.tgt_lang, gcmvn[None],
                             np.array([gcmvn.shape[0]]),
                             duration_factor=args.duration_factor)
    write_wav(args.output_path, wavs[0], sample_rate)
    logger.info("Saved expressive waveform to %s", args.output_path)
    return ExpressivityResult(texts, speech.units, wavs[0], sample_rate, translator,
                              generator, timings)


if __name__ == "__main__":
    main()
