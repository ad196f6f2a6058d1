"""streaming_evaluate: the SeamlessStreaming pipelines over a TSV of audio and
references, scored for latency (AL and LAAL for text, StartOffset and
EndOffset for speech) and quality (counterpart of
``seamless_communication_tpu/cli/streaming_evaluate.py``; reference
cli/streaming/evaluate.py).

    python3 -m seamless_communication_torch.cli.streaming_evaluate \\
        --data-file DATA.tsv --task s2tt|s2st|asr --tgt-lang eng \\
        [--unity-name CARD] [--monotonic-name CARD] [--vocoder-name CARD] \\
        [--expressive] [--compute-asr-bleu] [--output DIR] [--device cuda|cpu]

The flags are the JAX package's, plus ``--device`` (the CUDA card unless it
says ``cpu``). Each utterance is VAD-trimmed to its speech unless
``--no-strip-silence``; S2ST output gets ASR-BLEU with ``--compute-asr-bleu``
through a separately loaded M4T model (``make_m4t_transcriber``).
``metrics.json`` lands in ``--output``.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os
from pathlib import Path
from typing import Optional, Sequence

from seamless_communication_torch.device import resolve_device

logger = logging.getLogger("streaming_evaluate")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv`` (``sys.argv[1:]`` when None), evaluate, write
    ``metrics.json`` and return the metrics."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s -- %(name)s: %(message)s")
    parser = argparse.ArgumentParser(description="SeamlessStreaming evaluation")
    parser.add_argument("--data-file", type=str, required=True,
                        help="TSV with 'audio' and 'tgt_text' columns")
    parser.add_argument("--audio-root-dir", type=str, default="")
    parser.add_argument("--task", type=str, default="s2st", choices=["s2st", "s2tt", "asr"])
    parser.add_argument("--tgt-lang", type=str, default="eng")
    parser.add_argument("--unity-name", type=str, default="seamless_streaming_unity")
    parser.add_argument("--monotonic-name", type=str,
                        default="seamless_streaming_monotonic_decoder")
    parser.add_argument("--vocoder-name", type=str, default="vocoder_v2")
    parser.add_argument("--source-segment-size", type=int, default=320)
    parser.add_argument("--decision-threshold", type=float, default=0.5)
    parser.add_argument("--min-starting-wait-w2vbert", type=int, default=192)
    parser.add_argument("--min-unit-chunk-size", type=int, default=50)
    parser.add_argument("--output", type=str, default="streaming_eval")
    parser.add_argument("--compute-asr-bleu", action="store_true",
                        help="transcribe the emitted speech with a separately loaded "
                             "M4T ASR model and report ASR-BLEU against tgt_text")
    parser.add_argument("--asr-model-name", type=str, default="seamlessM4T_v2_large")
    parser.add_argument("--expressive", action="store_true",
                        help="expressive S2ST: synthesize through the gated PRETSSEL "
                             "vocoder (prosody from the source audio); use "
                             "--vocoder-name vocoder_pretssel[_16khz]")
    parser.add_argument("--local-hf-path", type=str, default=None)
    parser.add_argument("--gated-model-dir", type=str, default=None,
                        help="directory of the gated checkpoints (m2m_expressive_unity.pt, "
                             "pretssel_melhifigan_wm*.pt); sets SEAMLESS_GATED_ASSETS")
    parser.add_argument("--no-strip-silence", action="store_true",
                        help="keep leading and trailing silence (by default each "
                             "utterance is VAD-trimmed to [first speech, last speech), "
                             "as the reference's streaming data loader does)")
    parser.add_argument("--silero-model", type=str, default=None,
                        help="TorchScript silero-vad model for the silence stripper "
                             "(default: the energy VAD)")
    parser.add_argument("--device", type=str, default=None,
                        help="where to run: the CUDA card by default, or cpu")
    args = parser.parse_args(argv)
    if args.gated_model_dir:
        os.environ["SEAMLESS_GATED_ASSETS"] = args.gated_model_dir

    import numpy as np

    from seamless_communication_torch.audio.wav import read_wav, resample
    from seamless_communication_torch.cli.loading import (
        load_monotonic_decoder, load_unity_model_and_tokenizers, load_vocoder,
    )
    from seamless_communication_torch.streaming.evaluator import evaluate_streaming
    from seamless_communication_torch.streaming.pipeline import (
        build_s2st_pipeline, build_s2t_pipeline,
    )

    dev = resolve_device(args.device)
    unity_params, unity_cfg, text_tok, unit_tok, char_tok = \
        load_unity_model_and_tokenizers(args.unity_name, local_hf_path=args.local_hf_path,
                                        device=dev)
    mono_params, mono_cfg = load_monotonic_decoder(args.monotonic_name, device=dev)

    stripper = None
    if not args.no_strip_silence:
        from seamless_communication_torch.segment.vad import (
            make_silero_probs_fn, strip_silence,
        )
        probs_fn = make_silero_probs_fn(args.silero_model) if args.silero_model else None

        def stripper(w):
            return strip_silence(w, probs_fn=probs_fn)

        logger.info("stripping leading and trailing silence from each utterance "
                    "(--no-strip-silence to keep it)")

    wavs, refs = [], []
    with open(args.data_file) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            w, sr = read_wav(str(Path(args.audio_root_dir) / row["audio"]))
            w = resample(w, sr, 16000)
            wavs.append(stripper(w) if stripper is not None else w)
            refs.append(row.get("tgt_text", ""))

    transcribe = None
    if args.compute_asr_bleu and args.task == "s2st":
        # the streaming UnitY has no text decoder: a full M4T model does the ASR
        from seamless_communication_torch.cli.eval_utils import make_m4t_transcriber
        transcribe = make_m4t_transcriber(args.asr_model_name, lang=args.tgt_lang,
                                          local_hf_path=args.local_hf_path, device=dev)

    common = dict(tgt_lang=args.tgt_lang,
                  min_starting_wait_w2vbert=args.min_starting_wait_w2vbert,
                  decision_threshold=args.decision_threshold, device=dev)
    scoring = dict(references=refs, tgt_lang=args.tgt_lang,
                   segment_size_ms=args.source_segment_size)
    if args.task in ("s2tt", "asr"):
        def factory():
            return build_s2t_pipeline(unity_params, unity_cfg, mono_params, mono_cfg,
                                      text_tok, **common)
        metrics = evaluate_streaming(factory, wavs, **scoring)
    elif args.expressive:
        from seamless_communication_torch.cli.loading import load_pretssel_vocoder
        from seamless_communication_torch.streaming.pipeline import (
            build_expressive_s2st_pipeline,
        )
        voc_name = args.vocoder_name if "pretssel" in args.vocoder_name \
            else "vocoder_pretssel"
        voc_params, voc_cfg, mc, voc_sr = load_pretssel_vocoder(voc_name, device=dev)
        stats = mc.get("gcmvn_stats", {})
        gcmvn_mean = np.asarray(stats.get("mean", np.zeros(80)), np.float32)
        gcmvn_std = np.asarray(stats.get("std", np.ones(80)), np.float32)
        lang_to_index = {lang: i for i, lang in enumerate(mc.get("langs", []))}

        def factory():
            return build_expressive_s2st_pipeline(
                unity_params, unity_cfg, mono_params, mono_cfg, text_tok, unit_tok,
                char_tok, voc_params, voc_cfg, lang_to_index, gcmvn_mean, gcmvn_std,
                sample_rate=voc_sr, min_unit_chunk_size=args.min_unit_chunk_size,
                **common)
        metrics = evaluate_streaming(factory, wavs, output_is_speech=True,
                                     transcribe=transcribe, **scoring)
    else:
        voc_params, voc_cfg, idx_map = load_vocoder(
            args.vocoder_name, local_hf_path=args.local_hf_path, device=dev)

        def factory():
            return build_s2st_pipeline(
                unity_params, unity_cfg, mono_params, mono_cfg, text_tok, unit_tok,
                char_tok, voc_params, voc_cfg, idx_map,
                min_unit_chunk_size=args.min_unit_chunk_size, **common)
        metrics = evaluate_streaming(factory, wavs, output_is_speech=True,
                                     transcribe=transcribe, **scoring)

    Path(args.output).mkdir(parents=True, exist_ok=True)
    with open(Path(args.output) / "metrics.json", "w") as f:
        json.dump(metrics, f, indent=2)
    logger.info("metrics: %s", json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
