"""m4t_evaluate: a TSV manifest through ``Translator.predict`` in batches, then
BLEU, chrF (and WER for ASR) or ASR-BLEU (counterpart of
``seamless_communication_tpu/cli/evaluate.py``; reference
cli/m4t/evaluate/evaluate.py).

    python3 -m seamless_communication_torch.cli.evaluate DATA.tsv TASK TGT_LANG \\
        [--model_name CARD] [--local_pt_path FILE.pt] [--batch_size N] \\
        [--audio_root_dir DIR] [--output_path DIR] [--compute_asr_bleu] \\
        [--device cuda|cpu] ...

The flags are the JAX package's, plus ``--device`` (the CUDA card unless it
says ``cpu``), ``--local_pt_path`` (the model's ``.pt`` on disk) and
``m4t_predict``'s text generation flags (beam size and maximum length, for
the Translator and the ASR-BLEU Transcriber; their defaults are the JAX
package's fixed options). Speech input is read by the native runtime's
threaded WAV -> fbank loader (``native.NativeFbankLoader``), which the output
directory's ``run_info.json`` records; a corrupted or empty audio file gives
an empty hypothesis, and a failure of the model raises. Text output is
scored into ``<task>_scores.json``; speech output is written to ``wavs/``
and, with ``--compute_asr_bleu``, transcribed (by Whisper where
``--whisper_model_name`` names a checkpoint that loads, else by the port's
own ``Transcriber``) and scored into ``s2st_asr_bleu.json``.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from seamless_communication_torch.device import resolve_device

logger = logging.getLogger("m4t_evaluate")


def read_manifest(path: str, audio_root: str = ""):
    """The rows of a TSV with a header (``audio`` or ``src_text``, and the
    reference column, ``tgt_text`` by default)."""
    with open(path) as f:
        yield from csv.DictReader(f, delimiter="\t")


def batched(iterable, n):
    buf = []
    for x in iterable:
        buf.append(x)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


class EvaluateResult(NamedTuple):
    hypotheses: List[str]
    references: List[str]
    metrics: dict                 # the scores written, or {} for speech without ASR-BLEU
    loader: Optional[str]         # "native" for speech input, None for text input
    translator: object


def main(argv: Optional[Sequence[str]] = None) -> EvaluateResult:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s -- %(name)s: %(message)s")
    parser = argparse.ArgumentParser(description="M4T evaluation")
    parser.add_argument("data_file", type=str, help="TSV manifest")
    parser.add_argument("task", type=str)
    parser.add_argument("tgt_lang", type=str)
    parser.add_argument("--src_lang", type=str, default=None)
    parser.add_argument("--model_name", type=str, default="seamlessM4T_v2_large")
    parser.add_argument("--vocoder_name", type=str, default="vocoder_v2")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--audio_root_dir", type=str, default="")
    parser.add_argument("--output_path", type=str, default="eval_out")
    parser.add_argument("--local_hf_path", type=str, default=None)
    parser.add_argument("--local_pt_path", type=str, default=None,
                        help="the model's original .pt checkpoint on disk")
    parser.add_argument("--device", type=str, default=None,
                        help="where to run: the CUDA card by default, or cpu")
    parser.add_argument("--ref_field", type=str, default="tgt_text")
    parser.add_argument("--text_generation_beam_size", type=int, default=5)
    parser.add_argument("--text_generation_max_len_a", type=int, default=1)
    parser.add_argument("--text_generation_max_len_b", type=int, default=200)
    parser.add_argument("--whisper_model_name", type=str, default=None,
                        help="HF Whisper checkpoint (name or local path) for ASR-BLEU "
                             "comparable to the reference's numbers; the port's own "
                             "Transcriber when unset or not loadable")
    parser.add_argument("--compute_asr_bleu", action="store_true",
                        help="for speech output: transcribe the synthesized audio and "
                             "score BLEU against the references")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from seamless_communication_torch.audio.wav import read_wav, resample, write_wav
    from seamless_communication_torch.cli.eval_utils import (
        compute_asr_bleu, compute_quality_metrics,
    )
    from seamless_communication_torch.cli.loading import (
        load_unity_model_and_tokenizers, load_vocoder,
    )
    from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
    from seamless_communication_torch.inference.translator import (
        FbankInput, Modality, Translator, get_modalities_from_task_str,
    )

    in_mod, out_mod = get_modalities_from_task_str(args.task)
    params, cfg, text_tok, unit_tok, char_tok = load_unity_model_and_tokenizers(
        args.model_name, local_hf_path=args.local_hf_path,
        local_pt_path=args.local_pt_path, device=device)
    voc_params = voc_cfg = None
    idx_map = {}
    if out_mod is Modality.SPEECH:
        voc_params, voc_cfg, idx_map = load_vocoder(
            args.vocoder_name, local_hf_path=args.local_hf_path, device=device)
    opts = SequenceGeneratorOptions(
        beam_size=args.text_generation_beam_size,
        soft_max_seq_len=(args.text_generation_max_len_a, args.text_generation_max_len_b))
    translator = Translator(params, cfg, text_tok, unit_tok, char_tok,
                            vocoder_params=voc_params, vocoder_cfg=voc_cfg,
                            lang_spkr_idx_map=idx_map, text_opts=opts, device=device)

    out_dir = Path(args.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    wav_dir = out_dir / "wavs"
    rows = list(read_manifest(args.data_file, args.audio_root_dir))
    loader = None
    if in_mod is Modality.SPEECH:
        # the native threaded WAV -> fbank loader prepares the batches off the
        # Python thread; corrupted files come back with length 0
        from seamless_communication_torch.native import NativeFbankLoader

        paths = [str(Path(args.audio_root_dir) / r["audio"]) for r in rows]
        native = NativeFbankLoader(paths, batch_size=args.batch_size)
        batches = ((batch, FbankInput(fbank=fb, lengths=lens)) for batch, (fb, lens)
                   in zip(batched(rows, args.batch_size), native))
        loader = "native"
        logger.info("using the native data loader (%d files)", len(paths))
    else:
        batches = ((batch, [r["src_text"] for r in batch])
                   for batch in batched(rows, args.batch_size))
    with open(out_dir / "run_info.json", "w") as f:
        json.dump({"loader": loader, "rows": len(rows), "device": str(device)}, f)

    hyps: List[str] = []
    refs: List[str] = []
    for batch, inputs in batches:
        refs.extend(r.get(args.ref_field, "") for r in batch)
        # a failure of the model (the card, a kernel) propagates; a corrupted
        # file is a row of length 0, which the Translator takes as one silent
        # frame and whose hypothesis is blanked here
        texts, speech = translator.predict(inputs, args.task, args.tgt_lang,
                                           src_lang=args.src_lang)
        if isinstance(inputs, FbankInput):
            texts = ["" if inputs.lengths[i] == 0 else t for i, t in enumerate(texts)]
        hyps.extend(str(t) for t in texts)
        if speech is not None:
            wav_dir.mkdir(exist_ok=True)
            for i, w in enumerate(speech.audio_wavs):
                write_wav(str(wav_dir / f"{len(hyps) - len(batch) + i}.wav"), w,
                          speech.sample_rate)
    if loader is not None:
        native.close()

    with open(out_dir / "hypotheses.txt", "w") as f:
        f.write("\n".join(hyps))
    metrics: dict = {}
    if out_mod is Modality.TEXT:
        metrics = compute_quality_metrics(
            hyps, refs, lang=args.tgt_lang, task=args.task,
            output_path=str(out_dir / f"{args.task}_scores.json"))
        logger.info("metrics: %s", json.dumps(metrics))
    elif args.compute_asr_bleu:
        wavs = []
        for i in range(len(hyps)):
            p = wav_dir / f"{i}.wav"
            if p.exists():
                w, sr = read_wav(str(p))
                wavs.append(resample(w, sr, 16000))
            else:
                wavs.append(np.zeros(400, np.float32))
        transcribe = None
        asr_kind = "whisper"
        if args.whisper_model_name:
            try:
                from seamless_communication_torch.cli.eval_utils import (
                    make_whisper_transcriber,
                )
                transcribe = make_whisper_transcriber(args.whisper_model_name,
                                                      lang=args.tgt_lang, device=device)
            except (ImportError, OSError) as exc:
                logger.warning("whisper unavailable (%s); using the port's own ASR", exc)
        if transcribe is None:
            from seamless_communication_torch.inference.transcriber import Transcriber

            asr = Transcriber(translator.params, cfg, text_tok, text_opts=opts,
                              device=device)
            asr_kind = "own_asr"

            def transcribe(batch):
                return [asr.transcribe(w, args.tgt_lang).text for w in batch]

        score = compute_asr_bleu(wavs, refs, transcribe=transcribe, lang=args.tgt_lang)
        metrics = {"asr_bleu": score, "asr": asr_kind}
        with open(out_dir / "s2st_asr_bleu.json", "w") as f:
            json.dump(metrics, f)
        logger.info("ASR-BLEU (%s): %.2f", asr_kind, score)
    return EvaluateResult(hyps, refs, metrics, loader, translator)


if __name__ == "__main__":
    main()
