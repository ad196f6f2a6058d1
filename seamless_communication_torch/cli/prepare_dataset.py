"""m4t_prepare_dataset: a finetuning corpus from HF datasets to the JSON
manifest the finetune trainer reads (counterpart of
``seamless_communication_tpu/cli/prepare_dataset.py``; reference
cli/m4t/finetune/dataset.py): FLEURS S2ST pairs, optionally with the target
speech's units (XLSR + k-means, ``UnitExtractor``) and per-char durations
(``AlignmentExtractor``), or GigaSpeech ASR.

    python3 -m seamless_communication_torch.cli.prepare_dataset \\
        --name google/fleurs --source_lang en_us --target_lang fr_fr \\
        --split train --save_dir DIR [--extract_units --w2v2_checkpoint X.pt \\
        --kmeans_path K.npy [--aligner_pt A.pt --char_spm C.model]] [--device cuda|cpu]

The flags are the JAX package's, plus ``--device`` (where the unit
extractor and the aligner run: the CUDA card unless it says ``cpu``).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

logger = logging.getLogger("prepare_dataset")

SUPPORTED_DATASETS = ["google/fleurs", "speechcolab/gigaspeech"]


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Parse ``argv``, build the corpus and write its manifest; returns the
    manifest's path."""
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        description="Download a finetune corpus and write manifest.json")
    parser.add_argument("--name", type=str, default="google/fleurs",
                        choices=SUPPORTED_DATASETS)
    parser.add_argument("--source_lang", type=str, default=None,
                        help="FLEURS config name, e.g. en_us")
    parser.add_argument("--target_lang", type=str, default=None,
                        help="FLEURS config name, e.g. fr_fr")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--huggingface_token", type=str, default=None,
                        help="required for the gated GigaSpeech dataset")
    parser.add_argument("--extract_units", action="store_true",
                        help="extract target speech units (XLSR + kmeans; needs "
                             "--w2v2_checkpoint and --kmeans_path)")
    parser.add_argument("--w2v2_checkpoint", type=str, default=None)
    parser.add_argument("--kmeans_path", type=str, default=None)
    parser.add_argument("--aligner_pt", type=str, default=None,
                        help="UnitY2 aligner .pt: also write per-char unit durations "
                             "(NAR-T2U S2S training targets); needs --char_spm and "
                             "--extract_units")
    parser.add_argument("--char_spm", type=str, default=None,
                        help="spm_char_lang38_tc.model for the aligner")
    parser.add_argument("--device", type=str, default=None,
                        help="where the unit extractor and the aligner run: the CUDA "
                             "card by default, or cpu")
    args = parser.parse_args(argv)

    from seamless_communication_torch.datasets.huggingface import (
        build_fleurs_s2s, build_gigaspeech_asr, write_manifest,
    )

    if args.name == "google/fleurs":
        if not (args.source_lang and args.target_lang):
            parser.error("--source_lang/--target_lang required for FLEURS")
        unit_extractor = None
        if args.extract_units:
            if not (args.w2v2_checkpoint and args.kmeans_path):
                parser.error("--extract_units needs --w2v2_checkpoint and --kmeans_path")
            from seamless_communication_torch.checkpoint.convert_fairseq2 import (
                load_pt_state_dict, wav2vec2_raw_tree_from_pt,
            )
            from seamless_communication_torch.checkpoint.serialize import load_params
            from seamless_communication_torch.models.unit_extractor import (
                KmeansModel, UnitExtractor,
            )
            w2v2 = (wav2vec2_raw_tree_from_pt(load_pt_state_dict(args.w2v2_checkpoint))
                    if args.w2v2_checkpoint.endswith(".pt")
                    else load_params(args.w2v2_checkpoint))
            unit_extractor = UnitExtractor(w2v2, KmeansModel.from_npy(args.kmeans_path),
                                           device=args.device)
        aligner = None
        if args.aligner_pt:
            if not (args.char_spm and unit_extractor):
                parser.error("--aligner_pt needs --char_spm and --extract_units")
            from seamless_communication_torch.models.aligner.extractor import (
                AlignmentExtractor,
            )
            from seamless_communication_torch.text.char_tokenizer import CharTokenizer
            aligner = AlignmentExtractor(
                args.aligner_pt, char_tokenizer=CharTokenizer.from_file(args.char_spm),
                device=args.device)
        samples = build_fleurs_s2s(args.source_lang, args.target_lang, args.split,
                                   args.save_dir, unit_extractor=unit_extractor,
                                   aligner=aligner, max_samples=args.max_samples)
    else:
        if args.huggingface_token is None:
            parser.error("--huggingface_token is required for GigaSpeech "
                         "(please accept the GigaSpeech agreement)")
        # an explicit token beats a stale HF_TOKEN in the environment
        os.environ["HF_TOKEN"] = args.huggingface_token
        samples = build_gigaspeech_asr(args.split, args.save_dir,
                                       max_samples=args.max_samples)

    manifest = os.path.join(args.save_dir, f"{args.split.replace('.', '_')}_manifest.json")
    n = write_manifest(samples, manifest)
    logger.info("wrote %d samples to %s", n, manifest)
    return manifest


if __name__ == "__main__":
    main()
