"""mutox_text: a toxicity logit for each line of text on STDIN, written to
STDOUT (counterpart of ``seamless_communication_tpu/cli/mutox_text.py``;
reference cli/toxicity/mutox/mutox_text.py:24-98).

    python3 -m seamless_communication_torch.cli.mutox_text LANG [IN] [OUT] \\
        --classifier_pt mutox.pt [--sonar_torchscript ENC.pt] \\
        [--batch_size 4] [--device cuda|cpu]

Text embeddings come from Meta's SONAR text encoder: the ``sonar`` package
where it is installed, or a TorchScript export (``--sonar_torchscript``,
texts -> (B, 1024)). The flags are the JAX package's, plus ``--device``
(the CUDA card unless it says ``cpu``), where both the embedder and the
classifier run.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="MuToX text toxicity scores (STDIN > STDOUT)")
    parser.add_argument("lang", type=str,
                        help="language of the input text, nllb format with script "
                             "(e.g. eng_Latn)")
    parser.add_argument("input", nargs="?", type=argparse.FileType("r"),
                        default=sys.stdin)
    parser.add_argument("output", nargs="?", type=argparse.FileType("w"),
                        default=sys.stdout)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--classifier_pt", type=str, required=True,
                        help="the reference mutox.pt classifier checkpoint")
    parser.add_argument("--sonar_torchscript", type=str, default=None,
                        help="TorchScript SONAR TEXT encoder (texts -> (B,1024)); "
                             "default uses the sonar package")
    parser.add_argument("--device", type=str, default=None,
                        help="where to run: the CUDA card by default, or cpu")
    args, _unknown = parser.parse_known_args(argv)

    import torch

    from seamless_communication_torch.checkpoint.convert_fairseq2 import (
        load_pt_state_dict, mutox_tree_from_pt,
    )
    from seamless_communication_torch.device import resolve_device
    from seamless_communication_torch.toxicity.mutox import MutoxClassifier

    device = resolve_device(args.device)
    classifier = MutoxClassifier(mutox_tree_from_pt(load_pt_state_dict(args.classifier_pt)),
                                 device=device)

    if args.sonar_torchscript:
        model = torch.jit.load(args.sonar_torchscript, map_location=classifier.device)
        model.eval()

        def embed(texts):
            with torch.no_grad():
                return model(list(texts)).float().cpu().numpy()
    else:
        from sonar.inference_pipelines.text import TextToEmbeddingModelPipeline

        pipe = TextToEmbeddingModelPipeline(encoder="text_sonar_basic_encoder",
                                            tokenizer="text_sonar_basic_encoder",
                                            device=classifier.device)

        def embed(texts):
            return pipe.predict(list(texts), source_lang=args.lang).cpu().numpy()

    def write_result(batch):
        scores = classifier.predict(None, lambda _: embed(batch)).cpu().numpy()
        for text, s in zip(batch, np.asarray(scores)):
            print(text, float(s), sep="\t", file=args.output)

    print("text", "score", sep="\t", file=args.output)
    batch = []
    for line in args.input:
        batch.append(line.rstrip("\n"))
        if len(batch) >= args.batch_size:
            write_result(batch)
            batch = []
    if batch:
        write_result(batch)
    args.output.flush()


if __name__ == "__main__":
    main()
