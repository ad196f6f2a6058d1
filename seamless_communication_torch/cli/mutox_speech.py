"""mutox_speech: a toxicity logit for each audio file listed on STDIN, one
path a line, written to STDOUT (counterpart of
``seamless_communication_tpu/cli/mutox_speech.py``; reference
cli/toxicity/mutox/mutox_speech.py:27-140).

    python3 -m seamless_communication_torch.cli.mutox_speech LANG [IN] [OUT] \\
        --classifier_pt mutox.pt [--sonar_torchscript ENC.pt] \\
        [--batch_size 4] [--device cuda|cpu]

SONAR speech embeddings come from the ``sonar`` package where it is
installed, or from a TorchScript export (``--sonar_torchscript``). The flags
are the JAX package's, plus ``--device`` (the CUDA card unless it says
``cpu``), where both the embedder and the classifier run.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="MuToX speech toxicity scores (audio paths on STDIN)")
    parser.add_argument("lang", type=str,
                        help="language of the speech (SONAR encoder choice), e.g. eng")
    parser.add_argument("input", nargs="?", type=argparse.FileType("r"),
                        default=sys.stdin)
    parser.add_argument("output", nargs="?", type=argparse.FileType("w"),
                        default=sys.stdout)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--classifier_pt", type=str, required=True,
                        help="the reference mutox.pt classifier checkpoint")
    parser.add_argument("--sonar_torchscript", type=str, default=None,
                        help="TorchScript SONAR speech encoder; default uses "
                             "the sonar package's sonar_speech_encoder_<lang>")
    parser.add_argument("--device", type=str, default=None,
                        help="where to run: the CUDA card by default, or cpu")
    args, _unknown = parser.parse_known_args(argv)

    from seamless_communication_torch.audio.wav import read_wav, resample
    from seamless_communication_torch.checkpoint.convert_fairseq2 import (
        load_pt_state_dict, mutox_tree_from_pt,
    )
    from seamless_communication_torch.device import resolve_device
    from seamless_communication_torch.toxicity.mutox import MutoxClassifier
    from seamless_communication_torch.toxicity.mutox_speech import (
        MutoxSpeechPipeline, sonar_package_embedder, sonar_torchscript_embedder,
    )

    device = resolve_device(args.device)
    classifier = MutoxClassifier(mutox_tree_from_pt(load_pt_state_dict(args.classifier_pt)),
                                 device=device)
    embedder = (sonar_torchscript_embedder(args.sonar_torchscript, device=classifier.device)
                if args.sonar_torchscript
                else sonar_package_embedder(f"sonar_speech_encoder_{args.lang}",
                                            device=classifier.device))
    pipeline = MutoxSpeechPipeline(classifier, embedder)

    paths = [line.strip() for line in args.input if line.strip()]
    print("path", "score", sep="\t", file=args.output)
    for i in range(0, len(paths), args.batch_size):
        batch = paths[i:i + args.batch_size]
        wavs = []
        for p in batch:
            wav, sr = read_wav(p)
            wavs.append(resample(wav, sr, 16000))
        scores = pipeline.predict(wavs, batch_size=args.batch_size)
        for p, s in zip(batch, scores):
            print(p, float(s), sep="\t", file=args.output)
    args.output.flush()


if __name__ == "__main__":
    main()
