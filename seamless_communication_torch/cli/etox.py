"""etox: the toxicity of text lines, STDIN to STDOUT, by the NLLB toxicity
word lists (counterpart of ``seamless_communication_tpu/cli/etox.py``;
reference cli/toxicity/etox/etox.py).

    python3 -m seamless_communication_torch.cli.etox LANG [IN] [OUT] \\
        [--etox_dataset nllb-200_twl.zip|DIR] [--sp_model FILE]

Each output line is the text, its number of toxic words and the words. The
word lists and the SentencePiece model (for the languages without word
boundaries) default to the ``mintox`` card's and are read from disk: nothing
is downloaded.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def _load_checker(dataset: Optional[str], sp_model: Optional[str],
                  lang: Optional[str] = None):
    from seamless_communication_torch.assets import load_card, resolve_asset
    from seamless_communication_torch.toxicity.etox import SP_LANGS, load_etox_checker

    card = load_card("mintox")
    dataset = dataset or card["etox_dataset"]
    sp_model = sp_model or card.get("sp_model")
    # only SP_LANGS consult the SentencePiece model: the others do not
    # resolve it
    if lang is not None and lang not in SP_LANGS:
        sp_model = None
    sp_path = resolve_asset(sp_model) if sp_model else None
    return load_etox_checker(resolve_asset(dataset), sp_model_path=sp_path)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="ETOX: compute the toxicity level of text inputs (STDIN > STDOUT)")
    parser.add_argument("lang", type=str, help="language of the text lines")
    parser.add_argument("input", nargs="?", type=argparse.FileType("r"), default=sys.stdin)
    parser.add_argument("output", nargs="?", type=argparse.FileType("w"),
                        default=sys.stdout)
    parser.add_argument("--etox_dataset", type=str, default=None,
                        help="path of the nllb-200_twl word lists (default: the "
                             "mintox card's)")
    parser.add_argument("--sp_model", type=str, default=None)
    args, _unknown = parser.parse_known_args(argv)

    checker = _load_checker(args.etox_dataset, args.sp_model, lang=args.lang)
    print("text", "toxicity", "bad_words", sep="\t", file=args.output)
    for line in args.input:
        text = line.rstrip("\n")
        bad_words = checker.get_bad_words(text=text, lang=args.lang)
        print(text, len(bad_words), ",".join(bad_words), sep="\t", file=args.output)


if __name__ == "__main__":
    main()
