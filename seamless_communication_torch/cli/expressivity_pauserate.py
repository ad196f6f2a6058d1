"""Pause and rate scores of an expressive evaluation (counterpart of
``seamless_communication_tpu/cli/expressivity_pauserate.py``; reference
cli/expressivity/evaluate/post_process_pauserate.py): utterance-level pause
alignment scores weighted into corpus scores, and the Spearman correlation
of the source and target syllable rates. csv and numpy (no pandas, no scipy:
the Spearman correlation is the Pearson correlation of tie-averaged ranks).

    python3 -m seamless_communication_torch.cli.expressivity_pauserate \\
        [--pause_data_tsv P.tsv] [--target_speech_tsv T.tsv --source_speech_tsv S.tsv]
"""

from __future__ import annotations

import argparse
import csv
import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def _read_tsv(path: str) -> List[dict]:
    with open(path) as f:
        return list(csv.DictReader(f, delimiter="\t"))


def get_pause(pause_data_tsv: str) -> Dict[str, float]:
    rows = _read_tsv(pause_data_tsv)
    weights = np.asarray([float(r["total_weight"]) for r in rows], np.float64)
    w = weights / weights.sum()
    return {name: float((np.asarray([float(r[name]) for r in rows]) * w).sum())
            for name in ("wmean_duration_score", "wmean_alignment_score",
                         "wmean_joint_score")}


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    def rank(x):
        order = np.argsort(x)
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(len(x), dtype=np.float64)
        # ties share their average rank
        vals, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
        sums = np.zeros(len(vals))
        np.add.at(sums, inv, ranks)
        return sums[inv] / counts[inv]

    ra, rb = rank(a), rank(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom else float("nan")


def get_rate(target_speech_tsv: str, source_speech_tsv: str,
             speech_unit: str = "syllable") -> float:
    tgt = {r["id"]: float(r[f"speech_rate_{speech_unit}"])
           for r in _read_tsv(target_speech_tsv)}
    src = {r["id"]: float(r[f"speech_rate_{speech_unit}"])
           for r in _read_tsv(source_speech_tsv)}
    ids = sorted(set(tgt) & set(src))
    return _spearman(np.asarray([src[i] for i in ids]), np.asarray([tgt[i] for i in ids]))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="Aggregate expressive pause/rate metrics")
    parser.add_argument("--pause_data_tsv", type=str, default=None)
    parser.add_argument("--target_speech_tsv", type=str, default=None)
    parser.add_argument("--source_speech_tsv", type=str, default=None)
    args = parser.parse_args(argv)

    out: Dict[str, float] = {}
    if args.pause_data_tsv:
        out.update(get_pause(args.pause_data_tsv))
    if args.target_speech_tsv and args.source_speech_tsv:
        out["rate_spearman"] = get_rate(args.target_speech_tsv, args.source_speech_tsv)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
