"""MinTox: mitigation of added toxicity at inference time (a copy of
``seamless_communication_tpu/toxicity/mintox.py``, which follows the
reference toxicity/mintox.py:93-221).

Flow: detect added toxicity per batch item (ETOX) -> for offending items only,
re-run generation with a BannedSequenceProcessor inside the beam search
(banning each bad word's raw encoding AND its mid-word form via the "★"-prefix
trick, mintox.py:125-135) -> splice results back into the original batch.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.toxicity.etox import ETOXBadWordChecker

logger = logging.getLogger(__name__)


def banned_sequences_from_words(text_tokenizer: NllbTokenizer,
                                bad_words: Sequence[str]
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode banned words as token-id sequences, plus their mid-text variants
    ("★word" encoding minus its first token catches ",word", "*word", ...).
    Returns (N, M) int32 left-padded with -1 and (N,) lengths — the format of
    ops.beam_search.make_banned_sequence_processor."""
    seqs: List[List[int]] = []
    for w in bad_words:
        raw = text_tokenizer.encode(w)
        if raw:
            seqs.append(raw)
        star = text_tokenizer.encode(f"★{w}")[1:]
        if star:
            seqs.append(star)
    if not seqs:
        return np.zeros((0, 1), np.int32), np.zeros((0,), np.int32)
    M = max(len(s) for s in seqs)
    arr = np.full((len(seqs), M), -1, np.int32)
    lens = np.zeros((len(seqs),), np.int32)
    for i, s in enumerate(seqs):
        arr[i, M - len(s):] = s          # right-aligned (window compare convention)
        lens[i] = len(s)
    return arr, lens


def extract_bad_words_with_batch_indices(
        src_texts: Sequence[str], tgt_texts: Sequence[str], src_lang: str,
        tgt_lang: str, checker: ETOXBadWordChecker
) -> Tuple[List[str], List[int]]:
    bad_words: List[str] = []
    indices: List[int] = []
    for i, (s, t) in enumerate(zip(src_texts, tgt_texts)):
        words = checker.extract_bad_words(str(s), str(t), src_lang, tgt_lang)
        if words:
            indices.append(i)
            bad_words.extend(words)
    return bad_words, indices


def mintox_pipeline(*, checker: ETOXBadWordChecker,
                    text_tokenizer: NllbTokenizer,
                    src_texts: Sequence[str],
                    original_texts: List[str],
                    original_units: Optional[List[List[int]]],
                    src_lang: str, tgt_lang: str,
                    rerun_fn: Callable,
                    ) -> Tuple[List[str], Optional[List[List[int]]]]:
    """``rerun_fn(batch_indices, banned) -> (texts, units|None)`` re-generates the
    offending subset with the banned-sequence processor enabled."""
    bad_words, indices = extract_bad_words_with_batch_indices(
        src_texts, original_texts, src_lang, tgt_lang, checker)
    if not indices:
        return original_texts, original_units

    logger.info("TOX src_lang=%s tgt_lang=%s added_tox=%d",
                src_lang, tgt_lang, len(indices))
    banned = banned_sequences_from_words(text_tokenizer, sorted(set(bad_words)))
    new_texts, new_units = rerun_fn(indices, banned)

    texts = list(original_texts)
    units = list(original_units) if original_units is not None else None
    for j, idx in enumerate(indices):
        texts[idx] = new_texts[j]
        if units is not None and new_units is not None:
            units[idx] = new_units[j]
    return texts, units
