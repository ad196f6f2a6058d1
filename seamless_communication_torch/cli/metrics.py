"""Corpus BLEU and chrF++ as sacrebleu 2 computes them (its ``corpus_bleu``
with the ``13a`` or ``char`` tokenizer and ``exp`` smoothing, and its
``corpus_chrf``), for one reference a segment: the scores of the evaluation
CLIs and the streaming evaluator need no third-party package, so they run
where ``sacrebleu`` is not installed. ``tests/test_torch_evaluation.py``
holds both to sacrebleu's results.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import List, Sequence

MAX_NGRAM_ORDER = 4
CHAR_ORDER, WORD_ORDER, BETA = 6, 2, 2

# sacrebleu's TokenizerRegexp, the second stage of its 13a tokenizer
_13A_RULES = [
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]
_PUNCTS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def tokenize_13a(line: str) -> str:
    """mteval-v13a's tokenization (sacrebleu's ``Tokenizer13a``)."""
    line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
    if "&" in line:
        line = (line.replace("&quot;", '"').replace("&amp;", "&")
                .replace("&lt;", "<").replace("&gt;", ">"))
    line = f" {line} "
    for rule, repl in _13A_RULES:
        line = rule.sub(repl, line)
    return " ".join(line.split())


def tokenize_char(line: str) -> str:
    return " ".join(line)


_TOKENIZERS = {"13a": tokenize_13a, "char": tokenize_char}


def _word_ngrams(line: str, max_order: int) -> tuple[Counter, int]:
    tokens = line.split()
    return Counter(tuple(tokens[i:i + n]) for n in range(1, max_order + 1)
                   for i in range(len(tokens) - n + 1)), len(tokens)


def corpus_bleu(hyps: Sequence[str], refs: Sequence[str], *, tokenize: str = "13a") -> float:
    """BLEU of ``hyps`` against one reference each, in [0, 100]."""
    tok = _TOKENIZERS[tokenize]
    sys_len = ref_len = 0
    correct = [0] * MAX_NGRAM_ORDER
    total = [0] * MAX_NGRAM_ORDER
    for hyp, ref in zip(hyps, refs):
        ref_ngrams, n_ref = _word_ngrams(tok(ref.rstrip()), MAX_NGRAM_ORDER)
        hyp_ngrams, n_hyp = _word_ngrams(tok(hyp.rstrip()), MAX_NGRAM_ORDER)
        sys_len += n_hyp
        ref_len += n_ref
        for ngram, count in hyp_ngrams.items():
            total[len(ngram) - 1] += count
            if ngram in ref_ngrams:
                correct[len(ngram) - 1] += min(count, ref_ngrams[ngram])
    if not any(correct):
        return 0.0
    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    precisions = [0.0] * MAX_NGRAM_ORDER
    smooth = 1.0
    for n in range(MAX_NGRAM_ORDER):
        if total[n] == 0:
            break
        if correct[n] == 0:        # the "exp" smoothing of mteval-v13a
            smooth *= 2
            precisions[n] = 100.0 / (smooth * total[n])
        else:
            precisions[n] = 100.0 * correct[n] / total[n]
    logs = [math.log(p) if p != 0.0 else -9999999999 for p in precisions]
    return bp * math.exp(sum(logs) / MAX_NGRAM_ORDER)


def _split_punctuation(sent: str) -> List[str]:
    """chrF++'s word split: a final, else a leading, punctuation mark of a
    word of two or more characters becomes a word of its own."""
    out: List[str] = []
    for w in sent.split():
        if len(w) > 1 and w[-1] in _PUNCTS:
            out += [w[:-1], w[-1]]
        elif len(w) > 1 and w[0] in _PUNCTS:
            out += [w[0], w[1:]]
        else:
            out.append(w)
    return out


def _chrf_ngrams(sent: str) -> List[Counter]:
    chars = "".join(sent.split())
    words = _split_punctuation(sent)
    return ([Counter(chars[i:i + n] for i in range(len(chars) - n + 1))
             for n in range(1, CHAR_ORDER + 1)]
            + [Counter(" ".join(words[i:i + n]) for i in range(len(words) - n + 1))
               for n in range(1, WORD_ORDER + 1)])


def corpus_chrf(hyps: Sequence[str], refs: Sequence[str]) -> float:
    """chrF++ (character 6-grams, word bigrams, beta 2) of ``hyps`` against
    one reference each, in [0, 100]."""
    stats = [0] * (3 * (CHAR_ORDER + WORD_ORDER))
    for hyp, ref in zip(hyps, refs):
        for i, (h, r) in enumerate(zip(_chrf_ngrams(hyp), _chrf_ngrams(ref))):
            stats[3 * i] += sum(h.values()) if r else 0
            stats[3 * i + 1] += sum(r.values())
            stats[3 * i + 2] += sum(min(c, r[g]) for g, c in h.items() if g in r)
    factor = BETA ** 2
    avg_prec = avg_rec = 0.0
    order = 0
    for i in range(CHAR_ORDER + WORD_ORDER):
        n_hyp, n_ref, n_match = stats[3 * i:3 * i + 3]
        if n_hyp > 0 and n_ref > 0:
            avg_prec += n_match / n_hyp
            avg_rec += n_match / n_ref
            order += 1
    if order:
        avg_prec /= order
        avg_rec /= order
    if not avg_prec + avg_rec:
        return 0.0
    score = (1 + factor) * avg_prec * avg_rec
    score /= factor * avg_prec + avg_rec
    return 100 * score
