"""Host-side text -> char preprocessing for the NAR T2U (a copy of
``seamless_communication_tpu/text/char_frontend.py``).

Rules (merge_space_with_prev_subword=False, the default):
  - target-mode text seq [eos, lang, t1..tn, eos]: lang/eos positions get 0 chars
  - <unk> counts as 1 char (char id = unk)
  - a single-char punctuation subword absorbs the following subword's leading
    space (count += 1); the subword after it loses its leading space
    (count -= 1)
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer

SPACE = "▁"


def _is_punc(sub: str) -> bool:
    return len(sub) == 1 and not sub.isalpha() and not sub.isnumeric() and sub != SPACE


def text_to_char_seqs(text_tokenizer: NllbTokenizer, char_tokenizer: CharTokenizer,
                      text_seqs: np.ndarray, *, max_char_len: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(B, T) target-mode token ids ([eos, lang, ..., eos], right-padded with
    pad) -> (char_ids (B, max_char_len), char_seq_lens (B,), char_counts (B, T)).

    ``char_counts`` uses the shifted alignment of the reference: the char
    count of token t_i sits on the decoder feature at position i-1, the
    feature that predicted t_i, so ``char_counts[b, 1:1 + n]`` holds the n
    counts and the leading EOS and the last feature position get 0.
    """
    pad = text_tokenizer.vocab_info.pad_idx
    unk = text_tokenizer.vocab_info.unk_idx
    eos = text_tokenizer.vocab_info.eos_idx
    B, T = text_seqs.shape

    char_counts = np.zeros((B, T), np.int32)
    char_ids = np.full((B, max_char_len), char_tokenizer.vocab_info.pad_idx, np.int32)
    char_seq_lens = np.zeros((B,), np.int32)

    for b in range(B):
        # strip the [eos, lang] prefix; EOS counts as pad
        core = [int(t) for t in text_seqs[b, 2:]]
        core = [pad if t == eos else t for t in core]
        n = next((i for i, t in enumerate(core) if t == pad), len(core))
        toks = core[:n]
        subs = [text_tokenizer.id_to_token(t) if t != unk else "<unk>" for t in toks]

        next_space = [len(subs[i + 1]) > 1 and subs[i + 1][0] == SPACE
                      if i < len(subs) - 1 else False for i in range(len(subs))]
        punc = [_is_punc(s) for s in subs]

        counts: List[int] = []
        all_chars: List[int] = []
        for i, (tid, sub) in enumerate(zip(toks, subs)):
            if tid == unk:
                c = 1
                ids = [unk]
            else:
                c = len(sub)
                if punc[i] and next_space[i]:
                    c += 1
                elif i > 0 and punc[i - 1] and next_space[i - 1]:
                    c -= 1
                ids = char_tokenizer.encode_chars(sub)
            counts.append(c)
            all_chars.extend(ids)

        # shifted alignment: [eos(0), lang<-c(t1), t1<-c(t2), ...,
        # t_{n-1}<-c(t_n), t_n<-0, pads(0)]
        char_counts[b, 1:1 + len(counts)] = counts
        total = min(len(all_chars), max_char_len)
        char_ids[b, :total] = all_chars[:total]
        char_seq_lens[b] = total

    return char_ids, char_seq_lens, char_counts
