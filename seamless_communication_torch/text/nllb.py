"""NLLB text tokenizer: SentencePiece plus fairseq2's control-symbol and
language-token conventions (a copy of ``seamless_communication_tpu/text/nllb.py``).

Vocab layout:
    0 <pad>   1 <unk>   2 <s>   3 </s>
    4.. SPM pieces (spm id i >= 3 maps to i + 1)
    then language control symbols ``__lang__`` and extras (<MINED_DATA>)

Target prefix: [eos, tgt_lang]; source: [src_lang] X [eos].
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from seamless_communication_torch.text.spm import SentencePieceModel


class VocabInfo:
    def __init__(self, size: int, pad_idx=0, unk_idx=1, bos_idx=2, eos_idx=3):
        self.size = size
        self.pad_idx = pad_idx
        self.unk_idx = unk_idx
        self.bos_idx = bos_idx
        self.eos_idx = eos_idx


class NllbTokenizer:
    FAIRSEQ_OFFSET = 1  # spm id -> vocab id shift (pad inserted at 0)

    def __init__(self, spm: SentencePieceModel, langs: Sequence[str], *,
                 extra_symbols: Sequence[str] = ("<MINED_DATA>",)):
        self.spm = spm
        self.langs = list(langs)
        base = len(spm) + self.FAIRSEQ_OFFSET
        self.lang_to_id = {lang: base + i for i, lang in enumerate(self.langs)}
        self.extra_to_id = {s: base + len(self.langs) + i
                            for i, s in enumerate(extra_symbols)}
        self.vocab_info = VocabInfo(base + len(self.langs) + len(extra_symbols))

    @classmethod
    def from_file(cls, spm_path: str, langs: Sequence[str], **kw) -> "NllbTokenizer":
        return cls(SentencePieceModel.from_file(spm_path), langs, **kw)

    def _spm_to_vocab(self, ids: List[int]) -> List[int]:
        return [self.vocab_info.unk_idx if i == self.spm.unk_id
                else i + self.FAIRSEQ_OFFSET for i in ids]

    def token_to_id(self, tok: str) -> int:
        if tok in self.lang_to_id:
            return self.lang_to_id[tok]
        if tok in self.extra_to_id:
            return self.extra_to_id[tok]
        specials = {"<pad>": 0, "<unk>": 1, "<s>": 2, "</s>": 3}
        if tok in specials:
            return specials[tok]
        return self.spm.piece_to_id_or_unk(tok) + self.FAIRSEQ_OFFSET

    def lang_token(self, lang: str) -> int:
        key = lang if lang.startswith("__") else f"__{lang}__"
        if key not in self.lang_to_id:
            raise ValueError(f"unsupported language {lang!r}")
        return self.lang_to_id[key]

    def encode(self, text: str) -> List[int]:
        return self._spm_to_vocab(self.spm.encode(text))

    def encode_source(self, text: str, src_lang: str) -> np.ndarray:
        ids = [self.lang_token(src_lang)] + self.encode(text) + [self.vocab_info.eos_idx]
        return np.asarray(ids, np.int32)

    def target_prefix(self, tgt_lang: str) -> np.ndarray:
        return np.asarray([self.vocab_info.eos_idx, self.lang_token(tgt_lang)], np.int32)

    def encode_target(self, text: str, tgt_lang: str) -> np.ndarray:
        ids = (list(self.target_prefix(tgt_lang)) + self.encode(text)
               + [self.vocab_info.eos_idx])
        return np.asarray(ids, np.int32)

    def decode(self, ids: Sequence[int], *, skip_special: bool = True) -> str:
        spm_ids = []
        for i in ids:
            i = int(i)
            if i < 4 or i >= len(self.spm) + self.FAIRSEQ_OFFSET:
                if skip_special:
                    continue
            else:
                spm_ids.append(i - self.FAIRSEQ_OFFSET)
        return self.spm.decode(spm_ids)

    def id_to_token(self, i: int) -> str:
        i = int(i)
        specials = {0: "<pad>", 1: "<unk>", 2: "<s>", 3: "</s>"}
        if i in specials:
            return specials[i]
        if i < len(self.spm) + self.FAIRSEQ_OFFSET:
            return self.spm.id_to_piece(i - self.FAIRSEQ_OFFSET)
        for table in (self.lang_to_id, self.extra_to_id):
            for tok, tid in table.items():
                if tid == i:
                    return tok
        return "<unk>"
