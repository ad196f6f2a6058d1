"""Character-level SentencePiece tokenizer for the char upsampler of the NAR
T2U (a copy of ``seamless_communication_tpu/text/char_tokenizer.py``).

The fairseq2 vocab convention of NLLB: pad=0 inserted, spm ids shifted by 1.
"""

from __future__ import annotations

from typing import List, Sequence

from seamless_communication_torch.text.nllb import VocabInfo
from seamless_communication_torch.text.spm import SentencePieceModel


class CharTokenizer:
    FAIRSEQ_OFFSET = 1

    def __init__(self, spm: SentencePieceModel):
        self.spm = spm
        self.vocab_info = VocabInfo(len(spm) + self.FAIRSEQ_OFFSET)

    @classmethod
    def from_file(cls, path: str) -> "CharTokenizer":
        return cls(SentencePieceModel.from_file(path))

    def encode_chars(self, word: str) -> List[int]:
        """Per-character ids of a subword string, each character looked up on
        its own (no resegmentation); unknown -> unk."""
        out = []
        for ch in word:
            pid = self.spm.piece_to_id.get(ch)
            if pid is None or pid == self.spm.unk_id:
                out.append(self.vocab_info.unk_idx)
            else:
                out.append(pid + self.FAIRSEQ_OFFSET)
        return out

    def encode(self, text: str) -> List[int]:
        return [self.vocab_info.unk_idx if i == self.spm.unk_id
                else i + self.FAIRSEQ_OFFSET for i in self.spm.encode(text)]

    def decode(self, ids: Sequence[int]) -> str:
        return self.spm.decode([int(i) - self.FAIRSEQ_OFFSET for i in ids
                                if int(i) >= 4])
