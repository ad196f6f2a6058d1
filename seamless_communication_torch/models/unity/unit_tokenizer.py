"""Speech-unit tokenizer (a copy of
``seamless_communication_tpu/models/unity/unit_tokenizer.py``; the
``streaming`` and ``tiny_expressive`` archs count as v2 archs here).

Vocab = 4 control symbols + num_units + language symbols, in fairseq's
control order bos=0, pad=1, eos=2, unk=3 (not the text vocab's order).

v1 (AR decoder):  lang symbols repeated twice (+<mask> placeholder, legacy);
                  encoded sequences = [eos, lang] + (units + 4)
v2 (NAR decoder): single lang block; encoded sequences = units + 4 (no prefix)

Decoding maps EOS to PAD, subtracts the +4 control offset, and keeps the AR
lang symbol.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class UnitTokenizer:
    def __init__(self, num_units: int, langs: Sequence[str], model_arch: str = "base_v2"):
        self.num_units = num_units
        self.langs = list(langs)
        self.lang_map = {lang: i for i, lang in enumerate(self.langs)}
        # the streaming and tiny_expressive archs' T2U is v2's NAR one (the
        # JAX package's copy takes both for AR archs; its cards say base_v2
        # and expressivity_v2)
        self.is_nar_decoder = (model_arch.split("_")[-1] == "v2"
                               or model_arch in ("streaming", "tiny_expressive"))
        self.lang_symbol_repetitions = 1 if self.is_nar_decoder else 2
        self.vocab_size = (num_units
                           + self.lang_symbol_repetitions * (len(self.langs) + 1) + 4)
        self.bos_idx, self.pad_idx, self.eos_idx, self.unk_idx = 0, 1, 2, 3

    def lang_to_index(self, lang: str) -> int:
        if lang not in self.lang_map:
            raise ValueError(f"unsupported unit language {lang!r}; "
                             f"supported: {', '.join(self.langs)}")
        return (self.num_units
                + (self.lang_symbol_repetitions - 1) * (len(self.langs) + 1)
                + self.lang_map[lang] + 4)

    def index_to_lang(self, idx: int) -> str:
        rel = (idx - self.num_units
               - (self.lang_symbol_repetitions - 1) * (len(self.langs) + 1) - 4)
        if rel < 0 or rel >= len(self.langs):
            raise ValueError(f"index {idx} is not a language symbol")
        return self.langs[rel]

    def encode(self, units: np.ndarray, lang: str) -> np.ndarray:
        """(N, S) raw units -> token ids; AR gets the [eos, lang] prefix."""
        units = np.asarray(units, np.int64)
        seqs = units + 4
        seqs[seqs >= self.num_units + 4] = self.unk_idx
        if self.is_nar_decoder:
            return seqs
        B = units.shape[0]
        prefix = np.tile(np.array([[self.eos_idx, self.lang_to_index(lang)]]), (B, 1))
        return np.concatenate([prefix, seqs], axis=1)

    def decode(self, token_indices: np.ndarray) -> np.ndarray:
        """token ids -> raw units (PAD marks removed/end); the inverse of
        ``encode``."""
        units = np.asarray(token_indices, np.int64).copy()
        if units.shape[1] == 0:
            return units
        if not self.is_nar_decoder:
            units = units[:, 1:]  # strip the leading EOS
        units[units == self.eos_idx] = self.pad_idx
        units[units == self.pad_idx] = self.pad_idx + 4
        if self.is_nar_decoder:
            units = units - 4
        else:
            units[:, 1:] -= 4  # keep the lang symbol raw at position 0
        return units
