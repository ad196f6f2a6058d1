"""ETOX bad-word checker (a copy of ``seamless_communication_tpu/toxicity/
etox.py``, which follows the reference toxicity/etox_bad_word_checker.py).

Detects ADDED toxicity: bad words present in the target text but absent from the
source. Word lists load per language; space-delimited languages match on
word boundaries, non-segmented languages (SPM set: cmn/jpn/tha/lao/mya etc.)
match on SentencePiece token subsequences.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Set

from seamless_communication_torch.text.spm import SentencePieceModel

# languages matched on SentencePiece token subsequences rather than word
# boundaries (reference etox_bad_word_checker.py SPM_LANGUAGES)
SP_LANGS = ("cmn", "cmn_Hant", "jpn", "tha", "lao", "mya")


class ETOXBadWordChecker:
    def __init__(self, bad_words: Dict[str, List[str]],
                 bad_word_variants: Dict[str, Dict[str, List[str]]],
                 sp_model: Optional[SentencePieceModel] = None,
                 sp_langs: Sequence[str] = SP_LANGS):
        self.bad_words = bad_words
        self.bad_word_variants = bad_word_variants
        self.sp_model = sp_model
        self.sp_langs: Set[str] = set(sp_langs)

    @classmethod
    def from_word_lists(cls, word_lists: Dict[str, List[str]], **kw
                        ) -> "ETOXBadWordChecker":
        """Build from raw per-language word lists; variants are the
        case/normalization forms of each entry."""
        bad_words = {}
        variants: Dict[str, Dict[str, List[str]]] = {}
        for lang, words in word_lists.items():
            bad_words[lang] = list(words)
            variants[lang] = {w: sorted({w, w.lower(), w.upper(), w.capitalize()})
                              for w in words}
        return cls(bad_words, variants, **kw)

    def extract_bad_words(self, source_text: str, target_text: str,
                          source_lang: str, target_lang: str) -> List[str]:
        tgt_bad = self.get_bad_words(target_text, target_lang)
        if not tgt_bad:
            return []
        src_bad = self.get_bad_words(source_text, source_lang)
        if src_bad:
            return []  # toxicity present in source: not "added"
        out: List[str] = []
        for w in tgt_bad:
            out.extend(self.bad_word_variants[target_lang].get(w, [w]))
        return out

    def get_bad_words(self, text: str, lang: str) -> List[str]:
        if lang not in self.bad_words:
            raise RuntimeError(f"MinTox model does not support {lang}.")
        text = re.sub(r"[\W+]", " ", text.lower())
        words = self.bad_words[lang]
        if lang in self.sp_langs and self.sp_model is not None:
            return self._find_in_sp(text, words)
        return self._find_plain(text, words)

    @staticmethod
    def _find_plain(text: str, bad_words: List[str]) -> List[str]:
        padded = " " + text.lower() + " "
        return [w for w in bad_words if " " + w.lower() + " " in padded]

    def _find_in_sp(self, text: str, bad_words: List[str]) -> List[str]:
        toks = self.sp_model.encode_as_pieces(text.lower())
        out = []
        for w in bad_words:
            wt = self.sp_model.encode_as_pieces(w.lower())
            if self._contains(toks, wt):
                out.append(w)
        return out

    @staticmethod
    def _contains(text_tokens: List[str], word_tokens: List[str]) -> bool:
        n, m = len(text_tokens), len(word_tokens)
        if m == 0 or m > n:
            return False
        return any(text_tokens[i:i + m] == word_tokens
                   for i in range(n - m + 1))


def load_etox_checker(dataset_path: str, *,
                      sp_model_path: Optional[str] = None
                      ) -> ETOXBadWordChecker:
    """Build a checker from a local copy of the NLLB toxicity word lists
    (reference mintox.py `_load_toxicity_list`; the `nllb-200_twl.zip` layout:
    one `<lang>_twl.txt` per language, or a directory of the same). The
    dataset URL is in cards/mintox.yaml; this loader is offline-only."""
    import zipfile
    from pathlib import Path

    word_lists: Dict[str, List[str]] = {}

    def add(name: str, text: str):
        stem = Path(name).stem
        lang = stem.split("_twl")[0]
        words = [w.strip() for w in text.splitlines() if w.strip()]
        if words:
            word_lists[lang] = words

    p = Path(dataset_path)
    if p.is_dir():
        for f in sorted(p.glob("*twl*.txt")):
            add(f.name, f.read_text(encoding="utf-8", errors="replace"))
    else:
        with zipfile.ZipFile(p) as z:
            for name in z.namelist():
                if name.endswith(".txt") and "twl" in name:
                    add(name, z.read(name).decode("utf-8", "replace"))
    sp = None
    if sp_model_path:
        from seamless_communication_torch.text.spm import SentencePieceModel
        sp = SentencePieceModel.from_file(sp_model_path)
    return ETOXBadWordChecker.from_word_lists(word_lists, sp_model=sp)
