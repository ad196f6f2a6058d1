"""Quality-metric helpers of the evaluation CLIs (counterpart of
``seamless_communication_tpu/cli/eval_utils.py``; reference
cli/eval_utils/compute_metrics.py): BLEU and chrF++ (``cli/metrics.py``,
sacrebleu's arithmetic without the package; the char tokenizer for cmn,
jpn, tha, lao, mya, yue, zho), WER and CER by edit distance, Whisper's text
normalizers (a faithful subset where the ``whisper`` package is absent) and
ASR-BLEU over any ``transcribe(wavs) -> texts``: a local HF Whisper
checkpoint (``make_whisper_transcriber``) or the port's own M4T ASR
(``make_m4t_transcriber``). ``whisper`` and ``transformers`` are imported
only when used.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

from seamless_communication_torch.cli import metrics

# the reference's char-tokenized BLEU languages
CHAR_LEVEL_LANGS = {"cmn", "jpn", "tha", "lao", "mya", "yue", "zho"}


def get_tokenizer(lang: str) -> str:
    return "char" if lang in CHAR_LEVEL_LANGS else "13a"


def compute_corpus_metric_score(hyps: Sequence[str], refs: Sequence[str], *,
                                lang: str = "eng", metric: str = "bleu") -> float:
    if metric == "bleu":
        return metrics.corpus_bleu(hyps, refs, tokenize=get_tokenizer(lang))
    if metric == "chrf":
        return metrics.corpus_chrf(hyps, refs)
    raise ValueError(f"unknown metric {metric}")


def _edit_distance(a: List[str], b: List[str]) -> int:
    m, n = len(a), len(b)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[n]


def compute_asr_error_rate(hyps: Sequence[str], refs: Sequence[str], *,
                           lang: str = "eng") -> float:
    """WER (CER for the char-level languages)."""
    char_level = lang in CHAR_LEVEL_LANGS
    errors = total = 0
    for h, r in zip(hyps, refs):
        hs = list(h.strip()) if char_level else h.strip().split()
        rs = list(r.strip()) if char_level else r.strip().split()
        errors += _edit_distance(hs, rs)
        total += len(rs)
    return errors / max(total, 1)


def whisper_normalize_text(text: str, lang: str = "eng") -> str:
    """Whisper's EnglishTextNormalizer for eng, BasicTextNormalizer
    otherwise; ``_basic_normalize`` where the package is absent."""
    try:
        if lang == "eng":
            from whisper.normalizers import EnglishTextNormalizer
            return str(EnglishTextNormalizer()(text))
        from whisper.normalizers import BasicTextNormalizer
        return str(BasicTextNormalizer()(text))
    except ImportError:
        return _basic_normalize(text, english=(lang == "eng"))


_ENG_CONTRACTIONS = {
    "won't": "will not", "can't": "can not", "n't": " not", "'re": " are",
    "'ve": " have", "'ll": " will", "'m": " am", "let's": "let us",
}


def _basic_normalize(text: str, *, english: bool = False) -> str:
    """Whisper's BasicTextNormalizer in part (lowercase, bracketed spans and
    diacritics removed, symbols to spaces) and the common English
    contractions expanded."""
    import re
    import unicodedata

    text = text.lower()
    text = re.sub(r"[<\[][^>\]]*[>\]]", " ", text)
    text = re.sub(r"\(([^)]+?)\)", " ", text)
    if english:
        for k, v in _ENG_CONTRACTIONS.items():
            text = text.replace(k, v)
    text = unicodedata.normalize("NFKD", text)
    text = "".join(c for c in text if not unicodedata.combining(c))
    text = "".join(c if (c.isalnum() or c.isspace()) else " " for c in text)
    return " ".join(text.split())


def make_whisper_transcriber(model_name_or_path: str, *, lang: str = "eng",
                             device=None) -> Callable[[Sequence], List[str]]:
    """``transcribe(wavs) -> texts`` over a local HF Whisper checkpoint with
    the reference's decoding: greedy (temperature 0, beam 1), no fallback.
    ``device``: the CUDA card unless the caller passes ``"cpu"``. Raises
    ImportError or OSError when ``transformers`` or the weights are
    missing."""
    import torch
    from transformers import WhisperForConditionalGeneration, WhisperProcessor

    from seamless_communication_torch.device import resolve_device

    device = resolve_device(device)
    processor = WhisperProcessor.from_pretrained(model_name_or_path)
    model = WhisperForConditionalGeneration.from_pretrained(
        model_name_or_path).to(device).eval()
    lang2 = LANG3_TO_LANG2.get(lang, lang[:2])

    def transcribe(wavs: Sequence) -> List[str]:
        out = []
        for wav in wavs:
            feats = processor(np.asarray(wav, np.float32), sampling_rate=16000,
                              return_tensors="pt").input_features.to(device)
            kwargs = {}
            try:
                kwargs["forced_decoder_ids"] = processor.get_decoder_prompt_ids(
                    language=lang2, task="transcribe")
            except (ValueError, KeyError):
                pass
            with torch.no_grad():
                ids = model.generate(feats, num_beams=1, do_sample=False, **kwargs)
            out.append(processor.batch_decode(ids, skip_special_tokens=True)[0])
        return out

    return transcribe


def make_m4t_transcriber(model_name: str, *, lang: str = "eng",
                         local_hf_path: Optional[str] = None,
                         local_pt_path: Optional[str] = None, batch_size: int = 8,
                         device=None) -> Callable[[Sequence], List[str]]:
    """The port's own M4T ASR as ``transcribe(wavs) -> texts``:
    ``Translator.predict(..., "asr", lang)`` in batches of ``batch_size``, so
    a large set never pads into one batch. K1 at every decode step on the
    card."""
    from seamless_communication_torch.cli.loading import load_unity_model_and_tokenizers
    from seamless_communication_torch.inference.translator import Translator

    params, cfg, text_tok, unit_tok, char_tok = load_unity_model_and_tokenizers(
        model_name, local_hf_path=local_hf_path, local_pt_path=local_pt_path,
        device=device)
    translator = Translator(params, cfg, text_tok, unit_tok, char_tok, device=device)

    def transcribe(wavs: Sequence) -> List[str]:
        out: List[str] = []
        for i in range(0, len(wavs), batch_size):
            texts, _ = translator.predict(list(wavs[i:i + batch_size]), "asr", lang)
            out.extend(str(t) for t in texts)
        return out

    return transcribe


# the reference's lang_mapping LANG3 -> LANG2 (Whisper's language codes), its
# most used part; other codes fall back to their first two letters
LANG3_TO_LANG2 = {
    "eng": "en", "spa": "es", "fra": "fr", "deu": "de", "ita": "it",
    "cmn": "zh", "zho": "zh", "jpn": "ja", "kor": "ko", "por": "pt",
    "rus": "ru", "arb": "ar", "hin": "hi", "vie": "vi", "tha": "th",
    "nld": "nl", "pol": "pl", "tur": "tr", "ukr": "uk", "swh": "sw",
    "ben": "bn", "urd": "ur", "ind": "id", "fin": "fi", "swe": "sv",
    "ces": "cs", "ron": "ro", "ell": "el", "heb": "he", "hun": "hu",
    "cat": "ca", "dan": "da", "nor": "no", "slk": "sk", "tgl": "tl",
}


def compute_asr_bleu(audio_wavs: Sequence, refs: Sequence[str], *,
                     transcribe: Optional[Callable[[Sequence], List[str]]] = None,
                     whisper_model_name: Optional[str] = None,
                     lang: str = "eng", normalize: bool = True) -> float:
    """ASR-BLEU: transcribe the speech, then BLEU against the references,
    both sides through Whisper's normalizers. ``whisper_model_name`` (a local
    HF checkpoint) takes precedence over ``transcribe``."""
    if whisper_model_name:
        transcribe = make_whisper_transcriber(whisper_model_name, lang=lang)
    if transcribe is None:
        raise ValueError("need transcribe callable or whisper_model_name")
    hyps = transcribe(audio_wavs)
    if normalize:
        hyps = [whisper_normalize_text(h, lang) for h in hyps]
        refs = [whisper_normalize_text(r, lang) for r in refs]
    return compute_corpus_metric_score(hyps, refs, lang=lang)


def compute_quality_metrics(hyps: Sequence[str], refs: Sequence[str], *,
                            lang: str, task: str, output_path: Optional[str] = None
                            ) -> dict:
    """BLEU and chrF (and WER for ``asr``), written to ``output_path`` as
    JSON where given."""
    out = {"bleu": compute_corpus_metric_score(hyps, refs, lang=lang),
           "chrf": compute_corpus_metric_score(hyps, refs, lang=lang, metric="chrf")}
    if task.upper() == "ASR":
        out["wer"] = compute_asr_error_rate(hyps, refs, lang=lang)
    if output_path:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(out, f, indent=2)
    return out
