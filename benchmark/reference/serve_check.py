"""The served requests against the reference: for each sampled request,
the encoder over its own audio, then each of the beam's finished
hypotheses teacher-forced through the decoder. Two numbers:

- ``score_gap``: each hypothesis scored as the beam search scores it (the
  log-probabilities of the tokens it chose, the forced prefix and an end of
  sentence forced at the length limit counting 0, summed and divided by
  (length + 1) ** len_penalty); the widest distance between a score as
  served and as the reference computes it;
- ``rank_gap``: at each position a hypothesis chose a token, the beam
  keeps the 2K best continuations over its K beams, so the token is among
  the 2K + 1 best of its own beam's next-token distribution (one more for
  an end of sentence held back before the minimum length); the widest
  distance by which a chosen token's reference log-probability lies under
  the reference's (2K + 1)-th best there, 0 where it is among them. A beam
  that keeps a worse candidate, or takes a row's wrong candidate while
  reporting that token's own score, is self-consistent in its scores and
  is seen here."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from reference import fbank as fb
from reference import nllb_decoder, speech_encoder
from reference.nn import Quant, set_tf32


def chosen(hyps: np.ndarray, lengths: np.ndarray, T: int, eos: int, prefix: int
           ) -> List[np.ndarray]:
    """For each hypothesis (K, L) the positions whose next token the beam
    chose: past the forced prefix, and short of an end of sentence forced
    at the length limit."""
    out = []
    for k in range(hyps.shape[0]):
        n = int(lengths[k])
        last = n - 1 if n == T and int(hyps[k, n - 1]) == eos else n
        out.append(np.arange(prefix - 1, last - 1))
    return out


def hypothesis_scores(lp: torch.Tensor, hyps: np.ndarray, lengths: np.ndarray,
                      pos: List[np.ndarray], len_penalty: float) -> np.ndarray:
    """``lp``: (K, L, V) log-probabilities of the next token at each
    position of the hypotheses ``hyps`` (K, L) -> (K,) scores over the
    chosen positions ``pos``."""
    out = []
    for k in range(hyps.shape[0]):
        p = torch.as_tensor(pos[k], device=lp.device)
        tok = torch.as_tensor(hyps[k], device=lp.device)[p + 1]
        per = lp[k, p].gather(1, tok[:, None])[:, 0].double()
        out.append(float(per.sum()) / (int(lengths[k]) + 1.0) ** len_penalty)
    return np.asarray(out)


def rank_gaps(lp: torch.Tensor, hyps: np.ndarray, pos: List[np.ndarray], beam: int
              ) -> float:
    """The widest distance by which a chosen token's log-probability lies
    under the (2K + 1)-th best of its position, 0 where none does."""
    widest = 0.0
    for k in range(hyps.shape[0]):
        if not len(pos[k]):
            continue
        p = torch.as_tensor(pos[k], device=lp.device)
        tok = torch.as_tensor(hyps[k], device=lp.device)[p + 1]
        rows = lp[k, p]
        floor = torch.topk(rows, 2 * beam + 1, dim=-1).values[:, -1]
        widest = max(widest, float((floor - rows.gather(1, tok[:, None])[:, 0]).max()))
    return max(widest, 0.0)


def check(raw: dict, cfg: dict, samples: List[dict], device) -> Dict[str, float]:
    """``samples``: dicts with the request's ``wav`` and the program's
    ``tokens`` (K, T), ``lengths`` (K,), ``scores`` (K,) and ``T``.
    Returns {"score_gap", "rank_gap", "hypotheses", "tokens", "gaps": every
    hypothesis's score distance}."""
    set_tf32(False)
    enc_cfg, dec = cfg["speech_encoder"], cfg["text_decoder"]
    qt = Quant(cfg.get("quantize"))
    int8_kv = cfg.get("kv_cache", {}).get("bits") == 8
    gaps, rank, tokens = [], 0.0, 0
    with torch.inference_mode():
        for s in samples:
            f = fb.fbank(s["wav"], 2.0 ** 15)
            if enc_cfg.get("normalize_fbank") == "utterance":
                f = fb.normalize_utterance(f)
            enc = speech_encoder.encode(qt, raw["speech_encoder"], enc_cfg,
                                        torch.as_tensor(f, device=device))
            kv = nllb_decoder.cross_kv(qt, raw["text_decoder"]["stack"]["layers"], enc,
                                       dec["num_heads"], int8_kv)
            hyps, lengths = np.asarray(s["tokens"]), np.asarray(s["lengths"])
            L = int(lengths.max())
            logits = nllb_decoder.logits(qt, raw["text_decoder"], dec,
                                         torch.as_tensor(hyps[:, :L], device=device),
                                         kv, int8_kv)
            lp = torch.log_softmax(logits, dim=-1)
            del logits
            pos = chosen(hyps, lengths, s["T"], dec["eos_idx"], 2)
            ref = hypothesis_scores(lp, hyps, lengths, pos, cfg.get("len_penalty", 1.0))
            gaps += list(np.abs(ref - np.asarray(s["scores"], np.float64)))
            rank = max(rank, rank_gaps(lp, hyps, pos, cfg["beam_size"]))
            tokens += sum(len(p) for p in pos)
            del lp, kv, enc
    return {"score_gap": float(max(gaps, default=0.0)), "rank_gap": rank,
            "hypotheses": len(gaps), "tokens": tokens, "gaps": gaps}
