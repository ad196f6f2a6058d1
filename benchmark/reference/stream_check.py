"""Streamed sessions against the reference.

For each sampled session the reference works out again, from the chunks
the session was fed, what its encoder had seen at each decision round: the
log-mels its feature agent emitted (``fbank.stream_fbank_frames``), stacked
two frames a row in blocks of 32 frames from the first frame not yet taken
up, a round's last block taken up only once the source has ended (the
streaming agents' schedule). The encoder output of a round is the
chunk-causal encoder's full forward over exactly the rows the round saw,
then the adaptor. Over it, each round the session wrote tokens in is
teacher-forced through the EMMA decoder (``monotonic.round_outputs``).

The pool records, at each of a session's decisions, the statistic it
compared with the threshold, the lead of its best logit over the
runner-up, and the token it wrote (none where it stopped); a round's
decisions run to the first that wrote nothing, or to the most writes a
round may make. Numbers, over every decision of the sampled sessions:

- ``logit_gap``: the widest distance by which a written token's logit lies
  under the reference's best at that position;
- ``stat_gap``: the widest distance between the statistic as decided and
  as the reference computes it, in log-odds (the statistic is a sigmoid of
  the energies over a temperature of 0.2);
- ``lead_gap``: the widest distance between the lead of the best logit
  over the runner-up as decided and as the reference computes it.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from reference import fbank as fb
from reference import monotonic, speech_encoder
from reference.nn import Quant, set_tf32

BLOCK = 32
MISFIT = 1e9      # the gaps of a session whose decisions do not fit its rounds


def rounds(session: dict, enc: dict, policy: dict) -> List[dict]:
    """Every decision round of one session, in order, each with the fbank
    rows its encoder had seen (an (rows, 160) array), whether its source
    had ended, and whether a full chunk-causal forward over those rows is
    what the incremental encoder computes (``exact``): not once a block
    shorter than 32 frames was taken up at the source's end and the drain
    fed more blocks after it, since the program then carries a convolution
    tail fed by the short block's padding (``incremental.py``: a partial
    block is for a stream's last step only). ``session["ticks"]``: one
    entry a pool step at which the session's feature agent ran,
    {"pushed": bool, ...}."""
    stride = enc["fbank_stride"]
    chunks = session["chunks"]
    consumed, rows, out, padded_tail = 0, [], [], False
    n_pushed = n_drain = 0
    source_done = False
    for tick in session["ticks"]:
        if tick["pushed"]:
            n_pushed += 1
            source_done = n_pushed == len(chunks)
        else:
            n_drain += 1
        frames = fb.stream_fbank_frames(chunks[:n_pushed], n_drain)
        total = frames.shape[0]
        if total < policy["min_starting_wait"] and not source_done:
            continue
        if total < policy["min_input_length"]:
            continue
        pending = total - consumed
        n_full, partial = divmod(pending, BLOCK)
        if partial == 0 and n_full == 0 and not source_done:
            continue
        exact = not (padded_tail and pending > 0)
        for _ in range(n_full if partial else max(n_full - 1, 0)):
            rows.append(frames[consumed:consumed + BLOCK].reshape(-1, 80 * stride))
            consumed += BLOCK
        seen = rows
        if partial:
            blk = frames[consumed:consumed + partial]
            dec = blk[:(partial // stride) * stride].reshape(-1, 80 * stride)
            seen = rows + [dec]
            if source_done:
                rows.append(dec)
                consumed += partial
                padded_tail = True
        elif n_full:
            rows.append(frames[consumed:consumed + BLOCK].reshape(-1, 80 * stride))
            consumed += BLOCK
        out.append({"rows": np.concatenate(seen), "source_finished": source_done,
                    "exact": exact})
    return out


def split_decisions(decisions: list, n_rounds: int, max_writes: int) -> List[list]:
    """A session's decisions (statistic, lead, token or None) cut into its
    rounds."""
    out, i = [], 0
    for _ in range(n_rounds):
        r = []
        while i < len(decisions):
            d = decisions[i]
            r.append(d)
            i += 1
            if d[2] is None or len(r) >= max_writes:
                break
        out.append(r)
    if i != len(decisions):
        raise ValueError(f"{len(decisions)} decisions, {i} of them in {n_rounds} rounds")
    return out


def _round(raw: dict, cfg: dict, qt: Quant, rows: np.ndarray, seq: list, n_ctx: int,
           device):
    """One round's (logits, statistics, leads) a position; ``qt`` the EMMA
    decoder's int8 weights."""
    enc_cfg = cfg["speech_encoder"]
    q_enc = Quant(None)
    sdt = getattr(torch, cfg["stream_state_dtype"])
    fbank = torch.as_tensor(rows.reshape(-1, 80), device=device)
    enc = speech_encoder.adaptor(q_enc, raw["speech_encoder"], enc_cfg,
                                 speech_encoder.conformer(q_enc, raw["speech_encoder"],
                                                          enc_cfg, fbank, sdt))
    logits, stat = monotonic.round_outputs(qt, raw["monotonic_decoder"],
                                           cfg["monotonic_decoder"], enc,
                                           torch.as_tensor(seq, device=device), n_ctx)
    top2 = torch.topk(logits, 2, dim=-1).values
    return logits.double(), stat.double(), (top2[:, 0] - top2[:, 1]).double()


def _log_odds(p: float) -> float:
    p = min(max(p, 1e-37), 1.0 - 1e-7)
    return math.log(p) - math.log1p(-p)


def check(raw: dict, cfg: dict, policy: dict, sessions: List[dict], device
          ) -> Dict[str, float]:
    """``policy``: the pool's settings (min_starting_wait, min_input_length,
    max_consecutive_writes) and the prefix ``[eos, lang]`` under "prefix";
    each session its ``chunks``, ``ticks`` and ``decisions``. Returns the
    three gaps, the counts of decisions and tokens compared and of the
    decisions in rounds that are not ``exact`` (skipped)."""
    set_tf32(False)
    qt = Quant(cfg.get("quantize"))
    names = ("logit_gap", "stat_gap", "lead_gap")
    gaps = {n: 0.0 for n in names}

    def widen(name: str, value: float) -> None:
        gaps[name] = max(gaps[name], value)

    n_dec = n_tokens = n_skipped = 0
    with torch.inference_mode():
        for s in sessions:
            target = list(s["prefix"])
            rs = rounds(s, cfg["speech_encoder"], policy)
            try:
                cut = split_decisions(s["decisions"], len(rs),
                                      policy["max_consecutive_writes"])
            except ValueError:
                # the decisions do not fit the rounds the schedule gives
                for n in names:
                    widen(n, MISFIT)
                continue
            for r, decs in zip(rs, cut):
                toks = [d[2] for d in decs if d[2] is not None]
                n_ctx, seq = len(target), target + toks
                if not r["exact"]:
                    target += toks
                    n_skipped += len(decs)
                    continue
                lg, st, lead = _round(raw, cfg, qt, r["rows"], seq, n_ctx, device)
                best = lg.max(dim=-1).values
                for j, (stat, gap, tok) in enumerate(decs):
                    pos = n_ctx - 1 + j
                    widen("stat_gap", abs(_log_odds(stat) - _log_odds(float(st[pos]))))
                    widen("lead_gap", abs(gap - float(lead[pos])))
                    if tok is not None:
                        widen("logit_gap", float(best[pos] - lg[pos, tok]))
                target += toks
                n_dec += len(decs)
                n_tokens += len(toks)
    return dict(gaps, decisions=n_dec, tokens=n_tokens, skipped=n_skipped)
