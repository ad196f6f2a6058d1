"""Beam search (counterpart of ``beam_search`` in
``seamless_communication_tpu/ops/beam_search.py``), as a Python loop over
decode steps:

  - beam size K, 2K candidates per step;
  - prefix forcing (the target-language control tokens);
  - length penalty: a finalized score is sum_lprob / ((len + 1) ** len_penalty);
  - unk penalty, minimum generation length, EOS forced at the hard maximum;
  - only EOS candidates ranked within the top K finalize;
  - step processors (n-gram repeat block, banned sequences):
    ``(tokens, step, lprobs) -> lprobs`` functions, applied after the
    log-softmax and before the unk and EOS edits;
  - early stop once no live beam can beat the worst finalized hypothesis.

The decoder is ``step_fn(tok_t, cache, step) -> (logits, cache)`` over the
flattened (B*K) batch. The beam reorder of each selection is handed to the
next call as ``step_fn(tok_t, cache, step, beam_src)``, ``beam_src`` the
(B*K,) beam origins, and the step reads the cache through it. With
``cache_reorder`` the search applies ``cache_reorder(cache, flat_src)``
after each selection instead and calls ``step_fn(tok_t, cache, step)``.
Ties rank the lower index first, as ``jax.lax.top_k`` does.

In candidate mode the step returns each beam's top-C candidates instead of
the full-vocabulary logits (``models/nllb/model.py text_decoder_step_topk``,
the fused vocabulary kernel on the card).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from seamless_communication_torch.ops.topk import top_k
from seamless_communication_torch.utils.profiling import TRACER

NEG_INF = -1e9


class BeamSearchOptions(NamedTuple):
    beam_size: int = 5
    max_len: int = 256            # hard cap incl. prefix
    min_len: int = 1              # min generated tokens before EOS allowed
    len_penalty: float = 1.0
    unk_penalty: float = 0.0
    pad_idx: int = 0
    unk_idx: int = 1
    bos_idx: int = 2
    eos_idx: int = 3


class BeamSearchResult(NamedTuple):
    tokens: torch.Tensor   # (B, K, T_max) best-first finalized hypotheses
    scores: torch.Tensor   # (B, K) normalized scores (NEG_INF = empty slot)
    lengths: torch.Tensor  # (B, K) hypothesis lengths incl. prefix and EOS
    steps: int             # number of decode steps run


def beam_search(step_fn: Callable, cache, prefix: torch.Tensor,
                prefix_len: torch.Tensor, opts: BeamSearchOptions,
                vocab_size: int, *, processors: Sequence[Callable] = (),
                cache_reorder: Optional[Callable] = None,
                candidate_mode: bool = False) -> BeamSearchResult:
    """``prefix``: (B, P) forced target prefix (e.g. [eos, lang]);
    ``prefix_len``: (B,) its lengths. ``cache``: the decoder cache for the
    B*K beams.

    ``processors``: step processors ``proc(tokens (B, K, T), step, lprobs
    (B, K, V)) -> lprobs``. ``cache_reorder``: reorders the cache after
    each selection, in place of handing ``beam_src`` to ``step_fn`` (see the
    module).

    ``candidate_mode``: ``step_fn`` returns ``(cand_lprobs (B*K, C), cand_idx
    (B*K, C), cache)``, each beam's top-C log-probabilities and their ids.
    Exact for C >= 2K+1 with ``unk_penalty == 0`` and no step processors:
    every global top-2K continuation is within its beam's top 2K+1, even
    after min-length EOS suppression removes one candidate. Takes no
    ``cache_reorder``."""
    if candidate_mode and opts.unk_penalty != 0.0:
        raise ValueError("candidate_mode is exact only with unk_penalty == 0")
    if candidate_mode and (cache_reorder is not None or processors):
        raise ValueError("candidate_mode takes no cache_reorder and no step processors")
    B, P = prefix.shape
    K, T, V = opts.beam_size, opts.max_len, vocab_size
    dev = prefix.device
    prefix = prefix.long()
    plen = prefix_len.long()[:, None]                                  # (B, 1)
    max_prefix = int(prefix_len.max())

    tokens = torch.full((B, K, T), opts.pad_idx, dtype=torch.long, device=dev)
    tokens[:, :, :P] = prefix[:, None, :]
    # beams 1..K-1 start dead so the first expansion comes from beam 0 only
    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    fin_tokens = torch.full((B, K, T), opts.pad_idx, dtype=torch.long, device=dev)
    fin_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    fin_lengths = torch.zeros((B, K), dtype=torch.long, device=dev)
    pending_src = torch.arange(B * K, dtype=torch.int32, device=dev)
    pos = torch.arange(T, device=dev)
    rank = torch.arange(2 * K, device=dev)[None, :]

    def normalize(score_sum, length):
        return score_sum / torch.pow(length.float() + 1.0, opts.len_penalty)

    step = 0
    while step < T - 1:
        # a "beam.step" span a pass of the loop (the last may only find that
        # the search stops), its two host reads "beam.sync" spans under it
        tracing = TRACER.on
        if tracing:
            span = TRACER.begin("beam.step")
        # stop once no live beam's best reachable score beats the worst final
        best_cont = normalize(scores.amax(dim=1), torch.full((B,), T, device=dev))
        done = ((fin_scores > NEG_INF / 2).all(dim=1)
                & (fin_scores.amin(dim=1) >= best_cont))
        if tracing:
            sync = TRACER.begin("beam.sync")
        stop = bool(done.all())
        if tracing:
            TRACER.end(sync)
        if stop:
            if tracing:
                TRACER.end(span)
            break

        gen_pos = step + 1                                             # position filled now
        in_prefix = gen_pos < plen                                     # (B, 1)
        eos_banned = (gen_pos - plen) < opts.min_len                   # (B, 1)
        force_eos = gen_pos >= T - 1

        tok_t = tokens[:, :, step].reshape(B * K, 1)
        if candidate_mode:
            cand_lp, cand_ix, cache = step_fn(tok_t, cache, step, pending_src)
            C = cand_lp.shape[-1]
            lp = cand_lp.float().reshape(B, K, C)
            ix = cand_ix.long().reshape(B, K, C)
            # min-length EOS suppression on the candidate ids
            lp = torch.where((ix == opts.eos_idx) & eos_banned[:, :, None], NEG_INF, lp)
            if gen_pos < max_prefix or force_eos:
                # prefix and hard-max forcing replace the candidate set outright
                ftok = (torch.full_like(prefix[:, :1], opts.eos_idx) if force_eos
                        else prefix[:, min(gen_pos, P - 1)][:, None])      # (B, 1)
                first = torch.arange(C, device=dev)[None, None, :] == 0
                use = in_prefix[:, :, None] | force_eos
                lp = torch.where(use, torch.where(first, 0.0, NEG_INF), lp)
                ix = torch.where(use, ftok[:, :, None].expand(B, K, C), ix)
            # dead beams must not spawn candidates
            cand = (scores[:, :, None] + lp).reshape(B, K * C)
            top_scores, sel = top_k(cand, 2 * K)                           # (B, 2K)
            src_beam = torch.div(sel, C, rounding_mode="floor")
            tok = torch.gather(ix.reshape(B, K * C), 1, sel)
        else:
            if cache_reorder is None:
                logits, cache = step_fn(tok_t, cache, step, pending_src)
            else:
                logits, cache = step_fn(tok_t, cache, step)
            lprobs = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
            for proc in processors:
                lprobs = proc(tokens, step, lprobs)
            lprobs[:, :, opts.unk_idx] -= opts.unk_penalty
            lprobs[:, :, opts.eos_idx] = torch.where(
                eos_banned, NEG_INF, lprobs[:, :, opts.eos_idx])
            if gen_pos < max_prefix or force_eos:
                if force_eos:
                    lprobs = torch.full_like(lprobs, NEG_INF)
                    lprobs[:, :, opts.eos_idx] = 0.0
                nxt = prefix[:, min(gen_pos, P - 1)][:, None]           # (B, 1)
                forced = torch.where(torch.arange(V, device=dev)[None, None, :]
                                     == nxt[:, :, None], 0.0, NEG_INF)
                lprobs = torch.where(in_prefix[:, :, None], forced, lprobs)

            # dead beams must not spawn candidates
            cand = (scores[:, :, None] + lprobs).reshape(B, K * V)
            top_scores, top_idx = top_k(cand, 2 * K)                   # (B, 2K)
            src_beam = torch.div(top_idx, V, rounding_mode="floor")
            tok = top_idx % V
        is_eos = ((tok == opts.eos_idx) & ~in_prefix
                  & (top_scores > NEG_INF / 2))
        # only EOS candidates ranked within the top K finalize
        fin_eos = is_eos & (rank < K)

        hyp_len = gen_pos + 1                                          # incl. EOS
        pos_is_gen = pos[None, None, :] == gen_pos
        if tracing:
            sync = TRACER.begin("beam.sync")
        any_eos = bool(fin_eos.any())
        if tracing:
            TRACER.end(sync)
        if any_eos:
            norm_eos = torch.where(
                fin_eos, normalize(top_scores, torch.full_like(top_scores, hyp_len)),
                NEG_INF)
            parent = torch.gather(tokens, 1, src_beam[:, :, None].expand(B, 2 * K, T))
            eos_tokens = torch.where(pos_is_gen, opts.eos_idx, parent)
            all_scores = torch.cat([fin_scores, norm_eos], dim=1)
            all_tokens = torch.cat([fin_tokens, eos_tokens], dim=1)
            all_lengths = torch.cat(
                [fin_lengths, torch.full((B, 2 * K), hyp_len, device=dev)], dim=1)
            fin_scores, f_sel = top_k(all_scores, K)
            fin_tokens = torch.gather(all_tokens, 1, f_sel[:, :, None].expand(B, K, T))
            fin_lengths = torch.gather(all_lengths, 1, f_sel)

        # pick K continuing (non-EOS) beams
        scores, cont_sel = top_k(torch.where(is_eos, NEG_INF, top_scores), K)
        new_src = torch.gather(src_beam, 1, cont_sel)
        new_tok = torch.gather(tok, 1, cont_sel)
        tokens = torch.gather(tokens, 1, new_src[:, :, None].expand(B, K, T))
        tokens = torch.where(pos_is_gen, new_tok[:, :, None], tokens)
        pending_src = (torch.arange(B, device=dev)[:, None] * K + new_src
                       ).reshape(B * K).to(torch.int32)
        if cache_reorder is not None:
            cache = cache_reorder(cache, pending_src)
        step += 1
        if tracing:
            TRACER.count("beam.steps")
            TRACER.end(span)

    # rows that never finalized K hypotheses fall back to live beams
    live_norm = scores / torch.pow(torch.tensor(step + 1.0, device=dev) + 1.0,
                                   opts.len_penalty)
    need_fill = fin_scores <= NEG_INF / 2
    fin_scores = torch.where(need_fill, live_norm, fin_scores)
    fin_tokens = torch.where(need_fill[:, :, None], tokens, fin_tokens)
    fin_lengths = torch.where(need_fill, step + 1, fin_lengths)
    order = torch.argsort(-fin_scores, dim=1, stable=True)
    return BeamSearchResult(
        tokens=torch.gather(fin_tokens, 1, order[:, :, None].expand(B, K, T)),
        scores=torch.gather(fin_scores, 1, order),
        lengths=torch.gather(fin_lengths, 1, order),
        steps=step)


# ---------------------------------------------------------------------------
# Step processors
# ---------------------------------------------------------------------------

def make_ngram_repeat_block(ngram_size: int, vocab_size: int) -> Callable:
    """Ban each token that would complete an n-gram already in the beam's
    tokens (positions 0..step, the prefix included)."""
    n = ngram_size

    def proc(tokens: torch.Tensor, step: int, lprobs: torch.Tensor) -> torch.Tensor:
        if n <= 1 or step < n - 1:
            return lprobs
        # every n-gram starting at p <= step - n + 1: (B, K, P, n)
        grams = tokens[:, :, :step + 1].unfold(2, n, 1)
        ctx = tokens[:, :, step - n + 2:step + 1]                     # (B, K, n-1)
        match = (grams[..., :-1] == ctx[:, :, None, :]).all(dim=-1)   # (B, K, P)
        hits = torch.zeros(lprobs.shape, dtype=torch.float32, device=lprobs.device)
        hits.scatter_add_(2, grams[..., -1], match.float())
        return torch.where(hits > 0, NEG_INF, lprobs)

    return proc


def make_banned_sequence_processor(banned: torch.Tensor, banned_lens: torch.Tensor,
                                   vocab_size: int) -> Callable:
    """MinTox's banned-sequence processor: ban the last token of each banned
    sequence whose other tokens are the beam's last ones (a 1-token sequence
    is always banned). ``banned`` (N, M) with ``banned_lens`` (N,): row n
    is read as the sequence ``banned[n, :banned_lens[n]]``, as the JAX
    package reads it (its MinTox aligns rows right, padded with -1 on the
    left; then a row shorter than M bans nothing it means to)."""
    banned = banned.long()
    lens = banned_lens.long()
    N, M = banned.shape
    dev = banned.device
    plen = lens - 1
    j = torch.arange(M - 1, device=dev)[None, :]                      # (1, M-1)
    off = (M - 1 - plen)[:, None]                                     # (N, 1)
    cmp = j >= off                                                    # (N, M-1)
    prefix = torch.where(cmp, banned.gather(1, (j - off).clamp(0, M - 1)), -2)
    last = banned.gather(1, (lens - 1).clamp(0, M - 1)[:, None])[:, 0]  # (N,)
    hit = (last >= 0) & (last < vocab_size)                # others ban nothing

    def proc(tokens: torch.Tensor, step: int, lprobs: torch.Tensor) -> torch.Tensor:
        T = tokens.shape[2]
        w_idx = torch.arange(step - M + 2, step + 1, device=tokens.device)  # (M-1,)
        window = tokens[:, :, w_idx.clamp(0, T - 1)]                  # (B, K, M-1)
        ok = (window[:, :, None, :] == prefix.to(tokens.device)) & (w_idx >= 0)
        ok = torch.where(cmp.to(tokens.device), ok, True)             # (B, K, N, M-1)
        matched = ok.all(dim=-1) | (plen == 0).to(tokens.device)      # (B, K, N)
        hits = torch.zeros(lprobs.shape, dtype=torch.float32, device=lprobs.device)
        hits.index_add_(2, last[hit].to(lprobs.device),
                        matched[:, :, hit.to(matched.device)].float())
        return torch.where(hits > 0, NEG_INF, lprobs)

    return proc
