"""EMMA monotonic text decoder of SeamlessStreaming (counterpart of
``seamless_communication_tpu/models/monotonic/model.py``).

dense_1b: 24 pre-LN layers (self-attention, cross-attention beside the
PChoose layer, ffn 8192), energy bias -0.5, monotonic temperature 0.2, 4-layer
ReLU energy MLPs, keys average-pooled by ``pre_decision_ratio`` = 2. The
streaming policy reads p_choose of every layer and head, stacked as
(B, L * H, Sp).

The decode keeps an fp KV cache (``MonotonicCache``): the self-attention
caches are (L, B, H, T_max, Dh) tensors whose row ``step`` each step writes in
place, the cross-attention K/V are projected once per encoder output. The
write burst is an eager loop that stops at the first token it does not write;
the JAX package's ``lax.while_loop`` computes that one more step and discards
it, so both return the same tokens, features, counts and cache. The batched
streaming pool runs the burst for several sessions at once
(``monotonic_write_burst_rows``): each row has its own step, context, valid
keys and limits, as JAX's ``vmap`` over the session axis gives each.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import torch

from seamless_communication_torch.ops import attention as attn_ops
from seamless_communication_torch.ops.attention import KVCache
from seamless_communication_torch.ops.masks import causal_mask, padding_bias
from seamless_communication_torch.ops.modules import (
    embedding_init, layer_norm, layer_norm_init, linear, linear_init, true_div,
)
from seamless_communication_torch.ops.transformer import (
    TransformerConfig, embedding_frontend, tied_projection,
)
from seamless_communication_torch.utils.profiling import TRACER


class MonotonicDecoderConfig(NamedTuple):
    model_dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_inner_dim: int = 8192
    vocab_size: int = 256102
    pad_idx: int = 0
    eos_idx: int = 3
    unk_idx: int = 1
    max_seq_len: int = 4096
    energy_bias: float = -0.5
    monotonic_temperature: float = 0.2
    num_monotonic_energy_layers: int = 4
    pre_decision_ratio: int = 2

    def dec_cfg(self) -> TransformerConfig:
        return TransformerConfig(self.model_dim, self.num_layers, self.num_heads,
                                 self.ffn_inner_dim, "relu", self.vocab_size,
                                 self.pad_idx, self.max_seq_len, True)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: MonotonicDecoderConfig, kw) -> dict:
    d, n = cfg.model_dim, cfg.num_monotonic_energy_layers
    return {
        "self_attn_layer_norm": layer_norm_init(d, **kw),
        "self_attn": attn_ops.mha_init(gen, d, cfg.num_heads, **kw),
        "cross_attn_layer_norm": layer_norm_init(d, **kw),
        "cross_attn": attn_ops.mha_init(gen, d, cfg.num_heads, **kw),
        "p_choose": {
            "energy_bias": torch.full((1,), cfg.energy_bias, **kw),
            "q_energy_proj": [linear_init(gen, d, d, **kw) for _ in range(n)],
            "k_energy_proj": [linear_init(gen, d, d, **kw) for _ in range(n)],
        },
        "ffn": {"layer_norm": layer_norm_init(d, **kw),
                "inner_proj": linear_init(gen, d, cfg.ffn_inner_dim, **kw),
                "output_proj": linear_init(gen, cfg.ffn_inner_dim, d, **kw)},
    }


def monotonic_decoder_init(gen: torch.Generator, cfg: MonotonicDecoderConfig, *,
                           dtype=torch.float32, device=None) -> dict:
    """Random parameters drawn from ``gen`` (which must live on ``device``):
    ``{"embed", "layers": [per-layer dicts], "layer_norm"}``; the embedding is
    tied to the output projection."""
    kw = dict(dtype=dtype, device=device)
    return {"layers": [_layer_init(gen, cfg, kw) for _ in range(cfg.num_layers)],
            "embed": embedding_init(gen, cfg.vocab_size, cfg.model_dim, **kw),
            "layer_norm": layer_norm_init(cfg.model_dim, **kw)}


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def _energy_proj(layers: list, x: torch.Tensor) -> torch.Tensor:
    for p in layers:
        x = torch.relu(linear(p, x))
    return x


def pool_keys(enc_out: torch.Tensor, ratio: int) -> torch.Tensor:
    """Average-pool (B, S, D) encoder keys by ``ratio`` in ceil mode: the last
    window is divided by the number of frames it holds."""
    B, S, D = enc_out.shape
    pad = (-S) % ratio
    x = torch.nn.functional.pad(enc_out, (0, 0, 0, pad)).reshape(B, -1, ratio, D)
    counts = torch.clamp_max(S - torch.arange(x.shape[1], device=x.device) * ratio, ratio)
    return x.sum(dim=2) / counts[None, :, None].to(x.dtype)


def key_energy(params: dict, pooled_keys: torch.Tensor,
               cfg: MonotonicDecoderConfig) -> torch.Tensor:
    """The key half of ``p_choose``: (B, Sp, D) pooled keys -> (B, H, Sp, Dh)
    energies. It depends on the encoder output alone, so the cache holds it."""
    k = _energy_proj(params["k_energy_proj"], pooled_keys)
    return attn_ops._split_heads(k, cfg.num_heads)


def p_choose(params: dict, seqs: torch.Tensor, pooled_keys: Optional[torch.Tensor],
             cfg: MonotonicDecoderConfig, *,
             k_energy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, D) queries x (B, Sp, D) pooled keys -> (B, H, S, Sp) fp32
    probabilities sigmoid((q . k / sqrt(Dh) + energy_bias) / temperature).
    ``k_energy``: ``key_energy`` of the pooled keys, computed already."""
    qh = attn_ops._split_heads(_energy_proj(params["q_energy_proj"], seqs), cfg.num_heads)
    kh = key_energy(params, pooled_keys, cfg) if k_energy is None else k_energy
    dh = qh.shape[-1]
    energy = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * (dh ** -0.5)
    energy = energy + params["energy_bias"].float()
    return torch.sigmoid(true_div(energy, cfg.monotonic_temperature))


def decision_stat(pcs: torch.Tensor, cfg: MonotonicDecoderConfig, *, start_layer: int,
                  sp_valid: Union[int, Sequence[int], torch.Tensor],
                  method: str) -> torch.Tensor:
    """The policy's statistic of (B, L * H, Sp) p_choose, row by row:
    ``method`` ("min", "mean" or "median") over the heads of the layers from
    ``start_layer`` at each row's last valid pooled key ``sp_valid - 1``
    (one int, or one a row) -> (B,) fp32. An even count's median is the
    mean of its two middle values, as numpy's and jnp's (``torch.median``
    would take the lower one)."""
    B = pcs.shape[0]
    pl = pcs.reshape(B, cfg.num_layers, cfg.num_heads, -1)[:, start_layer:]
    if isinstance(sp_valid, int):
        last = pl[..., sp_valid - 1]                                    # (B, L', H)
    else:
        idx = torch.as_tensor(sp_valid, device=pcs.device) - 1
        last = torch.gather(pl, 3, idx.view(B, 1, 1, 1).expand(*pl.shape[:3], 1))[..., 0]
    if method == "min":
        return last.amin(dim=(1, 2))
    if method == "mean":
        return last.mean(dim=(1, 2))
    flat = torch.sort(last.reshape(B, -1), dim=1).values
    n = flat.shape[1]
    return (flat[:, (n - 1) // 2] + flat[:, n // 2]) * 0.5


# ---------------------------------------------------------------------------
# KV-cached decode step
# ---------------------------------------------------------------------------

class MonotonicCache(NamedTuple):
    self_k: torch.Tensor    # (L, B, H, T_max, Dh)
    self_v: torch.Tensor
    cross_k: torch.Tensor   # (L, B, H, S, Dh)
    cross_v: torch.Tensor
    pooled_keys: torch.Tensor   # (B, Sp, D) pooled encoder output (for p_choose)
    k_energy: tuple         # L x (B, H, Sp, Dh): key_energy of each layer


def monotonic_decoder_cache(params: dict, cfg: MonotonicDecoderConfig,
                            enc_out: torch.Tensor, max_len: int) -> MonotonicCache:
    """Empty self-attention caches of ``max_len`` rows in the encoder output's
    dtype, the cross-attention K/V of every layer and the pooled keys."""
    B = enc_out.shape[0]
    H, Dh = cfg.num_heads, cfg.model_dim // cfg.num_heads
    kvs = [attn_ops.cross_attention_precompute(p["cross_attn"], enc_out, H)
           for p in params["layers"]]
    pooled = pool_keys(enc_out, cfg.pre_decision_ratio)
    shape = (cfg.num_layers, B, H, max_len, Dh)
    zeros = dict(dtype=enc_out.dtype, device=enc_out.device)
    return MonotonicCache(torch.zeros(shape, **zeros), torch.zeros(shape, **zeros),
                          torch.stack([kv.k for kv in kvs]),
                          torch.stack([kv.v for kv in kvs]), pooled,
                          tuple(key_energy(p["p_choose"], pooled, cfg)
                                for p in params["layers"]))


def monotonic_decode_step(params: dict, tok_t: torch.Tensor, cache: MonotonicCache,
                          step: Union[int, torch.Tensor], cfg: MonotonicDecoderConfig, *,
                          enc_padding_mask: Optional[torch.Tensor] = None):
    """One step: tok_t (B, 1) -> ((B, V) fp32 logits, (B, 1, D) features,
    (B, L * H, Sp) p_choose, cache). The features feed the NAR T2U. Row
    ``step`` of the self-attention caches is written in place (the cache
    returned is the one given); ``step`` is one int, or a (B,) tensor of
    each row's own step (the batched write burst)."""
    x = embedding_frontend(params["embed"], tok_t, cfg.dec_cfg(), start_step=step)
    if isinstance(step, torch.Tensor):
        step = step.to(x.device)
        rows = torch.arange(x.shape[0], device=x.device)
    cross_bias = padding_bias(enc_padding_mask)
    pcs = []
    for i, layer in enumerate(params["layers"]):
        z = layer_norm(layer["self_attn_layer_norm"], x)
        y, k_t, v_t = attn_ops.self_attention_step_nocache(
            layer["self_attn"], z, cache.self_k[i], cache.self_v[i], step, cfg.num_heads)
        x = x + y
        z = layer_norm(layer["cross_attn_layer_norm"], x)
        pcs.append(p_choose(layer["p_choose"], z, None, cfg,
                            k_energy=cache.k_energy[i])[:, :, 0, :])
        x = x + attn_ops.cross_attention_step(
            layer["cross_attn"], z, KVCache(cache.cross_k[i], cache.cross_v[i]),
            cfg.num_heads, bias=cross_bias)
        z = layer_norm(layer["ffn"]["layer_norm"], x)
        z = torch.relu(linear(layer["ffn"]["inner_proj"], z))
        x = x + linear(layer["ffn"]["output_proj"], z)
        if isinstance(step, torch.Tensor):
            cache.self_k[i][rows, :, step] = k_t[:, :, 0].to(cache.self_k.dtype)
            cache.self_v[i][rows, :, step] = v_t[:, :, 0].to(cache.self_v.dtype)
        else:
            cache.self_k[i, :, :, step] = k_t[:, :, 0].to(cache.self_k.dtype)
            cache.self_v[i, :, :, step] = v_t[:, :, 0].to(cache.self_v.dtype)
    out = layer_norm(params["layer_norm"], x)
    logits = tied_projection(params["embed"], out)[:, 0]
    return logits, out, torch.cat(pcs, dim=1), cache


class WriteBurst(NamedTuple):
    tokens: list            # the written token ids
    features: torch.Tensor  # (n_written, D) fp32 decoder features, one a token
    finished: bool
    cache: MonotonicCache
    stats: list             # the decision statistic at each decision (floats)
    gaps: Optional[list] = None  # the top-2 logit gap at each decision, if asked for


def _top2_gap(logits: torch.Tensor) -> torch.Tensor:
    """The greedy logit's lead over the runner-up, a row: (..., V) -> (...)."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def monotonic_write_burst(params: dict, cache: MonotonicCache, start_step: int,
                          first_logits: torch.Tensor, first_pcs: torch.Tensor,
                          cfg: MonotonicDecoderConfig, *, decision_threshold: float,
                          decision_method: str, p_choose_start_layer: int,
                          sp_valid: int, eos_idx: int, max_len: int, n_context: int,
                          max_writes: int, source_finished: bool,
                          enc_padding_mask: Optional[torch.Tensor] = None,
                          min_gen_len: int = 0, with_gaps: bool = False) -> WriteBurst:
    """The EMMA write loop from the prefill's last logits and p_choose: write
    the greedy token while the statistic clears ``decision_threshold`` (or the
    source is finished), at most ``max_writes`` tokens; stop on EOS or the
    length limit ``max_len`` (a target length that counts the ``n_context``
    context tokens). ``finished`` is the last decision's EOS / length test
    (False when ``max_writes`` tokens were written). ``min_gen_len`` > 0
    keeps EOS out until that many tokens were generated. ``with_gaps`` also
    records each decision's top-2 logit gap (a measurement's margin)."""
    logits, pcs, step = first_logits, first_pcs, start_step
    tokens, feats, stats = [], [], []
    gaps = [] if with_gaps else None
    finished = False
    while len(tokens) < max_writes:
        total = n_context - 2 + len(tokens)      # generated so far, minus [eos, lang]
        lg = logits[0]
        if min_gen_len > 0 and total < min_gen_len:
            lg = lg.clone()
            lg[eos_idx] = -torch.inf
        index = int(torch.argmax(lg))
        prob = float(decision_stat(pcs, cfg, start_layer=p_choose_start_layer,
                                   sp_valid=sp_valid, method=decision_method))
        stats.append(prob)
        if with_gaps:
            gaps.append(float(_top2_gap(lg)))
        cur_len = n_context + len(tokens)
        finished = (index == eos_idx or cur_len > max_len
                    or (source_finished and cur_len >= max_len))
        if (finished or (not source_finished and prob < decision_threshold)
                or cur_len >= max_len):
            break
        tok = torch.full((1, 1), index, dtype=torch.long, device=logits.device)
        logits, feat, pcs, cache = monotonic_decode_step(
            params, tok, cache, step, cfg, enc_padding_mask=enc_padding_mask)
        tokens.append(index)
        feats.append(feat[0, 0].float())
        step += 1
    D = cfg.model_dim
    features = (torch.stack(feats) if feats
                else torch.zeros((0, D), dtype=torch.float32, device=logits.device))
    return WriteBurst(tokens, features, finished, cache, stats, gaps)


def monotonic_write_burst_rows(params: dict, cache: MonotonicCache,
                               start_step: Sequence[int], first_logits: torch.Tensor,
                               first_pcs: torch.Tensor, cfg: MonotonicDecoderConfig, *,
                               decision_threshold: float, decision_method: str,
                               p_choose_start_layer: int, sp_valid: Sequence[int],
                               eos_idx: int, max_len: Sequence[int],
                               n_context: Sequence[int], max_writes: int,
                               source_finished: Sequence[bool],
                               active: Optional[Sequence[bool]] = None,
                               enc_padding_mask: Optional[torch.Tensor] = None,
                               min_gen_len: int = 0,
                               with_gaps: bool = False) -> List[WriteBurst]:
    """``monotonic_write_burst`` for B rows at once (the streaming pool's
    sessions), each with its own step, context length, valid pooled keys,
    length limit and source state -> one ``WriteBurst`` a row (the cache is
    shared). Each decision brings every row's greedy index and statistic
    (and, ``with_gaps``, its top-2 logit gap) to the host in one copy; one
    decode step runs for all rows while any row writes. A row that has
    stopped (or is not ``active``) runs along, its outputs thrown away: its
    step writes cache row ``start_step + n_written`` again, which no later
    decision of that row reads. A row gives exactly the tokens, ``finished``
    and statistics of ``monotonic_write_burst`` on that row alone."""
    B = first_logits.shape[0]
    dev = first_logits.device
    active = [True] * B if active is None else list(active)
    logits, pcs = first_logits, first_pcs
    steps = list(start_step)
    tokens: List[list] = [[] for _ in range(B)]
    stats: List[list] = [[] for _ in range(B)]
    gaps: List[list] = [[] for _ in range(B)]
    finished = [False] * B
    done = [not a for a in active]
    feats = []
    sp = torch.tensor(list(sp_valid), device=dev)
    while True:
        live = [b for b in range(B) if not done[b] and len(tokens[b]) < max_writes]
        if not live:
            break
        lg = logits
        if min_gen_len > 0:
            # generated so far, minus [eos, lang]
            ban = torch.tensor([n_context[b] - 2 + len(tokens[b]) < min_gen_len
                                for b in range(B)], device=dev)
            lg = lg.clone()
            lg[:, eos_idx] = torch.where(ban, -torch.inf, lg[:, eos_idx])
        per_row = [torch.argmax(lg, dim=-1).double(),
                   decision_stat(pcs, cfg, start_layer=p_choose_start_layer, sp_valid=sp,
                                 method=decision_method).double()]
        if with_gaps:
            per_row.append(_top2_gap(lg).double())
        tracing = TRACER.on
        if tracing:
            sync = TRACER.begin("burst.sync")
        host = torch.stack(per_row).tolist()
        if tracing:
            TRACER.end(sync)
        writes = {}
        for b in live:
            index, prob = int(host[0][b]), host[1][b]
            stats[b].append(prob)
            if with_gaps:
                gaps[b].append(host[2][b])
            cur_len = n_context[b] + len(tokens[b])
            finished[b] = (index == eos_idx or cur_len > max_len[b]
                           or (source_finished[b] and cur_len >= max_len[b]))
            if (finished[b] or (not source_finished[b] and prob < decision_threshold)
                    or cur_len >= max_len[b]):
                done[b] = True
            else:
                writes[b] = index
        if not writes:
            break
        tok = torch.tensor([[writes.get(b, 0)] for b in range(B)], dtype=torch.long,
                           device=dev)
        logits, feat, pcs, cache = monotonic_decode_step(
            params, tok, cache, torch.tensor(steps, device=dev), cfg,
            enc_padding_mask=enc_padding_mask)
        if tracing:
            # every row runs the step; the rows in writes write a token
            TRACER.count("burst.decode_steps")
            TRACER.count("burst.row_steps", B)
            TRACER.count("burst.writes", len(writes))
        feats.append(feat[:, 0].float())
        for b, index in writes.items():
            tokens[b].append(index)
            steps[b] += 1
    out = []
    for b in range(B):
        n = len(tokens[b])
        features = (torch.stack([f[b] for f in feats[:n]]) if n
                    else torch.zeros((0, cfg.model_dim), dtype=torch.float32, device=dev))
        out.append(WriteBurst(tokens[b], features, finished[b], cache, stats[b],
                              gaps[b] if with_gaps else None))
    return out


def monotonic_encode_and_prefill(params: dict, tokens: torch.Tensor,
                                 n_tokens: Union[int, Sequence[int]],
                                 enc_out: torch.Tensor, max_len: int,
                                 cfg: MonotonicDecoderConfig, *,
                                 enc_padding_mask: Optional[torch.Tensor] = None,
                                 parallel: bool = True):
    """The cache of ``enc_out`` and the prefill of the context ``tokens``:
    the full-sequence prefill (``parallel``) or the step-by-step one."""
    cache = monotonic_decoder_cache(params, cfg, enc_out, max_len)
    fn = monotonic_prefill_parallel if parallel else monotonic_prefill
    return fn(params, tokens, n_tokens, cache, cfg, enc_padding_mask=enc_padding_mask)


def monotonic_prefill(params: dict, tokens: torch.Tensor, n_tokens: int,
                      cache: MonotonicCache, cfg: MonotonicDecoderConfig, *,
                      enc_padding_mask: Optional[torch.Tensor] = None):
    """Decode ``tokens`` (B, T) step by step -> (the logits (B, V) and
    p_choose (B, L * H, Sp) of step ``n_tokens - 1``, features (B, T, D),
    cache). Steps from ``n_tokens`` on run too and write their rows, as in
    the JAX package; the caller resumes at step ``n_tokens``, which rewrites
    each of those rows before any later step reads it."""
    B, T = tokens.shape
    logits = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=tokens.device)
    Sp = cache.pooled_keys.shape[1]
    pcs = torch.zeros((B, cfg.num_layers * cfg.num_heads, Sp), dtype=torch.float32,
                      device=tokens.device)
    feats = []
    for idx in range(T):
        lg, feat, pc, cache = monotonic_decode_step(
            params, tokens[:, idx:idx + 1], cache, idx, cfg,
            enc_padding_mask=enc_padding_mask)
        if idx < n_tokens:
            logits, pcs = lg, pc
        feats.append(feat[:, 0])
    return logits, torch.stack(feats, dim=1), pcs, cache


def monotonic_prefill_parallel(params: dict, tokens: torch.Tensor,
                               n_tokens: Union[int, Sequence[int]],
                               cache: MonotonicCache, cfg: MonotonicDecoderConfig, *,
                               enc_padding_mask: Optional[torch.Tensor] = None):
    """The teacher-forced full-sequence prefill, the same function as
    ``monotonic_prefill`` (causal self-attention gives each position the same
    output) with one pass over the weights instead of one a token. Writes
    rows [0, T) of the self-attention caches; same contract. ``n_tokens`` is
    one int, or one a row (contexts of different lengths padded to T)."""
    B, T = tokens.shape
    H = cfg.num_heads
    x = embedding_frontend(params["embed"], tokens, cfg.dec_cfg())
    cross_bias = padding_bias(enc_padding_mask)
    cbias = causal_mask(T, device=tokens.device)[None, None]
    counts = [n_tokens] * B if isinstance(n_tokens, int) else list(n_tokens)
    lasts = [min(max(n - 1, 0), T - 1) for n in counts]
    if len(set(lasts)) == 1:
        def at_last(z):             # (B, T, D) -> (B, 1, D) at each row's last token
            return z[:, lasts[0]:lasts[0] + 1]
    else:
        rows = torch.arange(B, device=tokens.device)
        last = torch.tensor(lasts, device=tokens.device)

        def at_last(z):
            return z[rows, last][:, None]
    pcs = []
    for i, layer in enumerate(params["layers"]):
        z = layer_norm(layer["self_attn_layer_norm"], x)
        ap = layer["self_attn"]
        q = attn_ops._split_heads(linear(ap["q_proj"], z), H)
        k = attn_ops._split_heads(linear(ap["k_proj"], z), H)
        v = attn_ops._split_heads(linear(ap["v_proj"], z), H)
        y = attn_ops._sdpa(q, k, v, cbias)
        x = x + linear(ap["output_proj"], attn_ops._merge_heads(y))

        z = layer_norm(layer["cross_attn_layer_norm"], x)
        pcs.append(p_choose(layer["p_choose"], at_last(z), None, cfg,
                            k_energy=cache.k_energy[i])[:, :, 0, :])
        cp = layer["cross_attn"]
        cq = attn_ops._split_heads(linear(cp["q_proj"], z), H)
        co = attn_ops._sdpa(cq, cache.cross_k[i], cache.cross_v[i], cross_bias)
        x = x + linear(cp["output_proj"], attn_ops._merge_heads(co))

        z = layer_norm(layer["ffn"]["layer_norm"], x)
        z = torch.relu(linear(layer["ffn"]["inner_proj"], z))
        x = x + linear(layer["ffn"]["output_proj"], z)
        cache.self_k[i, :, :, :T] = k.to(cache.self_k.dtype)
        cache.self_v[i, :, :, :T] = v.to(cache.self_v.dtype)
    out = layer_norm(params["layer_norm"], x)
    logits = tied_projection(params["embed"], at_last(out))[:, 0]
    return logits, out, torch.cat(pcs, dim=1), cache
