"""The EMMA monotonic text decoder of SeamlessStreaming (dense_1b: 24
pre-norm layers of causal self-attention, p_choose, cross-attention and a
ReLU FFN, the final layer norm, the tied projection), teacher-forced over
the tokens of one decision round of a session.

p_choose of a layer and head at a pooled key is sigmoid((q . k / sqrt(Dh) +
energy_bias) / temperature), q and k each through a 4-layer ReLU MLP, the
keys the encoder output averaged two frames at a time (the last valid
frame standing in beyond the valid length). The policy's statistic is the
least p_choose over all layers and heads at the last valid pooled key.

A round is the prefill of the context (the target prefix and the tokens
written so far) in one causal pass, then one step a written token, each
step reading the earlier positions' keys and values from a cache in the
encoder output's dtype. The arithmetic follows the configuration's dtypes:
the encoder output and everything made from it alone (cross-attention keys
and values, pooled keys and their energies) in the stream's bfloat16; the
prefill's cross-attention weights and output in it too, a step's in fp32."""

from __future__ import annotations

import math

import torch

from reference.nn import Quant, embed_tokens, heads, layer_norm, merge, project

NEG = -1e9


def _mlp(layers: list, x: torch.Tensor, qt: Quant) -> torch.Tensor:
    for p in layers:
        x = torch.relu(qt.linear(p, "energy_proj", x))
    return x


def pooled_key(enc: torch.Tensor, n_valid: int, ratio: int) -> torch.Tensor:
    """The last valid pooled key: the mean of frames [r (s - 1), r s) of the
    encoder output, frames past the valid ones replaced by the last valid
    one, s = ceil(n_valid / r); in the output's dtype."""
    s = max(1, -(-n_valid // ratio))
    idx = torch.clamp_max(torch.arange((s - 1) * ratio, s * ratio, device=enc.device),
                          n_valid - 1)
    win = enc[idx][None, None]                                       # (1, 1, r, D)
    return (win.sum(dim=2) / torch.tensor(float(ratio), dtype=enc.dtype,
                                          device=enc.device))[0]     # (1, D)


def round_outputs(qt: Quant, p: dict, mono: dict, enc: torch.Tensor, tokens: torch.Tensor,
                  n_ctx: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``enc`` (S, D): the valid encoder output; ``tokens`` (L,): the
    context (its first ``n_ctx``) and the round's written tokens. Returns
    the (L, V) fp32 logits and the (L,) statistics of the decision after
    each position."""
    H, L = mono["num_heads"], tokens.shape[0]
    dh = mono["model_dim"] // H
    x = embed_tokens(qt, p["embed"]["embedding"], tokens[None], mono["pad_idx"])
    i = torch.arange(L, device=enc.device)
    causal = i[None, :] <= i[:, None]
    cached = (i[:, None] >= n_ctx) & (i[None, :] < i[:, None])     # a step's history
    in_prefill = (i < n_ctx)[None, None, :, None]
    key = pooled_key(enc, enc.shape[0], mono["pre_decision_ratio"])
    stats = []
    for lp in p["layers"]:
        z = layer_norm(lp["self_attn_layer_norm"], x)
        sa = lp["self_attn"]
        q, k, v = (heads(qt.linear(sa[n], n, z), H).float()
                   for n in ("q_proj", "k_proj", "v_proj"))
        kc, vc = k.to(enc.dtype).float(), v.to(enc.dtype).float()
        logits = torch.where(cached, torch.matmul(q, kc.transpose(-1, -2)),
                             torch.matmul(q, k.transpose(-1, -2))) / math.sqrt(dh)
        probs = torch.softmax(torch.where(causal, logits, NEG), -1)
        out = (torch.matmul(torch.where(cached, probs, 0.0), vc)
               + torch.matmul(torch.where(cached, 0.0, probs), v))
        x = x + qt.linear(sa["output_proj"], "output_proj", merge(out.to(x.dtype)))

        z = layer_norm(lp["cross_attn_layer_norm"], x)
        pc = lp["p_choose"]
        qe = heads(_mlp(pc["q_energy_proj"], z, qt), H).float()           # (1, H, L, dh)
        ke = heads(_mlp(pc["k_energy_proj"], key[None], qt), H).float()   # (1, H, 1, dh)
        energy = torch.matmul(qe, ke.transpose(-1, -2))[..., 0] * dh ** -0.5
        energy = energy + pc["energy_bias"].float()
        stats.append(torch.sigmoid(energy / torch.tensor(mono["monotonic_temperature"],
                                                         device=enc.device))[0])  # (H, L)

        ca = lp["cross_attn"]
        cq = heads(qt.linear(ca["q_proj"], "q_proj", z), H).float()
        ck = heads(qt.linear(ca["k_proj"], "k_proj", enc[None]), H)       # enc dtype
        cv = heads(qt.linear(ca["v_proj"], "v_proj", enc[None]), H)
        w = torch.softmax(torch.matmul(cq, ck.float().transpose(-1, -2)) / math.sqrt(dh), -1)
        o_step = torch.matmul(w, cv.float())
        o_pre = torch.matmul(w.to(enc.dtype).float(), cv.float()).to(enc.dtype)
        y_step = qt.linear(ca["output_proj"], "output_proj", merge(o_step))
        y_pre = qt.linear(ca["output_proj"], "output_proj", merge(o_pre)).float()
        x = x + torch.where(in_prefill[:, 0], y_pre, y_step)

        f = lp["ffn"]
        h = torch.relu(qt.linear(f["inner_proj"], "inner_proj", layer_norm(f["layer_norm"], x)))
        x = x + qt.linear(f["output_proj"], "output_proj", h)
    x = layer_norm(p["layer_norm"], x)
    logits = project(qt, p["embed"]["embedding"], x)[0]
    stat = torch.stack(stats).amin(dim=(0, 1))
    return logits, stat
