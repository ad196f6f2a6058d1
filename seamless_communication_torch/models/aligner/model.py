"""UnitY2 forced aligner (counterpart of
``seamless_communication_tpu/models/aligner/model.py``; reference
models/aligner/model.py:25-304, builder arch nar_t2u_aligner): char-text and
unit embeddings -> conv towers -> pairwise L2 distance -> log-prob attention
-> monotonic Viterbi alignment -> per-char unit durations, the NAR T2U's
duration targets.

The scores (towers, distance, log-softmax) run on the parameters' device.
The monotonic alignment search, the durations and the reduction-factor
truncation stay on the host in float64 numpy, as in the JAX package: a
dynamic program over one text of tens of characters.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from seamless_communication_torch.ops.masks import lengths_to_padding_mask
from seamless_communication_torch.ops.modules import (
    conv1d, conv1d_init, embedding, embedding_init,
)


class AlignerConfig(NamedTuple):
    embed_dim: int = 256
    feat_dim: int = 1280          # the unit-embedding tower's input
    text_vocab_size: int = 10904  # the char vocabulary
    unit_vocab_size: int = 10005
    text_layers: int = 2
    feat_layers: int = 3
    temperature: float = 1.0
    reduction_factor: int = 1


def aligner_init(gen: torch.Generator, cfg: AlignerConfig, *, dtype=torch.float32,
                 device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    t_conv = [conv1d_init(gen, cfg.embed_dim, cfg.embed_dim,
                          3 if i < cfg.text_layers - 1 else 1, **kw)
              for i in range(cfg.text_layers)]
    f_conv = []
    in_dim = cfg.feat_dim
    for i in range(cfg.feat_layers):
        f_conv.append(conv1d_init(gen, in_dim, cfg.embed_dim,
                                  3 if i < cfg.feat_layers - 1 else 1, **kw))
        in_dim = cfg.embed_dim
    return {"embed_text": embedding_init(gen, cfg.text_vocab_size, cfg.embed_dim, **kw),
            "embed_unit": embedding_init(gen, cfg.unit_vocab_size, cfg.feat_dim, **kw),
            "t_conv": t_conv,
            "f_conv": f_conv}


def _tower(convs: list, x: torch.Tensor, *, last_stride: int = 1) -> torch.Tensor:
    for p in convs[:-1]:
        x = torch.relu(conv1d(p, x, padding="SAME"))
    return conv1d(convs[-1], x, stride=last_stride, padding="VALID")


def alignment_scores(params: dict, cfg: AlignerConfig, text_ids: torch.Tensor,
                     unit_ids: torch.Tensor, text_lens: torch.Tensor) -> torch.Tensor:
    """-> (B, T_feat, T_text) log-prob attention. The distance is the norm
    of the difference, sqrt(sum d^2) over the embedding, as
    ``jnp.linalg.norm`` computes it (no matrix-product route, which rounds
    otherwise); text positions past a row's length are -inf before the
    log-softmax."""
    t = _tower(params["t_conv"], embedding(params["embed_text"], text_ids))
    f = _tower(params["f_conv"], embedding(params["embed_unit"], unit_ids),
               last_stride=cfg.reduction_factor)
    diff = f[:, :, None, :] - t[:, None, :, :]
    dist = torch.sqrt((diff * diff).sum(dim=-1))
    score = -cfg.temperature * dist
    tmask = lengths_to_padding_mask(text_lens, t.shape[1])
    score = torch.where(tmask[:, None, :], score, float("-inf"))
    return torch.log_softmax(score, dim=-1)


def monotonic_alignment_search(lprob: np.ndarray) -> np.ndarray:
    """Glow-TTS MAS (reference model.py:212-243). lprob (T_feat, T_text);
    returns the text index of each feature (T_feat,)."""
    T_feat, T_text = lprob.shape
    lp = lprob.T  # (T_text, T_feat)
    Q = np.full((T_text, T_feat), -np.inf)
    Q[0] = np.cumsum(lp[0])
    for j in range(1, T_feat):
        lo = 1
        hi = min(j + 1, T_text)
        if hi > lo:
            Q[lo:hi, j] = np.maximum(Q[lo - 1:hi - 1, j - 1], Q[lo:hi, j - 1]) \
                + lp[lo:hi, j]
    A = np.full((T_feat,), T_text - 1, np.int64)
    for j in range(T_feat - 2, -1, -1):
        i_b = A[j + 1]
        i_a = i_b - 1
        if i_b == 0 or (i_a >= 0 and Q[i_a, j] >= Q[i_b, j]):
            A[j] = max(i_a, 0)
        else:
            A[j] = i_b
    return A


def viterbi_durations(attn_lprob: np.ndarray, text_lens: np.ndarray,
                      feat_lens: np.ndarray) -> np.ndarray:
    """(B, T_feat, T_text) log-probs -> (B, T_text) integer durations
    (reference viterbi_decode, model.py:246-277)."""
    B, _, T_text = attn_lprob.shape
    out = np.zeros((B, T_text), np.int64)
    for b in range(B):
        cur = np.asarray(attn_lprob[b, :feat_lens[b], :text_lens[b]], np.float64)
        path = monotonic_alignment_search(cur)
        counts = np.bincount(path, minlength=int(text_lens[b]))
        out[b, :len(counts)] = counts
    return out


@torch.inference_mode()
def aligner_forward(params: dict, cfg: AlignerConfig, text_ids, unit_ids, text_lens,
                    feat_lens) -> Tuple[np.ndarray, np.ndarray]:
    """Alignment extraction -> (attn log-probs (B, T_feat, T_text) fp32
    numpy, durations (B, T_text) int64 numpy). The ids and lengths may be
    numpy arrays or tensors; the scores run on the parameters' device."""
    dev = params["embed_text"]["embedding"].device
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int64, device=dev)
    lprob = alignment_scores(params, cfg, as_t(text_ids), as_t(unit_ids), as_t(text_lens))
    lprob_np = lprob.float().cpu().numpy()
    text_lens = np.asarray(text_lens)
    feat_lens = np.asarray(feat_lens)
    if cfg.reduction_factor > 1:
        feat_lens = -(-feat_lens // cfg.reduction_factor)
    dur = viterbi_durations(lprob_np, text_lens, feat_lens)
    if cfg.reduction_factor > 1:
        dur = dur * cfg.reduction_factor
        # the overshoot comes off the last non-pad token (reference postprocess)
        for b in range(dur.shape[0]):
            excess = dur[b].sum() - int(feat_lens[b]) * cfg.reduction_factor
            if excess > 0:
                last = int(text_lens[b]) - 1
                dur[b, last] = max(dur[b, last] - excess, 0)
    return lprob_np, dur
