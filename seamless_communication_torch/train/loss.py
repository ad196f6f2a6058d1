"""Label-smoothed NLL losses of finetuning (counterpart of
``seamless_communication_tpu/train/loss.py``; fairseq2's
``SequenceModelOutput.compute_loss`` with label smoothing)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from seamless_communication_torch.ops.transformer import tied_projection
from seamless_communication_torch.parallel.collectives import (
    Axis, Shard, all_reduce, model_shard, reduce_from,
)


def _target_mask(targets: torch.Tensor, pad_idx: int,
                 ignore_prefix_size: int) -> torch.Tensor:
    mask = (targets != pad_idx).float()
    if ignore_prefix_size:
        mask[:, :ignore_prefix_size] = 0.0
    return mask


def _smoothed_nll(logits: torch.Tensor, targets: torch.Tensor,
                  label_smoothing: float, vocab_shard: Optional[Shard] = None
                  ) -> torch.Tensor:
    """(1 - eps) * nll + eps * (-mean over V of the log-probabilities), per
    position, fp32. ``vocab_shard``: ``logits`` are this rank's block of the
    vocabulary split over "model" (``ops/transformer.py tied_projection``);
    the log-sum-exp, the target's logit and the sum over V are then summed
    over the axis."""
    if vocab_shard is not None:
        return _smoothed_nll_shard(logits.float(), targets, label_smoothing,
                                   vocab_shard.axis)
    lprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lprobs, -1, targets.long()[..., None])[..., 0]
    smooth = -lprobs.mean(dim=-1)
    return (1.0 - label_smoothing) * nll + label_smoothing * smooth


def _smoothed_nll_shard(logits: torch.Tensor, targets: torch.Tensor,
                        label_smoothing: float, axis: Axis) -> torch.Tensor:
    n = logits.shape[-1]
    top = all_reduce(logits.detach().amax(-1), axis, dist.ReduceOp.MAX)
    lse = torch.log(reduce_from(torch.exp(logits - top[..., None]).sum(-1), axis)) + top
    local = targets.long() - axis.rank * n
    mine = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    target = reduce_from(torch.where(mine, picked, 0.0), axis)
    total = reduce_from(logits.sum(-1), axis)
    nll = lse - target
    smooth = lse - total / (n * axis.size)
    return (1.0 - label_smoothing) * nll + label_smoothing * smooth


def label_smoothed_nll_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                            pad_idx: int, label_smoothing: float = 0.2,
                            ignore_prefix_size: int = 0,
                            vocab_shard: Optional[Shard] = None):
    """``logits`` (B, T, V), ``targets`` (B, T) ids; pads are ignored and so
    are the first ``ignore_prefix_size`` positions (the forced language
    token). Returns (loss, number of target tokens): the loss summed over the
    tokens, so that the caller normalizes by tokens. ``vocab_shard``: the
    ``Shard`` of a tied table split over "model", whose logits these are
    (``_smoothed_nll``)."""
    mask = _target_mask(targets, pad_idx, ignore_prefix_size)
    return ((_smoothed_nll(logits, targets, label_smoothing, vocab_shard) * mask).sum(),
            mask.sum())


def _chunk_loss(features: torch.Tensor, embed_params: dict, targets: torch.Tensor,
                mask: torch.Tensor, label_smoothing: float) -> torch.Tensor:
    logits = tied_projection(embed_params, features)
    shard = model_shard(embed_params.get("embedding"))
    return (_smoothed_nll(logits, targets, label_smoothing, shard) * mask).sum()


def chunked_tied_nll_loss(features: torch.Tensor, embed_params: dict,
                          targets: torch.Tensor, *, pad_idx: int,
                          label_smoothing: float = 0.2, ignore_prefix_size: int = 0,
                          chunk: int = 32):
    """``label_smoothed_nll_loss`` of the tied projection of ``features``
    (B, T, D) without the whole (B, T, V) fp32 logits: T is padded to a
    multiple of ``chunk`` (padded positions masked out) and each chunk's
    projection and loss run inside a non-reentrant
    ``torch.utils.checkpoint``, so one (B, chunk, V) block of logits is live
    in the forward and in the recomputing backward. The chunks' sums add up
    in order, as JAX's ``lax.scan`` adds them."""
    B, T, _ = features.shape
    pad_t = (-T) % chunk
    mask = _target_mask(targets, pad_idx, ignore_prefix_size)
    f = F.pad(features, (0, 0, 0, pad_t))
    tg = F.pad(targets, (0, pad_t), value=pad_idx)
    m = F.pad(mask, (0, pad_t))
    total = torch.zeros((), dtype=torch.float32, device=features.device)
    for c in range(0, T + pad_t, chunk):
        part = checkpoint(_chunk_loss, f[:, c:c + chunk], embed_params,
                          tg[:, c:c + chunk], m[:, c:c + chunk], label_smoothing,
                          use_reentrant=False)
        total = total + part
    return total, mask.sum()
