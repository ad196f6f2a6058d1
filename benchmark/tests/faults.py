"""A fault planted in the program's beam search for the serve cell's
``rank_gap``: the selection of the 2K best continuations passes over each
beam's 2K + 1 best tokens and keeps worse ones, each with its own score,
so that the served scores stay consistent with the served tokens."""

import contextlib

import torch


@contextlib.contextmanager
def beam_keeps_worse():
    from seamless_communication_torch.ops import beam_search as bs

    orig = bs.top_k

    def top_k(x, k):
        K = k // 2
        # the candidate selection: (B, K * V) scores, k = 2K
        if x.dim() == 2 and k % 2 == 0 and K and x.shape[-1] % K == 0 \
                and x.shape[-1] // K > 8 * k:
            rows = x.reshape(x.shape[0], K, -1)
            best = torch.topk(rows, 2 * K + 2, dim=-1)
            # rows with a choice left: not forced, not a dead beam
            free = best.values[..., -1] > bs.NEG_INF / 2
            drop = torch.zeros_like(rows, dtype=torch.bool).scatter_(
                -1, best.indices[..., :2 * K + 1], True)
            x = torch.where(drop & free[..., None], bs.NEG_INF, rows).reshape(x.shape)
        return orig(x, k)

    bs.top_k = top_k
    try:
        yield
    finally:
        bs.top_k = orig
