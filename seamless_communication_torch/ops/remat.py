"""Layer rematerialization for training (counterpart of
``seamless_communication_tpu/ops/remat.py``).

``with remat_layers(policy):`` makes every layer call of the conformer stack
(``ops/conformer.py conformer_encoder``) and of the transformer stacks
(``ops/transformer.py transformer_encoder``, ``transformer_decoder``) a
non-reentrant ``torch.utils.checkpoint`` region, as the JAX package wraps
each layer-scan body in ``jax.checkpoint``: the backward recomputes a
layer's activations instead of keeping them.

- ``"full"``: keep nothing of the layer; the backward runs its forward
  again (the flash-attention kernel K6 included).
- ``"dots"``: keep the outputs of the matrix products without batch
  dimensions (``aten.mm``, ``aten.addmm``: the linears) and recompute the
  rest, JAX's ``dots_with_no_batch_dims_saveable``, through
  ``torch.utils.checkpoint.create_selective_checkpoint_contexts``.
- ``"offload_dots"``: ``"dots"`` with the saved products in host memory,
  JAX's ``offload_dot_with_no_batch_dims``: each product of the layer's
  forward is copied to a pinned host buffer (on the card; a host copy on
  the CPU) as it is made, and the backward's recompute of the layer takes
  it back instead of computing it again (``_OffloadSave``,
  ``_OffloadReplay``: the selective checkpoint's two contexts with the
  saved outputs kept on the host). Its gradients are ``"dots"``'s.

The setting is read at each layer call, so it covers whatever runs inside
the ``with`` block; a call without autograd (grad mode off) is never
checkpointed.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

POLICIES = ("full", "dots", "offload_dots")
_state = threading.local()
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def current_policy():
    """The policy of the innermost ``remat_layers`` block, or None."""
    return getattr(_state, "policy", None)


@contextlib.contextmanager
def remat_layers(policy: str = "full"):
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of {POLICIES}")
    prev = current_policy()
    _state.policy = policy
    try:
        yield
    finally:
        _state.policy = prev


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


class _OffloadSave(TorchDispatchMode):
    """The forward of an ``"offload_dots"`` layer: every product's output
    copied to a host buffer (pinned for a card's tensor), in order."""

    def __init__(self, store: list):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _SAVED_OPS:
            host = torch.empty(out.shape, dtype=out.dtype, device="cpu",
                               pin_memory=out.is_cuda)
            host.copy_(out.detach(), non_blocking=True)
            self.store.append(host)
        return out


class _OffloadReplay(TorchDispatchMode):
    """The backward's recompute of the layer: each product taken back from
    its host buffer, in the forward's order, the other ops computed again."""

    def __init__(self, store: list):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _SAVED_OPS:
            return self.store.pop(0).to(args[0].device, non_blocking=True)
        return func(*args, **(kwargs or {}))


def _offload_context():
    store: list = []
    return _OffloadSave(store), _OffloadReplay(store)


_CONTEXTS = {"dots": _dots_context, "offload_dots": _offload_context}


def layer_call(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``: one layer of a stack, checkpointed under the
    current policy when remat is on and autograd records."""
    policy = current_policy()
    if policy is None or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    extra = {"context_fn": _CONTEXTS[policy]} if policy in _CONTEXTS else {}
    return checkpoint(fn, *args, use_reentrant=False, **extra, **kwargs)
