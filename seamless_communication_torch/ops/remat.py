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
- ``"offload_dots"``: JAX's TPU policy that moves the saved products to host
  memory. Not ported (ROADMAP, Queue 1): it raises.

The setting is read at each layer call, so it covers whatever runs inside
the ``with`` block; a call without autograd (grad mode off) is never
checkpointed.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
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
    if policy == "offload_dots":
        raise NotImplementedError("remat policy 'offload_dots' (host offload of the "
                                  "saved products) is not ported yet: ROADMAP, Queue 1")
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


def layer_call(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``: one layer of a stack, checkpointed under the
    current policy when remat is on and autograd records."""
    policy = current_policy()
    if policy is None or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    extra = {"context_fn": _dots_context} if policy == "dots" else {}
    return checkpoint(fn, *args, use_reentrant=False, **extra, **kwargs)
