"""GPipe pipeline parallelism over a layer stack (counterpart of
``seamless_communication_tpu/parallel/pipeline.py``).

``pipeline_stack(body, layers, x, mesh=..., n_micro=M)`` computes exactly

    for lp in layers: x = body(x, lp)

with the L layers split into S = ``mesh.size("pipe")`` contiguous stages
(stage s runs layers [s L/S, (s+1) L/S) on pipe rank s) and the batch into
M micro-batches: M + S - 1 ticks, stage s working on micro-batch t - s at
tick t, each stage's output passed to the next stage over the "pipe" group
(an all-gather from which each stage takes its left neighbour's part; JAX's
``ppermute`` ring), and the last stage's outputs broadcast to every stage at
the end (a sum of the outputs masked to the last stage, JAX's ``psum``).

Autograd: the whole schedule is one ``torch.autograd.Function``. Its
forward keeps each micro-batch's graph through the stage's own layers; its
backward runs the schedule in reverse (the last stage first, each stage's
input gradient passed to the stage before it), so that every rank of the
"pipe" group takes part in the same collectives in the same order. The
output's gradient is taken on the last stage only (every stage computes the
same loss downstream, so a sum over stages would count it S times). The
gradients of the input and of the per-sample extras are summed over the
stages (stage 0 alone for the input); those of every layer's parameters are
summed over "pipe" (zeros from the stages that do not hold a layer), so
every rank holds the whole stack's gradients, replicated, as its
parameters are.

Parameters stay whole on every stage (JAX's specs never name "pipe"); a
"model" split of a layer works inside a stage, its collectives on the model
group, whose ranks are all in the same stage.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple, Optional

import torch

from seamless_communication_torch.parallel.collectives import (
    SHARD_ATTR, all_gather, all_reduce,
)


class PipelineCtx(NamedTuple):
    mesh: object
    axis: str
    n_micro: int


_state = threading.local()


def active_pipeline() -> Optional[PipelineCtx]:
    """The pipeline context installed by :func:`pipeline_layers`, if any."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def pipeline_layers(mesh, *, axis: str = "pipe", n_micro: int = 2):
    """Run the layer stacks that go through :func:`run_layers` (the conformer
    and transformer stacks) as a GPipe pipeline over ``mesh``'s ``axis``
    when their layer count divides the stage count. Each layer is a
    checkpoint region inside its stage when remat is on."""
    prev = active_pipeline()
    _state.ctx = PipelineCtx(mesh, axis, n_micro)
    try:
        yield
    finally:
        _state.ctx = prev


def pipeline_or_none(layer_fn: Callable, layers: list, x: torch.Tensor, tensors: dict):
    """``layer_fn(h, tensors, layer_params) -> h`` over ``layers`` as a
    pipeline when a :func:`pipeline_layers` context applies; None (the
    caller's own loop) without one, or when the layer count is not a
    multiple of the stages or the batch of the micro-batches. The entries
    of ``tensors`` whose leading axis is the batch's are split into
    micro-batches with ``x``; the others are passed whole."""
    ctx = active_pipeline()
    if ctx is None:
        return None
    S = ctx.mesh.size(ctx.axis)
    B = x.shape[0]
    if len(layers) % S or B % ctx.n_micro:
        return None
    per = {k: v for k, v in tensors.items()
           if v is not None and tuple(v.shape[:1]) == (B,)}
    closed = {k: v for k, v in tensors.items() if k not in per}

    def body(h, ex, lp):
        return layer_fn(h, {**closed, **ex}, lp)

    return pipeline_stack(body, layers, x, mesh=ctx.mesh, axis=ctx.axis,
                          n_micro=ctx.n_micro, extras=per)


def run_layers(layer_fn: Callable, layers: list, x: torch.Tensor, tensors: dict
               ) -> torch.Tensor:
    """``layer_fn(h, tensors, layer_params) -> h`` over ``layers``: the
    pipeline of :func:`pipeline_or_none` where it applies, else the loop."""
    piped = pipeline_or_none(layer_fn, layers, x, tensors)
    if piped is not None:
        return piped
    for lp in layers:
        x = layer_fn(x, tensors, lp)
    return x


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flatten(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flatten(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _alias(t: torch.Tensor) -> torch.Tensor:
    """A leaf sharing ``t``'s storage, requiring grad where ``t`` does, with
    its shard mark."""
    a = t.detach().requires_grad_(t.requires_grad)
    if hasattr(t, SHARD_ATTR):
        setattr(a, SHARD_ATTR, getattr(t, SHARD_ATTR))
    return a


class _Schedule(NamedTuple):
    body: Callable
    layers: list             # the structure of the layers' parameters
    axis: object             # the "pipe" Axis
    n_micro: int
    extra_keys: tuple


def _ring(t: torch.Tensor, axis, step: int) -> torch.Tensor:
    """Each stage's ``t`` to the stage ``step`` after it (-1: before it)."""
    parts = all_gather(t, axis)
    return parts[(axis.rank - step) % axis.size]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x, *tensors):
        axis, M = sched.axis, sched.n_micro
        S, stage = axis.size, axis.rank
        n_ex = len(sched.extra_keys)
        extras, leaves = tensors[:n_ex], tensors[n_ex:]
        L = len(sched.layers)
        per = L // S
        mine = [_alias(t) for t in leaves]
        layers = _rebuild(sched.layers, iter(mine))[stage * per:(stage + 1) * per]
        xs = x.detach().chunk(M)
        ex_mb = [e.detach().chunk(M) for e in extras]
        zero = torch.zeros_like(xs[0])
        saved, outs, recv = {}, [], zero
        with torch.enable_grad():
            for t in range(M + S - 1):
                m = t - stage
                send = zero
                if 0 <= m < M:
                    h_in = (xs[m] if stage == 0 else recv).detach()
                    h_in.requires_grad_(stage > 0 or x.requires_grad)
                    ex_in = [e[m].detach().requires_grad_(src.requires_grad)
                             for e, src in zip(ex_mb, extras)]
                    ex = dict(zip(sched.extra_keys, ex_in))
                    h = h_in
                    for lp in layers:
                        h = sched.body(h, ex, lp)
                    saved[m] = (h_in, ex_in, h)
                    send = h.detach()
                    if stage == S - 1:
                        outs.append(send)
                recv = _ring(send, axis, 1)
        out = torch.cat(outs) if stage == S - 1 else torch.zeros_like(x)
        ctx.sched, ctx.saved, ctx.mine = sched, saved, mine
        ctx.needs = (x.requires_grad, [e.requires_grad for e in extras],
                     [t.requires_grad for t in leaves])
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return all_reduce(out, axis)

    @staticmethod
    def backward(ctx, g_out):
        sched, saved = ctx.sched, ctx.saved
        axis, M = sched.axis, sched.n_micro
        S, stage = axis.size, axis.rank
        x_needs, ex_needs, leaf_needs = ctx.needs
        g_mb = g_out.chunk(M)
        zero = torch.zeros_like(g_mb[0])
        gx, recv = [], zero
        for u in range(M + S - 1):
            m = u - (S - 1 - stage)
            send = zero
            if 0 <= m < M:
                h_in, ex_in, h = saved.pop(m)
                g = g_mb[m] if stage == S - 1 else recv
                torch.autograd.backward(h, g)
                if h_in.grad is not None:
                    send = h_in.grad
                if stage == 0:
                    gx.append(send)
                saved[m] = (None, ex_in, None)
            recv = _ring(send, axis, -1)
        shape, dtype, device = ctx.x_meta
        grad_x = None
        if x_needs:
            grad_x = all_reduce(torch.cat(gx) if stage == 0
                                else torch.zeros(shape, dtype=dtype, device=device), axis)
        grad_ex = []
        for i, need in enumerate(ex_needs):
            if not need:
                grad_ex.append(None)
                continue
            parts = [saved[m][1][i] for m in range(M)]
            grad_ex.append(all_reduce(torch.cat(
                [p.grad if p.grad is not None else torch.zeros_like(p) for p in parts]),
                axis))
        grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in ctx.mine]
        flat = all_reduce(torch.cat([g.reshape(-1).float() for g in grads]), axis)
        out, o = [], 0
        for g, need in zip(grads, leaf_needs):
            n = g.numel()
            out.append(flat[o:o + n].view_as(g).to(g.dtype) if need else None)
            o += n
        ctx.saved = ctx.mine = None
        return (None, grad_x, *grad_ex, *out)


def pipeline_stack(body: Callable, layers: list, x: torch.Tensor, *, mesh,
                   axis: str = "pipe", n_micro: int, extras: Optional[dict] = None
                   ) -> torch.Tensor:
    """Apply the layers ``layers`` (a list of per-layer parameter trees) as an
    S-stage GPipe pipeline over ``mesh``'s ``axis``.

    body: ``(x_mb, layer_params)`` or, with ``extras``, ``(x_mb, extras_mb,
        layer_params)`` -> x_mb, one layer on one micro-batch.
    x: (B, ...) activations, B % n_micro == 0; len(layers) % S == 0.
    extras: a dict of per-sample tensors with leading axis B (padding
        masks, biases, the encoder output), split into micro-batches with x.

    Returns (B, ...), equal to the sequential loop over all L layers, on
    every stage."""
    ax = mesh.axis(axis)
    S, B, L = ax.size, x.shape[0], len(layers)
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro {n_micro} (global batch "
                         "must divide data_parallel * n_micro)")
    if L % S:
        raise ValueError(f"layers {L} not divisible by pipeline stages {S}")
    extras = extras or {}
    keys = tuple(extras)
    fn = body if extras else (lambda h, ex, lp: body(h, lp))
    sched = _Schedule(fn, layers, ax, n_micro, keys)
    return _Pipeline.apply(sched, x, *(extras[k] for k in keys), *_flatten(layers))
