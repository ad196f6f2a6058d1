"""The collectives of the port's meshes over ``torch.distributed`` and the
conjugate pairs of Megatron-style tensor parallelism as autograd functions.

The JAX package leaves its collectives to GSPMD; here they are explicit, on
the process group of one mesh axis (``Axis``):

- ``copy_to`` (Megatron's f): a replicated tensor that each rank consumes
  with its own shard of a weight. The forward is the identity; the backward
  sums the ranks' partial gradients.
- ``reduce_from`` (Megatron's g): the ranks' partial sums become the whole,
  replicated. The forward sums over the axis; the backward is the identity.
- ``gather_from`` / ``split_to``: a tensor split along a dimension becomes
  whole on every rank and back; each one's backward is the other's forward.

Transport: under the gloo backend a CUDA tensor goes to the host, through
the collective and back (gloo's CUDA support varies between collectives and
builds, and one card holds every rank of a mesh there, as gloo processes).
The rule is chosen by the backend, never by a retry. Under NCCL the tensor
stays where it is.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One axis of a mesh as this rank sees it: its process group (None when
    the axis has one rank), its size and this rank's index along it."""
    name: str
    group: Optional[object]
    size: int
    rank: int


class Shard(NamedTuple):
    """The mark of a leaf held in shards: the leaf's dimension that is split
    and the mesh axis it is split over."""
    dim: int
    axis: Axis


SHARD_ATTR = "_model_shard"


def model_shard(t) -> Optional[Shard]:
    """The ``Shard`` of a leaf that ``shard_params`` split, or None."""
    return getattr(t, SHARD_ATTR, None) if isinstance(t, torch.Tensor) else None


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``t`` over ``axis`` as a new tensor (no autograd)."""
    if axis.size == 1:
        return t.detach().clone()
    if _via_host(t, axis.group):
        out = t.detach().to("cpu", copy=True).contiguous()
        dist.all_reduce(out, op, group=axis.group)
        return out.to(t.device)
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op, group=axis.group)
    return out


def all_gather(t: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """Every rank's ``t`` along ``axis``, in rank order (no autograd)."""
    if axis.size == 1:
        return [t.detach()]
    src = t.detach().contiguous()
    if _via_host(t, axis.group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return [p.to(t.device) for p in parts]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return torch.cat(all_gather(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n).contiguous(), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(all_gather(g, ctx.axis), dim=ctx.dim), None, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def gather_from(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    return x if axis.size == 1 else _GatherFrom.apply(x, axis, dim % x.ndim)


def split_to(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    return x if axis.size == 1 else _SplitTo.apply(x, axis, dim % x.ndim)


# ---------------------------------------------------------------------------
# what the ops ask of a possibly sharded parameter
# ---------------------------------------------------------------------------

def local_heads(proj: dict, num_heads: int) -> int:
    """The heads this rank computes of an attention whose q/k/v projection
    is ``proj``: all of them, or ``num_heads / model`` when the projection
    is split by columns (a rank then holds whole heads)."""
    s = model_shard(proj.get("weight"))
    if s is None:
        return num_heads
    if num_heads % s.axis.size:
        raise ValueError(f"{num_heads} heads do not split over {s.axis.size} "
                         f"'{s.axis.name}' ranks")
    return num_heads // s.axis.size


def local_part(t: torch.Tensor, like: dict, dim: int) -> torch.Tensor:
    """A replicated parameter ``t`` that this rank uses only in part, where
    the projection ``like`` is split by columns: the rank's ``1 / model``
    of ``t`` along ``dim`` (its heads' rows or columns), behind
    ``copy_to`` so that its gradient sums the ranks' parts. Unsplit: ``t``."""
    s = model_shard(like.get("weight"))
    if s is None:
        return t
    n = t.shape[dim] // s.axis.size
    return copy_to(t, s.axis).narrow(dim, s.axis.rank * n, n)


def shared(t: torch.Tensor, like: dict) -> torch.Tensor:
    """A replicated parameter ``t`` that every rank uses whole on its own
    heads (the Shaw relative table): behind ``copy_to`` where ``like`` is
    split by columns."""
    s = model_shard(like.get("weight"))
    return t if s is None else copy_to(t, s.axis)


def whole_channels(h: torch.Tensor, like: dict) -> torch.Tensor:
    """The output of a column-split layer (``like``) gathered to all its
    channels, for an op over the whole width (a layer norm)."""
    s = model_shard(like.get("weight"))
    return h if s is None else gather_from(h, s.axis, -1)
