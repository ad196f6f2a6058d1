"""Device meshes and the parameter-sharding rules (counterpart of
``seamless_communication_tpu/parallel/sharding.py``).

A mesh has JAX's axes, ``("data", "model")`` and, with ``pipe`` > 1,
``("data", "model", "pipe")``, laid over the ranks of the default process
group in row-major order (``torch.distributed.device_mesh.init_device_mesh``).
Data parallelism splits each batch over "data" and sums the gradients over
it (``train/trainer.py``); Megatron-style tensor parallelism splits attention
heads and FFN widths over "model" (``parallel/collectives.py`` and the ops);
"pipe" carries the GPipe pipeline (``parallel/pipeline.py``).

The rules are JAX's, by the leaf's path and shape (a spec is a tuple of axis
names or None, one per dimension; ``()`` replicates):
  - q/k/v projections, FFN inner, conv1: (in, out)  -> (None, "model")  [column]
  - output projections, out_proj, conv2: (in, out) -> ("model", None)  [row]
  - embeddings (vocab >= 1024, dim)               -> ("model", None)  [vocab]
  - biases of column layers                        -> ("model",)
The port's leaves have JAX's layouts (linear (in, out), conv WIO); JAX stacks
a stack's layers on a leading axis where the port keeps a list, so a port
leaf's spec is JAX's without that axis.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from seamless_communication_torch.parallel.collectives import SHARD_ATTR, Axis, Shard

_COLUMN = {"q_proj", "k_proj", "v_proj", "inner_proj", "conv1"}
_ROW = {"output_proj", "out_proj", "conv2"}


class Mesh:
    """A device mesh over the process group: its axis names, their sizes,
    and this rank's ``Axis`` on each (its group, size and index).
    ``device_mesh`` is the ``DeviceMesh`` (None on one process), which the
    checkpoint directories use for their sharded leaves."""

    def __init__(self, shape: dict, axes: dict, device_mesh=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.axes = axes
        self.device_mesh = device_mesh

    def axis(self, name: str) -> Axis:
        return self.axes.get(name) or Axis(name, None, 1, 0)

    def size(self, name: str) -> int:
        return self.shape.get(name, 1)


def make_mesh(data: int = 1, model: int = 1, pipe: int = 1) -> Mesh:
    """("data", "model") mesh; with ``pipe`` > 1, ("data", "model", "pipe").
    Its size must be the process group's (one process: 1)."""
    names = ("data", "model", "pipe") if pipe > 1 else ("data", "model")
    sizes = (data, model, pipe) if pipe > 1 else (data, model)
    n = int(np.prod(sizes))
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    shape = dict(zip(names, sizes))
    if world == 1:
        return Mesh(shape, {})
    if n != world:
        raise ValueError(f"a mesh of {n} ranks on a process group of {world}: the "
                         "mesh must span the group")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, sizes, mesh_dim_names=names)
    coords = np.unravel_index(dist.get_rank(), sizes)
    axes = {name: Axis(name, dm.get_group(name), size, int(c))
            for name, size, c in zip(names, sizes, coords)}
    return Mesh(shape, axes, dm)


def param_partition_spec(path: Sequence[str], shape: tuple) -> tuple:
    """The spec of one leaf from its path (dict keys and list indices) and
    shape: JAX's rules (the port's leaves carry no stacked layer axis)."""
    parts = [str(p) for p in path]
    name = parent = None
    for i, p in enumerate(parts):
        if p in ("weight", "bias", "scale", "embedding"):
            name, parent = p, parts[i - 1] if i > 0 else ""
    if name is None:
        parent = name = parts[-1] if parts else ""
    ndim = len(shape)

    def pad(tail: list) -> tuple:
        return tuple([None] * (ndim - len(tail)) + tail)

    if name == "embedding" and ndim >= 2 and shape[-2] >= 1024:
        return pad(["model", None])
    if name == "weight" and ndim >= 2:
        if parent in _COLUMN:
            return pad([None, "model"])
        if parent in _ROW:
            return pad(["model", None])
    if name == "bias" and parent in _COLUMN and ndim >= 1:
        return pad(["model"])
    return ()


def _map(fn, tree, path: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _spec(path: tuple, leaf, mesh: Mesh) -> tuple:
    """JAX's ``with_param_shardings`` rule for one leaf: its spec, or ()
    where a named axis is not in the mesh or "model" does not divide."""
    shape = tuple(getattr(leaf, "shape", ()))
    spec = param_partition_spec(path, shape)
    for dim, axis in zip(shape, spec):
        if axis is not None and (axis not in mesh.shape
                                 or (axis == "model" and dim % mesh.size("model"))):
            return ()
    return spec


def with_param_shardings(params, mesh: Mesh):
    """A tree of specs matching ``params``."""
    return _map(lambda path, leaf: _spec(path, leaf, mesh), params)


def shard_params(params, mesh: Mesh):
    """Each rank's part of ``params``: a leaf whose spec names "model" (on
    a mesh where it has more than one rank) becomes this rank's contiguous
    block along that dimension, a leaf of its own (requiring grad where the
    leaf did) marked with its ``Shard`` (``collectives.model_shard``); every
    other leaf is kept as it is."""
    axis = mesh.axis("model")

    def shard(path, leaf):
        spec = _spec(path, leaf, mesh)
        if axis.size == 1 or "model" not in spec:
            return leaf
        dim = spec.index("model")
        n = leaf.shape[dim] // axis.size
        local = leaf.detach().narrow(dim, axis.rank * n, n).clone()
        local.requires_grad_(leaf.requires_grad)
        setattr(local, SHARD_ATTR, Shard(dim, axis))
        return local

    return _map(shard, params)


def data_sharding(mesh: Mesh):
    """The batch split over "data": a function from a batch (a dict of
    arrays with a leading batch axis) to this rank's contiguous rows."""
    axis = mesh.axis("data")

    def split(batch: dict) -> dict:
        if axis.size == 1:
            return batch
        out = {}
        for k, v in batch.items():
            B = v.shape[0]
            if B % axis.size:
                raise ValueError(f"batch {B} ({k}) does not split over {axis.size} "
                                 "'data' ranks")
            n = B // axis.size
            out[k] = v[axis.rank * n:(axis.rank + 1) * n]
        return out

    return split


def init_distributed(device: Optional[str] = None) -> bool:
    """Start the default process group from the launcher's environment
    (``torchrun``: ``WORLD_SIZE`` > 1) unless one is started: NCCL on CUDA,
    gloo on the CPU. Returns whether the process runs in a group."""
    if dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    cpu = device == "cpu" or not torch.cuda.is_available()
    dist.init_process_group("gloo" if cpu else "nccl")
    return True
