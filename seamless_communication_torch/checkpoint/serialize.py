"""Parameter files of the port (counterpart of
``seamless_communication_tpu/checkpoint/serialize.py``).

A ``.npz`` file holds one array per leaf, named by the leaf's path of keys
joined by dots. The JAX package stacks the layers of a stack on a leading
axis; the port keeps them as a list, so it stacks them on saving and splits
them on loading, and one ``.npz`` file serves both packages. Leaves are
written in their dtype (bfloat16 widened to float32, numpy having none); the
int4 leaves of the port, packed two to a byte, are written unpacked as int8.

Any other path is a checkpoint directory written with
``torch.distributed.checkpoint`` (the JAX package writes orbax directories
there; the two formats differ, ROADMAP Queue 3): one entry per leaf, named
by its path in the port's layout (the layers as a list). Under a mesh whose
"model" axis splits leaves (``parallel/sharding.py shard_params``) each
rank writes its shards, as ``DTensor``s over the mesh; a directory loads
into any mesh or into one process, whole leaves or each rank's shards.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from seamless_communication_torch.checkpoint.from_jax import (
    monotonic_params_from_jax, monotonic_params_to_numpy, to_numpy, to_torch,
    unity_params_from_jax, unity_params_to_numpy,
)
from seamless_communication_torch.parallel.collectives import model_shard


def _is_monotonic(tree: Any) -> bool:
    """An EMMA monotonic decoder tree: ``layers`` with a p_choose layer."""
    if not (isinstance(tree, dict) and "layers" in tree and "embed" in tree):
        return False
    layers = tree["layers"]
    return "p_choose" in (layers[0] if isinstance(layers, list) else layers)


def flat_tensors(tree: Any, prefix: str = "") -> dict:
    """{dotted path: leaf} of every leaf of a tree of dicts and lists."""
    out: dict = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_tensors(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_tensors(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def nest(flat: dict) -> Any:
    """{dotted path: leaf} back to the tree of dicts and lists."""
    root: dict = {}
    for key, val in flat.items():
        node = root
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return _listify(root)


def _listify(node):
    """{'0': .., '1': ..} dicts back to lists."""
    if isinstance(node, dict):
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [_listify(node[str(i)]) for i in range(len(keys))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def save_params_npz(path: str, params: Any) -> None:
    """A port UnitY or monotonic decoder tree (or any tree of tensors) to a
    ``.npz`` file in the JAX tree's layout."""
    if isinstance(params, dict) and "speech_encoder" in params:
        tree = unity_params_to_numpy(params)
    elif _is_monotonic(params):
        tree = monotonic_params_to_numpy(params)
    else:
        tree = to_numpy(params)
    np.savez(path, **{k: np.asarray(v) for k, v in flat_tensors(tree).items()})


def load_params_npz(path: str, device=None) -> Any:
    """A ``.npz`` file of either package -> a port tree of tensors: a UnitY
    tree (a ``speech_encoder`` at its root) or a monotonic decoder tree in
    the port's layout, any other tree as the file nests it."""
    with np.load(path, allow_pickle=False) as flat:
        tree = nest({key: flat[key] for key in flat.files})
    if isinstance(tree, dict) and "speech_encoder" in tree:
        return unity_params_from_jax(tree, device)
    if _is_monotonic(tree):
        return monotonic_params_from_jax(tree, device)
    return to_torch(tree, device)


# ---------------------------------------------------------------------------
# checkpoint directories
# ---------------------------------------------------------------------------

SAVE_THREADS = 4        # the files a rank writes side by side


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _placed(t: torch.Tensor, mesh) -> Any:
    """What a directory holds for the local leaf ``t``: a ``DTensor`` of its
    shards over the mesh where ``t`` is split over "model", else ``t``
    itself on the host (replicated)."""
    shard = model_shard(t)
    t = t.detach()
    if shard is None or mesh is None or mesh.device_mesh is None:
        return t.cpu()
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor import Shard as DShard

    placements = [DShard(shard.dim) if name == shard.axis.name else Replicate()
                  for name in mesh.axis_names]
    return DTensor.from_local(t.to(mesh.device_mesh.device_type), mesh.device_mesh,
                              placements, run_check=False)


def save_dir(path: str, tensors: dict, mesh=None) -> None:
    """Write the flat dict ``tensors`` (local leaves, possibly shards) as a
    checkpoint directory; every rank of the group calls it."""
    import torch.distributed.checkpoint as dcp

    state = {k: _placed(t, mesh) for k, t in tensors.items()}
    path = os.path.abspath(path)
    dcp.save(state, checkpoint_id=path, no_dist=not _in_group(),
             storage_writer=dcp.FileSystemWriter(path, thread_count=SAVE_THREADS))


def load_dir_into(path: str, tensors: dict, mesh=None) -> None:
    """Read a checkpoint directory into the flat dict ``tensors`` (local
    leaves, possibly shards, on any device), in place, whatever mesh wrote
    it; every rank of the group calls it. Raises on a missing entry."""
    import torch.distributed.checkpoint as dcp

    state = {k: _placed(t, mesh) for k, t in tensors.items()}
    dcp.load(state, checkpoint_id=os.path.abspath(path), no_dist=not _in_group())
    with torch.no_grad():
        for k, t in tensors.items():
            got = state[k]
            got = got.to_local() if hasattr(got, "to_local") else got
            t.copy_(got.to(t.device))


def load_dir(path: str, device=None) -> dict:
    """A checkpoint directory as a flat dict of whole tensors."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    meta = FileSystemReader(os.path.abspath(path)).read_metadata()
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
             for k, m in meta.state_dict_metadata.items() if hasattr(m, "size")}
    dcp.load(state, checkpoint_id=os.path.abspath(path), no_dist=not _in_group())
    return {k: v.to(device) if device is not None else v for k, v in state.items()}


def save_params(path: str, params: Any, mesh=None) -> None:
    """``.npz``: a parameter file (``save_params_npz``, whole leaves only);
    any other path: a checkpoint directory of the port's tree, each rank's
    shards under ``mesh``."""
    if path.endswith(".npz"):
        if any(model_shard(t) is not None for t in flat_tensors(params).values()):
            raise ValueError(f"{path}: a .npz file holds whole leaves; write a "
                             "sharded tree to a checkpoint directory")
        save_params_npz(path, params)
        return
    save_dir(path, flat_tensors(params), mesh)


def load_params(path: str, device=None) -> Any:
    """A ``.npz`` file (``load_params_npz``) or a checkpoint directory, as a
    tree of whole tensors."""
    if path.endswith(".npz"):
        return load_params_npz(path, device)
    return nest(load_dir(path, device))
