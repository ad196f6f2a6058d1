"""Parameter files of the port (counterpart of
``seamless_communication_tpu/checkpoint/serialize.py``).

A ``.npz`` file holds one array per leaf, named by the leaf's path of keys
joined by dots. The JAX package stacks the layers of a stack on a leading
axis; the port keeps them as a list, so it stacks them on saving and splits
them on loading, and one ``.npz`` file serves both packages. Leaves are
written in their dtype (bfloat16 widened to float32, numpy having none); the
int4 leaves of the port, packed two to a byte, are written unpacked as int8.

The JAX package's other format, an orbax checkpoint directory, is for its
sharded training state and has no counterpart here yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from seamless_communication_torch.checkpoint.from_jax import (
    monotonic_params_from_jax, monotonic_params_to_numpy, to_numpy, to_torch,
    unity_params_from_jax, unity_params_to_numpy,
)


def _is_monotonic(tree: Any) -> bool:
    """An EMMA monotonic decoder tree: ``layers`` with a p_choose layer."""
    if not (isinstance(tree, dict) and "layers" in tree and "embed" in tree):
        return False
    layers = tree["layers"]
    return "p_choose" in (layers[0] if isinstance(layers, list) else layers)


def _flatten(tree: Any, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


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
    np.savez(path, **_flatten(tree, "", {}))


def load_params_npz(path: str, device=None) -> Any:
    """A ``.npz`` file of either package -> a port tree of tensors: a UnitY
    tree (a ``speech_encoder`` at its root) or a monotonic decoder tree in
    the port's layout, any other tree as the file nests it."""
    root: dict = {}
    with np.load(path, allow_pickle=False) as flat:
        for key in flat.files:
            node = root
            *parents, leaf = key.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    tree = _listify(root)
    if isinstance(tree, dict) and "speech_encoder" in tree:
        return unity_params_from_jax(tree, device)
    if _is_monotonic(tree):
        return monotonic_params_from_jax(tree, device)
    return to_torch(tree, device)


def save_params(path: str, params: Any) -> None:
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: the port writes .npz parameter files only; "
                         "sharded checkpoint directories come with ROADMAP "
                         "entry 14 (parallelism)")
    save_params_npz(path, params)


def load_params(path: str, device=None) -> Any:
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: the port reads .npz parameter files only; "
                         "sharded checkpoint directories come with ROADMAP "
                         "entry 14 (parallelism)")
    return load_params_npz(path, device)
