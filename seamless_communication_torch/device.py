"""Where the port's entry points run, and moving parameter trees there."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as given, else the CUDA card. Without a card and without an
    explicit device this raises: the port runs on the CPU only when asked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda")


def params_to(params, device: Union[str, torch.device], dtype: Optional[torch.dtype] = None):
    """``params`` with every tensor on ``device``, and every floating tensor in
    ``dtype`` where given; subtrees shared by two keys stay shared."""
    seen: dict = {}

    def walk(node):
        if isinstance(node, torch.Tensor):
            if dtype is not None and node.is_floating_point():
                return node.to(device, dtype)
            return node.to(device)
        if isinstance(node, dict):
            if id(node) not in seen:
                seen[id(node)] = {k: walk(v) for k, v in node.items()}
            return seen[id(node)]
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)
