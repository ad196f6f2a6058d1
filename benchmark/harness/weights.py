"""Seeded weights made by the benchmark, on the device, in the dtype they
are served in.

The program's parameter layout (its keys and shapes) comes from the
program's own init run on the ``meta`` device, which allocates and draws
nothing. Every leaf is then filled here from the benchmark's generator, in
large calls (one draw a chunk of up to ``CHUNK`` values), so neither side
takes a weight the program drew:

- a linear weight (in, out): uniform on +-1/sqrt(in); a conv weight
  (kernel, in / groups, out): uniform on +-1/sqrt(kernel * in / groups);
  a bias beside either: the same bound as its weight;
- an embedding table (rows, dim): normal with standard deviation dim^-0.5;
- a layer norm's ``scale`` 1 and ``bias`` 0;
- ``energy_bias`` (EMMA's p_choose): the configuration's value.

These are the distributions of PyTorch's layer defaults, which the
program's init uses too.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

CHUNK = 1 << 26


def _plan(tree, path: Tuple[str, ...], out: List[tuple]) -> None:
    if isinstance(tree, dict):
        is_ln = set(tree) == {"scale", "bias"}
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                if is_ln:
                    out.append((path + (k,), v, "ones" if k == "scale" else "zeros", 0.0))
                elif k == "weight":
                    fan = v.shape[0] if v.ndim == 2 else v.shape[0] * v.shape[1]
                    out.append((path + (k,), v, "uniform", 1.0 / math.sqrt(fan)))
                elif k == "bias":
                    w = tree["weight"]
                    fan = w.shape[0] if w.ndim == 2 else w.shape[0] * w.shape[1]
                    out.append((path + (k,), v, "uniform", 1.0 / math.sqrt(fan)))
                elif k == "embedding":
                    out.append((path + (k,), v, "normal", v.shape[-1] ** -0.5))
                elif k == "energy_bias":
                    out.append((path + (k,), v, "energy_bias", 0.0))
                else:
                    raise ValueError(f"no rule for the leaf {'.'.join(path + (k,))}")
            else:
                _plan(v, path + (k,), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _plan(v, path + (str(i),), out)


def _rebuild(tree, filled: dict, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: (filled[path + (k,)] if isinstance(v, torch.Tensor)
                    else _rebuild(v, filled, path + (k,))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, filled, path + (str(i),)) for i, v in enumerate(tree)]
    return tree


def draw_tree(template, seed: int, device, dtype: torch.dtype, *,
              energy_bias: Optional[float] = None):
    """A tree of the template's keys and shapes on ``device`` in ``dtype``,
    filled from a generator on ``device`` seeded with ``seed``."""
    leaves: List[tuple] = []
    _plan(template, (), leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    filled = {}
    for kind, draw in (("uniform", lambda n: torch.rand(n, generator=gen, device=device)),
                       ("normal", lambda n: torch.randn(n, generator=gen, device=device))):
        _fill(leaves, kind, draw, filled, dtype)
    for path, t, kind, _ in leaves:
        if kind == "ones":
            filled[path] = torch.ones(t.shape, dtype=dtype, device=device)
        elif kind == "zeros":
            filled[path] = torch.zeros(t.shape, dtype=dtype, device=device)
        elif kind == "energy_bias":
            if energy_bias is None:
                raise ValueError("the configuration gives no energy_bias")
            filled[path] = torch.full(t.shape, energy_bias, dtype=dtype, device=device)
    return _rebuild(template, filled)


def _fill(leaves, kind: str, draw: Callable, filled: dict, dtype) -> None:
    """Fill the leaves of ``kind`` in order from draws of up to CHUNK values."""
    todo = [(p, t, b) for p, t, k, b in leaves if k == kind]
    i = 0
    while i < len(todo):
        group, n = [], 0
        while i < len(todo) and (not group or n + todo[i][1].numel() <= CHUNK):
            group.append(todo[i])
            n += todo[i][1].numel()
            i += 1
        flat = draw(n)
        o = 0
        for path, t, bound in group:
            x = flat[o:o + t.numel()].view(t.shape)
            o += t.numel()
            x = (x * 2.0 - 1.0) * bound if kind == "uniform" else x * bound
            filled[path] = x.to(dtype)
        del flat

