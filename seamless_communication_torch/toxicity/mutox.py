"""MuToX speech and text toxicity classifier (counterpart of
``seamless_communication_tpu/toxicity/mutox.py``; reference
toxicity/mutox/classifier.py:16-60, builder.py:17-83): sentence embeddings
-> MLP 1024 -> 512 -> 128 -> 1, a toxicity logit.

The SONAR embedder is an external model: any callable that gives (B, 1024)
embeddings plugs in (``MutoxClassifier.predict``'s ``embedder``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.ops.modules import (
    layer_norm, layer_norm_init, linear, linear_init,
)


class MutoxConfig(NamedTuple):
    input_size: int = 1024
    hidden_sizes: tuple = (512, 128)
    # the reference MLP is Dropout/ReLU + Linear, no norms
    # (toxicity/mutox/builder.py:44-64)
    use_layer_norm: bool = False


def mutox_init(gen: torch.Generator, cfg: MutoxConfig = MutoxConfig(), *,
               dtype=torch.float32, device=None) -> dict:
    kw = dict(dtype=dtype, device=device)
    dims = (cfg.input_size,) + tuple(cfg.hidden_sizes) + (1,)
    layers = []
    for i in range(len(dims) - 1):
        layer = {"linear": linear_init(gen, dims[i], dims[i + 1], **kw)}
        if cfg.use_layer_norm and i < len(dims) - 2:
            layer["norm"] = layer_norm_init(dims[i], **kw)
        layers.append(layer)
    return {"layers": layers}


def mutox_forward(params: dict, embeddings: torch.Tensor,
                  cfg: MutoxConfig = MutoxConfig()) -> torch.Tensor:
    """(B, input_size) sentence embeddings -> (B,) toxicity logits."""
    h = embeddings
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        if "norm" in layer:
            h = layer_norm(layer["norm"], h)
        h = linear(layer["linear"], h)
        if i < n - 1:
            h = torch.relu(h)
    return h[..., 0]


class MutoxClassifier:
    """The classifier on ``device`` (the CUDA card unless it says ``cpu``)."""

    def __init__(self, params: dict, cfg: MutoxConfig = MutoxConfig(), device=None):
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg

    @torch.inference_mode()
    def predict(self, inputs: Sequence, embedder: Callable) -> torch.Tensor:
        """``embedder(inputs) -> (B, input_size)`` (a SONAR text or speech
        encoder) -> (B,) fp32 logits on the classifier's device."""
        emb = torch.as_tensor(np.asarray(embedder(inputs), np.float32), device=self.device)
        return mutox_forward(self.params, emb, self.cfg)
