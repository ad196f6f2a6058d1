"""Carry parameters of the JAX package over to the port.

The input is a JAX parameter tree (UnitY, expressive ones too, PRETSSEL,
monotonic decoder, vocoder, the XLSR wav2vec2 of unit extraction; the
aligner and MuToX, which have no stacks, cross with ``to_torch`` and
``to_numpy`` as they are) with numpy leaves (the caller maps
``np.asarray`` over it; nothing here imports JAX). Leaves become torch
tensors with the same names and layouts (linear weights ``(in, out)``, conv
weights WIO), quantized leaves included (``weight_i8``/``scale``,
``embedding_i8``/``row_scale``, and ``weight_i4``/``scale4``,
``embedding_i4``/``row_scale4``, whose ``jnp.int4`` values the port packs two
to a byte: ``ops/quantization.py``). The JAX package stacks the layers of a
stack on a leading axis for ``lax.scan``; the port keeps a list of per-layer
dicts, so those leaves are split along their first axis.

``unity_params_to_numpy`` goes the other way: a port tree (parameters, or
their gradients in the same layout) as numpy leaves in the JAX tree's
layout, the layers stacked again, so that the two compare leaf by leaf.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from seamless_communication_torch.ops.quantization import pack_int4, unpack_int4


# leaves of int4 values: jnp.int4 in the JAX tree, packed int8 in the port's
INT4_KEYS = ("weight_i4", "embedding_i4")


def to_torch(tree, device: Optional[torch.device] = None):
    """Every numpy leaf of ``tree`` as a torch tensor (dicts and lists kept;
    int4 leaves packed). A code HiFi-GAN or a PRETSSEL tree comes across as
    it is: their layers (upsamplers, resblocks, FFT layers, ECAPA blocks,
    LSTM layers) are lists in the JAX package too."""
    if isinstance(tree, dict):
        return {k: (pack_int4(torch.from_numpy(np.asarray(v).astype(np.int8))).to(device)
                    if k in INT4_KEYS else to_torch(v, device))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device) for v in tree]
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":       # numpy's bfloat16 extension type
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def unstack_layers(stacked: dict) -> list:
    """A dict of (L, ...) stacked leaves (lists of such sub-trees included,
    as the monotonic decoder's energy layers) -> a list of L per-layer
    dicts."""
    def leaves(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from leaves(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from leaves(v)
        else:
            yield node

    n = next(leaves(stacked)).shape[0]

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        if isinstance(node, (list, tuple)):     # a list of stacked sub-trees
            return [take(v, i) for v in node]
        return node[i]

    return [take(stacked, i) for i in range(n)]


def _stack(tree: dict) -> dict:
    """A transformer stack {"layers": stacked, "layer_norm"} with its layers
    as a list."""
    return dict(tree, layers=unstack_layers(tree["layers"]))


def speech_encoder_from_jax(tree: dict, device=None) -> dict:
    """The conformer stack's layers become a list. A v1 (XL) layer carries
    ``r_proj``, ``u_bias`` and ``v_bias`` in its attention and the folded
    batch norm ``{scale, bias}`` as ``conv.norm``; they come across as they
    are."""
    out = {k: v for k, v in tree.items() if k != "encoder"}
    out["encoder"] = unstack_layers(tree["encoder"])     # the conformer stack
    return to_torch(out, device)


def text_stack_from_jax(tree: dict, device=None) -> dict:
    """{"embed", "stack": {"layers": stacked, "layer_norm"}} of a text encoder
    or decoder."""
    return to_torch(dict(tree, stack=_stack(tree["stack"])), device)


def t2u_from_jax(tree: dict, device=None) -> dict:
    """A NAR T2U tree (the encoder stack's layers and the scan-stacked
    ``decoder_layers`` become lists of per-layer dicts) or an AR T2U tree
    (``encoder``, ``embed`` and the ``decoder`` stack)."""
    if "decoder_layers" in tree:
        out = dict(tree, encoder=_stack(tree["encoder"]),
                   decoder_layers=unstack_layers(tree["decoder_layers"]))
    else:
        out = dict(tree, encoder=_stack(tree["encoder"]), decoder=_stack(tree["decoder"]))
    return to_torch(out, device)


def unity_params_from_jax(tree: dict, device=None) -> dict:
    """The parts of a UnitY tree that the port runs: the speech encoder, the
    text decoder and the T2U (NAR or AR). NLLB ties the text encoder's embedding, the
    decoder's embedding and the output projection to one table: where the
    tree has a text encoder, the port's text encoder shares the decoder's
    ``embed`` dict (the numpy copy of the tree no longer knows they were
    one)."""
    params = {"speech_encoder": speech_encoder_from_jax(tree["speech_encoder"], device),
              "text_decoder": text_stack_from_jax(tree["text_decoder"], device)}
    if "text_encoder" in tree:
        enc = text_stack_from_jax(dict(tree["text_encoder"], embed={}), device)
        enc["embed"] = params["text_decoder"]["embed"]
        params["text_encoder"] = enc
    if "t2u" in tree:
        params["t2u"] = t2u_from_jax(tree["t2u"], device)
    if "prosody_encoder" in tree:       # an expressive model's ECAPA (lists, no stacks)
        params["prosody_encoder"] = to_torch(tree["prosody_encoder"], device)
    return params


def monotonic_params_from_jax(tree: dict, device=None) -> dict:
    """An EMMA monotonic decoder tree ({"embed", "layers": stacked,
    "layer_norm"}): the layers become a list, each layer's energy MLPs a
    list of per-layer linears."""
    return to_torch(dict(tree, layers=unstack_layers(tree["layers"])), device)


def wav2vec2_raw_params_from_jax(tree: dict, device=None) -> dict:
    """The XLSR wav2vec2 tree of unit extraction: its scan-stacked layers
    become a list."""
    return to_torch(dict(tree, layers=unstack_layers(tree["layers"])), device)


# ---------------------------------------------------------------------------
# port -> JAX layout
# ---------------------------------------------------------------------------

def to_numpy(tree):
    """Every tensor leaf of ``tree`` as a numpy array (dicts and lists kept);
    bfloat16 leaves come out widened to float32 (exact), numpy having no
    bfloat16 of its own, and packed int4 leaves unpacked to int8."""
    if isinstance(tree, dict):
        return {k: (unpack_int4(v.detach().cpu()).numpy() if k in INT4_KEYS
                    else to_numpy(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def stack_layers(layers: list) -> dict:
    """A list of L per-layer dicts of numpy leaves -> one dict of (L, ...)
    stacked leaves (the inverse of ``unstack_layers``)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([layer[k] for layer in layers]) for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_layers([layer[j] for layer in layers]) for j in range(len(first))]
    return np.stack(layers)


def _restack(tree: dict) -> dict:
    return dict(tree, layers=stack_layers(tree["layers"]))


def unity_params_to_numpy(params: dict) -> dict:
    """A port UnitY tree (``unity_params_from_jax``'s layout; parameters or
    gradients) as numpy leaves in the JAX tree's layout: the conformer
    stack, the text stacks' layers and the T2U's stacks and FFT layers
    stacked on a leading axis again."""
    tree = to_numpy(params)
    out = {"speech_encoder": dict(tree["speech_encoder"],
                                  encoder=stack_layers(tree["speech_encoder"]["encoder"])),
           "text_decoder": dict(tree["text_decoder"],
                                stack=_restack(tree["text_decoder"]["stack"]))}
    if "text_encoder" in tree:
        out["text_encoder"] = dict(tree["text_encoder"],
                                   stack=_restack(tree["text_encoder"]["stack"]))
    if "t2u" in tree:
        t2u = tree["t2u"]
        if "decoder_layers" in t2u:
            out["t2u"] = dict(t2u, encoder=_restack(t2u["encoder"]),
                              decoder_layers=stack_layers(t2u["decoder_layers"]))
        else:
            out["t2u"] = dict(t2u, encoder=_restack(t2u["encoder"]),
                              decoder=_restack(t2u["decoder"]))
    if "prosody_encoder" in tree:
        out["prosody_encoder"] = tree["prosody_encoder"]
    return out


def monotonic_params_to_numpy(params: dict) -> dict:
    """A port monotonic decoder tree as numpy leaves in the JAX tree's
    layout (the layers stacked again)."""
    tree = to_numpy(params)
    return dict(tree, layers=stack_layers(tree["layers"]))


def wav2vec2_raw_params_to_numpy(params: dict) -> dict:
    """A port XLSR wav2vec2 tree as numpy leaves in the JAX tree's layout
    (the layers stacked again)."""
    tree = to_numpy(params)
    return dict(tree, layers=stack_layers(tree["layers"]))
