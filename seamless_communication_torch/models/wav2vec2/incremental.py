"""The exact incremental (chunk-causal) streaming speech encoder (counterpart
of ``seamless_communication_tpu/models/wav2vec2/incremental.py``).

The ``streaming`` arch's conformer attends chunk by chunk with every chunk
to the left (``chunk_size`` 8, ``left_chunk_num`` -1) and its depthwise conv
is causal, so a conformer output inside a completed chunk never changes as
more audio arrives. The state keeps each layer's keys and values and the
last K - 1 inputs of its causal conv, and a step encodes only the new frames;
the adaptor (bidirectional attention over the 8x downsampled sequence) is
recomputed over the whole buffer at each output. The outputs equal
``speech_encoder_forward``'s on the frames of completed chunks.

A step writes rows [n, n + N) of the key, value and output buffers in place
and returns a state with the new conv tails and count. A state that is not
taken up (the agents' decode over a partial chunk) stays valid: rows from its
``n`` on are written again before any step reads them, and the output masks
them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from seamless_communication_torch.models.wav2vec2.encoder import (
    SpeechEncoderConfig, _adaptor_layer, stack_fbank_frames,
)
from seamless_communication_torch.ops import attention as attn_ops
from seamless_communication_torch.ops.conformer import ConformerConfig, _ffn
from seamless_communication_torch.ops.masks import (
    NEG_INF, apply_padding_mask, lengths_to_padding_mask,
)
from seamless_communication_torch.ops.modules import (
    conv1d, glu, layer_norm, linear, swish, true_div,
)


class SpeechEncoderStreamState(NamedTuple):
    k: torch.Tensor          # (L, B, H, T_max, Dh) the conformer layers' keys
    v: torch.Tensor          # (L, B, H, T_max, Dh)
    conv_tail: torch.Tensor  # (L, B, K - 1, D) the last GLU outputs of each causal conv
    buf: torch.Tensor        # (B, T_max, D) final frames after the intermediate FFN
    n: int                   # stacked frames encoded so far


def speech_encoder_stream_init(cfg: SpeechEncoderConfig, *, batch: int = 1,
                               max_frames: int = 1024, dtype=torch.float32,
                               device=None) -> SpeechEncoderStreamState:
    """An empty state; ``max_frames`` counts stacked frames (fbank frames /
    ``fbank_stride``)."""
    c = cfg.conformer
    H, Dh = c.num_heads, c.dim // c.num_heads
    L, K = c.num_layers, c.depthwise_kernel_size
    kw = dict(dtype=dtype, device=device)
    return SpeechEncoderStreamState(
        k=torch.zeros((L, batch, H, max_frames, Dh), **kw),
        v=torch.zeros((L, batch, H, max_frames, Dh), **kw),
        conv_tail=torch.zeros((L, batch, K - 1, c.dim), **kw),
        buf=torch.zeros((batch, max_frames, cfg.model_dim), **kw), n=0)


def _attention_step(p: dict, h: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, t0: int, n_valid: int, cfg: ConformerConfig,
                    chunk_size: int) -> torch.Tensor:
    """Shaw self-attention of the N new positions at offset ``t0`` over the
    cached keys: a query attends to the keys before the end of its chunk and
    before ``t0 + n_valid`` (a partial final block's padding), with the
    clipped relative-position logits. Keys from ``t0 + N`` on are never
    attended, so they are left out of the products. The relative term is a
    gather of the (N, P) products with the position embeddings: the JAX
    package's one-hot product sums the same single term, exactly."""
    B, N, _ = h.shape
    Hn = cfg.num_heads
    q = attn_ops._split_heads(linear(p["q_proj"], h), Hn)              # (B, H, N, Dh)
    k_cache[:, :, t0:t0 + N] = attn_ops._split_heads(linear(p["k_proj"], h), Hn
                                                     ).to(k_cache.dtype)
    v_cache[:, :, t0:t0 + N] = attn_ops._split_heads(linear(p["v_proj"], h), Hn
                                                     ).to(v_cache.dtype)
    T = t0 + N
    keys, values = k_cache[:, :, :T].to(q.dtype), v_cache[:, :, :T].to(q.dtype)
    dh = q.shape[-1]
    dev = h.device
    key_pos = torch.arange(T, device=dev)
    q_pos = t0 + torch.arange(N, device=dev)
    logits = torch.matmul(q.float(), keys.float().transpose(-1, -2))
    rel = p["rel_k_embed"]["embedding"].to(q.dtype)                    # (P, Dh)
    idx = torch.clamp(key_pos[None, :] - q_pos[:, None], -cfg.shaw_max_left,
                      cfg.shaw_max_right) + cfg.shaw_max_left           # (N, T)
    rel_full = torch.matmul(q.float(), rel.float().T)                  # (B, H, N, P)
    rel_logits = torch.gather(rel_full, 3, idx.expand(B, Hn, N, T))
    logits = true_div(logits + rel_logits, math.sqrt(dh))
    end = (torch.div(q_pos, chunk_size, rounding_mode="floor") + 1) * chunk_size
    allowed = (key_pos[None, :] < end[:, None]) & (key_pos[None, :] < t0 + n_valid)
    logits = torch.where(allowed[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(h.dtype).float(), values.float()).to(h.dtype)
    return linear(p["output_proj"], attn_ops._merge_heads(out))


def _conformer_layer_step(p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, conv_tail: torch.Tensor, t0: int,
                          n_valid: int, cfg: ConformerConfig, chunk_size: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One conformer layer over the new frames -> (output, new conv tail)."""
    x = x + 0.5 * _ffn(p["ffn1"], x)
    h = layer_norm(p["self_attn_layer_norm"], x)
    x = x + _attention_step(p["self_attn"], h, k_cache, v_cache, t0, n_valid, cfg,
                            chunk_size)
    # the conv module: causal depthwise conv over [tail (K - 1), new GLU outputs]
    hc = layer_norm(p["conv"]["layer_norm"], x)
    hc = glu(linear(p["conv"]["pointwise_conv1"], hc), dim=-1)
    full = torch.cat([conv_tail.to(hc.dtype), hc], dim=1)
    new_tail = full[:, -conv_tail.shape[1]:, :]
    hv = conv1d(p["conv"]["depthwise_conv"], full, padding=(0, 0), groups=cfg.dim)
    hv = swish(layer_norm(p["conv"]["norm"], hv))
    x = x + linear(p["conv"]["pointwise_conv2"], hv)
    x = x + 0.5 * _ffn(p["ffn2"], x)
    return layer_norm(p["layer_norm"], x), new_tail


def speech_encoder_stream_step(params: dict, state: SpeechEncoderStreamState,
                               fbank_new: torch.Tensor, cfg: SpeechEncoderConfig, *,
                               n_valid: Optional[int] = None) -> SpeechEncoderStreamState:
    """Encode new fbank frames (B, T_new, 80); T_new / ``fbank_stride`` must
    be a multiple of the chunk size. ``n_valid`` (stacked frames, at most
    T_new / ``fbank_stride``) marks a partial final block whose tail is zero
    padding, not attended; it is for the last step of a stream only (a later
    step would read a conv tail fed by the padded rows)."""
    if cfg.conformer.pos_type != "shaw":
        raise NotImplementedError("the incremental encoder supports the v2 (Shaw) "
                                  "conformer of the streaming arch")
    B, T_new, _ = fbank_new.shape
    x, _ = stack_fbank_frames(fbank_new, torch.full((B,), T_new, device=fbank_new.device),
                              stride=cfg.fbank_stride)
    N = x.shape[1]
    n_valid = N if n_valid is None else n_valid
    x = layer_norm(params["feature_projection"]["layer_norm"], x)
    x = linear(params["feature_projection"]["projection"], x)
    chunk = cfg.chunk_size or 1
    tails = []
    for i, layer in enumerate(params["encoder"]):
        x, tail = _conformer_layer_step(layer, x, state.k[i], state.v[i],
                                        state.conv_tail[i], state.n, n_valid,
                                        cfg.conformer, chunk)
        tails.append(tail)
    h = torch.relu(linear(params["intermediate_ffn"]["inner_proj"], x))
    x = x + 0.5 * linear(params["intermediate_ffn"]["output_proj"], h)
    state.buf[:, state.n:state.n + N] = x.to(state.buf.dtype)
    # the tails keep the activations' dtype, as the JAX package's scan returns them
    return state._replace(conv_tail=torch.stack(tails), n=state.n + n_valid)


def speech_encoder_stream_output(params: dict, state: SpeechEncoderStreamState,
                                 cfg: SpeechEncoderConfig
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The adaptor and the final LN over the encoded buffer -> the (enc_out,
    enc_lens) of ``speech_encoder_forward`` on the whole prefix, over all
    ``T_max`` rows (those past the length zeroed)."""
    B = state.buf.shape[0]
    x = state.buf
    lens = torch.full((B,), state.n, dtype=torch.long, device=x.device)
    for layer in params["adaptor"]:
        x = apply_padding_mask(x, lengths_to_padding_mask(lens, x.shape[1]))
        x, lens = _adaptor_layer(layer, x, lens, cfg)
    x = layer_norm(params["inner_layer_norm"], x)
    return apply_padding_mask(x, lengths_to_padding_mask(lens, x.shape[1])), lens
