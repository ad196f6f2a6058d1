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
them. The count is one a row (a (B,) int64 tensor on the host): the
streaming pool's slots each hold a session at its own offset, and a step
writes each row at its own offset, masks its keys at its own chunk ends, and
the output gives each row its own length. Rows that share one offset (a
single session) are written by slices, as one offset for all.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Union

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
    n: torch.Tensor          # (B,) int64 on the host: stacked frames encoded, a row


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
        buf=torch.zeros((batch, max_frames, cfg.model_dim), **kw),
        n=torch.zeros(batch, dtype=torch.long))


def _to_device(values, device) -> torch.Tensor:
    """A host list as an int64 tensor on ``device``, copied without waiting
    for the stream."""
    return torch.tensor(values, dtype=torch.long).to(device, non_blocking=True)


def _write_rows(dst: torch.Tensor, new: torch.Tensor, at) -> None:
    """Write ``new`` (B, N, ...) into ``dst`` (B, T, ...) at rows [at, at + N)
    of every row (``at`` an int), or at the (row, position) indices ``at``."""
    if isinstance(at, int):
        dst[:, at:at + new.shape[1]] = new
    else:
        dst[at] = new


class _StepRows(NamedTuple):
    """Where a step's N new positions go, computed once for all layers."""
    at: Union[int, tuple]         # the offset every row shares, or (B, 1), (B, N) indices
    t_end: int                    # keys from here on are never attended
    rel_idx: torch.Tensor         # (R, N, t_end) Shaw table index; R = 1 or B
    allowed: torch.Tensor         # (R, N, t_end) the keys a query attends


def _step_rows(starts: Sequence[int], valid: Sequence[int], N: int, cfg: ConformerConfig,
               chunk_size: int, device) -> _StepRows:
    """The positions of a step whose row b writes at ``starts[b]`` with
    ``valid[b]`` of its N positions valid: a query attends to the keys before
    the end of its chunk and before its row's ``start + valid`` (a partial
    final block's padding)."""
    if len(set(starts)) == 1 and len(set(valid)) == 1:
        at = starts[0]
        q_pos = (at + torch.arange(N, device=device))[None]            # (1, N)
        limit = at + valid[0]
    else:
        q_pos = _to_device([[s + i for i in range(N)] for s in starts], device)  # (B, N)
        at = (torch.arange(len(starts), device=device)[:, None], q_pos)
        limit = _to_device([s + v for s, v in zip(starts, valid)], device)[:, None, None]
    t_end = max(starts) + N
    key_pos = torch.arange(t_end, device=device)
    rel_idx = torch.clamp(key_pos - q_pos[..., None], -cfg.shaw_max_left,
                          cfg.shaw_max_right) + cfg.shaw_max_left
    end = (torch.div(q_pos, chunk_size, rounding_mode="floor") + 1) * chunk_size
    allowed = (key_pos < end[..., None]) & (key_pos < limit)
    return _StepRows(at, t_end, rel_idx, allowed)


def _attention_step(p: dict, h: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, rows: _StepRows,
                    cfg: ConformerConfig) -> torch.Tensor:
    """Shaw self-attention of the N new positions of each row over its cached
    keys, with the clipped relative-position logits and the mask of
    ``rows``. Keys from ``rows.t_end`` on are never attended, so they are
    left out of the products. The relative term is a gather of the (N, P)
    products with the position embeddings: the JAX package's one-hot product
    sums the same single term, exactly."""
    B, N, _ = h.shape
    Hn = cfg.num_heads
    q = attn_ops._split_heads(linear(p["q_proj"], h), Hn)              # (B, H, N, Dh)
    for cache, proj in ((k_cache, p["k_proj"]), (v_cache, p["v_proj"])):
        new = attn_ops._split_heads(linear(proj, h), Hn).to(cache.dtype)
        _write_rows(cache.transpose(1, 2), new.transpose(1, 2), rows.at)
    T = rows.t_end
    keys, values = k_cache[:, :, :T].to(q.dtype), v_cache[:, :, :T].to(q.dtype)
    dh = q.shape[-1]
    logits = torch.matmul(q.float(), keys.float().transpose(-1, -2))
    rel = p["rel_k_embed"]["embedding"].to(q.dtype)                    # (P, Dh)
    rel_full = torch.matmul(q.float(), rel.float().T)                  # (B, H, N, P)
    rel_logits = torch.gather(rel_full, 3, rows.rel_idx[:, None].expand(B, Hn, N, T))
    logits = true_div(logits + rel_logits, math.sqrt(dh))
    logits = torch.where(rows.allowed[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(h.dtype).float(), values.float()).to(h.dtype)
    return linear(p["output_proj"], attn_ops._merge_heads(out))


def _conformer_layer_step(p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, conv_tail: torch.Tensor,
                          rows: _StepRows, cfg: ConformerConfig
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One conformer layer over the new frames -> (output, new conv tail)."""
    x = x + 0.5 * _ffn(p["ffn1"], x)
    h = layer_norm(p["self_attn_layer_norm"], x)
    x = x + _attention_step(p["self_attn"], h, k_cache, v_cache, rows, cfg)
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
                               n_valid: Union[None, int, Sequence[int]] = None
                               ) -> SpeechEncoderStreamState:
    """Encode new fbank frames (B, T_new, 80); T_new / ``fbank_stride`` must
    be a multiple of the chunk size. Row b writes at its own offset
    ``state.n[b]``. ``n_valid`` (stacked frames, at most T_new /
    ``fbank_stride``; one int, or one a row) marks a partial final block
    whose tail is zero padding, not attended; it is for the last step of a
    stream only (a later step would read a conv tail fed by the padded
    rows). An offset past ``max_frames`` less the N new frames is clamped
    to it, as the JAX package's ``dynamic_update_slice`` clamps: a row that
    outgrows the state overwrites its own last rows, and no other row's."""
    if cfg.conformer.pos_type != "shaw":
        raise NotImplementedError("the incremental encoder supports the v2 (Shaw) "
                                  "conformer of the streaming arch")
    B, T_new, _ = fbank_new.shape
    dev = fbank_new.device
    x, _ = stack_fbank_frames(fbank_new, torch.full((B,), T_new, device=dev),
                              stride=cfg.fbank_stride)
    N = x.shape[1]
    starts = [min(n, state.k.shape[3] - N) for n in state.n.tolist()]
    n_valid = N if n_valid is None else n_valid
    valid = [n_valid] * B if isinstance(n_valid, int) else list(n_valid)
    rows = _step_rows(starts, valid, N, cfg.conformer, cfg.chunk_size or 1, dev)
    x = layer_norm(params["feature_projection"]["layer_norm"], x)
    x = linear(params["feature_projection"]["projection"], x)
    tails = []
    for i, layer in enumerate(params["encoder"]):
        x, tail = _conformer_layer_step(layer, x, state.k[i], state.v[i],
                                        state.conv_tail[i], rows, cfg.conformer)
        tails.append(tail)
    h = torch.relu(linear(params["intermediate_ffn"]["inner_proj"], x))
    x = x + 0.5 * linear(params["intermediate_ffn"]["output_proj"], h)
    _write_rows(state.buf, x.to(state.buf.dtype), rows.at)
    n = torch.tensor([s + v for s, v in zip(starts, valid)], dtype=torch.long)
    # the tails keep the activations' dtype, as the JAX package's scan returns them
    return state._replace(conv_tail=torch.stack(tails), n=n)


def speech_encoder_stream_output(params: dict, state: SpeechEncoderStreamState,
                                 cfg: SpeechEncoderConfig
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The adaptor and the final LN over the encoded buffer -> the (enc_out,
    enc_lens) of ``speech_encoder_forward`` on the whole prefix, over all
    ``T_max`` rows (those past the length zeroed); each row's length is its
    own ``n``."""
    B = state.buf.shape[0]
    x = state.buf
    counts = state.n.tolist()
    lens = (torch.full((B,), counts[0], dtype=torch.long, device=x.device)
            if len(set(counts)) == 1 else _to_device(counts, x.device))
    for layer in params["adaptor"]:
        x = apply_padding_mask(x, lengths_to_padding_mask(lens, x.shape[1]))
        x, lens = _adaptor_layer(layer, x, lens, cfg)
    x = layer_norm(params["inner_layer_norm"], x)
    return apply_padding_mask(x, lengths_to_padding_mask(lens, x.shape[1])), lens
