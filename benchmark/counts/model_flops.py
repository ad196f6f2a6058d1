"""Model FLOPs of served work, from a configuration file's sizes: 2 x the
weights a frame or token passes through, plus attention's products over
the pairs it attends. Padded frames and tokens, and work done again (the
cross-attention keys of each beam row, the EMMA prefill of every chunk,
the streaming adaptor over the whole buffer), are not counted."""

from __future__ import annotations


def _conformer_layer(c: dict, rows: int, pairs: int) -> float:
    D, F, K = c["dim"], c["ffn_inner_dim"], c["depthwise_kernel_size"]
    P = c["shaw_max_left"] + c["shaw_max_right"] + 1
    return (2 * 2 * rows * 2 * D * F          # the two half-step FFNs
            + 2 * rows * 4 * D * D            # q, k, v, output projections
            + 2 * 2 * pairs * D               # q.k and p.v over the pairs
            + 2 * rows * P * D                # q against the Shaw table
            + 2 * rows * 3 * D * D            # pointwise convs (2D out, then D)
            + 2 * rows * D * K)               # depthwise conv


def conformer_rows(enc: dict, rows: int, pairs: int) -> float:
    """The frontend, the conformer stack and the intermediate FFN over
    ``rows`` stacked frames whose queries attend ``pairs`` keys in all."""
    c = enc["conformer"]
    D, F = c["dim"], enc["ffn_inner_dim"]
    return (2 * rows * enc["feature_dim"] * D
            + c["num_layers"] * _conformer_layer(c, rows, pairs)
            + 2 * rows * 2 * D * F)


def adaptor_frames(enc: dict, frames: int, pairs: int) -> float:
    """The length adaptor's strided convs, attention and FFN over ``frames``
    output frames attending ``pairs`` keys in all."""
    D, F, k = enc["model_dim"], enc["ffn_inner_dim"], enc["adaptor_kernel_size"]
    per_frame = 2 * 2 * k * D * 2 * D + 2 * 4 * D * D + 2 * 2 * D * F
    return enc["adaptor_layers"] * (frames * per_frame + 2 * 2 * pairs * D)


def adaptor_len(enc: dict, rows: int) -> int:
    k, s = enc["adaptor_kernel_size"], enc["adaptor_stride"]
    n = rows
    for _ in range(enc["adaptor_layers"]):
        n = (n + 2 * (k // 2) - k) // s + 1
    return n


def speech_encoder(enc: dict, fbank_frames: int) -> float:
    """One utterance of ``fbank_frames`` valid frames, full attention."""
    rows = fbank_frames // enc["fbank_stride"]
    a = adaptor_len(enc, rows)
    return conformer_rows(enc, rows, rows * rows) + adaptor_frames(enc, a, a * a)


def cross_kv(dec: dict, enc_frames: int) -> float:
    """The cross-attention keys and values of every layer, once an encoder
    frame."""
    return dec["num_layers"] * 2 * enc_frames * 2 * dec["dim"] ** 2


def decoder_token(dec: dict, pos: int, enc_frames: int) -> float:
    """One token of one row through the NLLB decoder at position ``pos``
    (attending ``pos + 1`` rows) over ``enc_frames`` encoder frames, and the
    tied vocabulary projection."""
    D, F = dec["dim"], dec["ffn_inner_dim"]
    layer = (2 * 4 * D * D + 2 * 2 * (pos + 1) * D      # self-attention
             + 2 * 2 * D * D + 2 * 2 * enc_frames * D    # cross q, out; products
             + 2 * 2 * D * F)
    return dec["num_layers"] * layer + 2 * D * dec["vocab_size"]


def monotonic_token(mono: dict, pos: int, enc_frames: int) -> float:
    """One written token through the EMMA decoder: ``decoder_token``'s
    work, plus each layer's query energy MLP and its energies against the
    pooled keys."""
    D = mono["model_dim"]
    pooled = -(-enc_frames // mono["pre_decision_ratio"])
    extra = mono["num_layers"] * (mono["num_monotonic_energy_layers"] * 2 * D * D
                                  + 2 * pooled * D)
    dec = {"dim": D, "ffn_inner_dim": mono["ffn_inner_dim"],
           "num_layers": mono["num_layers"], "vocab_size": mono["vocab_size"]}
    return decoder_token(dec, pos, enc_frames) + extra


def monotonic_frames(mono: dict, enc_frames: int) -> float:
    """Per encoder frame, once: the cross-attention keys and values of every
    layer and the key energy MLPs of the pooled keys."""
    D = mono["model_dim"]
    pooled = enc_frames / mono["pre_decision_ratio"]
    return mono["num_layers"] * (2 * enc_frames * 2 * D * D
                                 + pooled * mono["num_monotonic_energy_layers"] * 2 * D * D)
