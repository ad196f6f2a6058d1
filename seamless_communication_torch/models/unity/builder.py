"""UnitY model configs (counterpart of
``seamless_communication_tpu/models/unity/builder.py``) for the archs the
port runs:

  - ``base``     v1 large: w2v-BERT 600m speech encoder (XL rel-pos, SAME
                 depthwise conv, batch norm) + NLLB dense_1b (vocab 256102) +
                 AR T2U (unit vocab 10082)
  - ``medium``   v1 medium: w2v-BERT 300m (12 XL layers) + NLLB dense_600m
                 (12 + 12 layers, vocab 256206) + a 4 + 4 layer AR T2U
  - ``base_v2``  v2 large: conformer_shaw 600m speech encoder (Shaw rel-pos,
                 causal depthwise conv) + NLLB dense_1b decoder (vocab 256102)
                 + NAR T2U
  - ``expressivity_v2`` the SeamlessExpressive (Prosody UnitY2) model:
                 base_v2's speech encoder, an NLLB dense_1b decoder with the
                 (tanh) GELU and max length 10000, a 4 + 4 layer NAR T2U
                 with FiLM and the prosody projection (unit vocab 10005,
                 char vocab 10904), and the ECAPA-TDNN prosody encoder
  - ``streaming`` the SeamlessStreaming UnitY: base_v2's speech encoder with
                 chunked attention (chunk 8, all chunks to the left), no text
                 encoder, base_v2's NAR T2U (its text decoder is the
                 monotonic one, ``models/monotonic``)
  - ``seamless_micro``, ``seamless_nano``  the on-device archs: a 6-layer XL
                 conformer over stride-4 fbank stacks (320 features), a 1 + 3
                 layer NLLB (vocab 20010) and a 1 + 1 layer AR T2U, at width
                 512 and 256 (both named ``seamless_nano`` in ``arch``, as in
                 the JAX package)
  - ``tiny_v1``, ``tiny_v2``, ``tiny_expressive``  the tiny archs of the tests

Each carries one T2U (``models/unity/t2u.py``: ``ar_t2u`` for v1,
``nar_t2u`` for v2) and the NLLB text encoder (``use_text_encoder``), whose
embedding is tied to the decoder's. The expressive archs carry their own
ECAPA prosody encoder (``ecapa``), whose embedding conditions the T2U.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from seamless_communication_torch.models.nllb.model import NllbConfig
from seamless_communication_torch.models.pretssel.ecapa_tdnn import EcapaConfig
from seamless_communication_torch.models.unity.t2u import ArT2UConfig, NarT2UConfig
from seamless_communication_torch.models.wav2vec2.encoder import SpeechEncoderConfig
from seamless_communication_torch.ops.conformer import ConformerConfig


@dataclass(frozen=True)
class UnitYConfig:
    model_dim: int = 1024
    speech: SpeechEncoderConfig = field(default_factory=SpeechEncoderConfig)
    nllb: NllbConfig = field(default_factory=NllbConfig)
    use_text_encoder: bool = True
    # exactly one of these set
    nar_t2u: Optional[NarT2UConfig] = None
    ar_t2u: Optional[ArT2UConfig] = None
    prosody_encoder_dim: int = 0      # the ECAPA embedding's dim (512) when expressive
    ecapa: Optional[EcapaConfig] = None
    arch: str = "base_v2"


_ARCHS: Dict[str, Callable[[], UnitYConfig]] = {}


def register_arch(name: str):
    def deco(fn):
        _ARCHS[name] = fn
        return fn
    return deco


def get_arch(name: str) -> UnitYConfig:
    if name not in _ARCHS:
        raise ValueError(f"unknown UnitY arch {name!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[name]()


def _shaw_conformer(dim=1024, layers=24, heads=16, ffn=4096) -> ConformerConfig:
    return ConformerConfig(dim=dim, ffn_inner_dim=ffn, num_heads=heads,
                           num_layers=layers, pos_type="shaw",
                           causal_depthwise_conv=True, conv_norm="layer_norm",
                           shaw_max_left=64, shaw_max_right=8)


def _xl_conformer(dim=1024, layers=24, heads=16, ffn=4096) -> ConformerConfig:
    return ConformerConfig(dim=dim, ffn_inner_dim=ffn, num_heads=heads,
                           num_layers=layers, pos_type="xl",
                           causal_depthwise_conv=False, conv_norm="batch_norm")


@register_arch("base")
def _base_v1() -> UnitYConfig:
    return UnitYConfig(
        speech=SpeechEncoderConfig(conformer=_xl_conformer()),
        nllb=NllbConfig(vocab_size=256102, max_seq_len=1024),
        ar_t2u=ArT2UConfig(unit_vocab_size=10082),
        arch="base",
    )


@register_arch("medium")
def _medium() -> UnitYConfig:
    return UnitYConfig(
        model_dim=1024,
        speech=SpeechEncoderConfig(
            conformer=_xl_conformer(dim=1024, layers=12), model_dim=1024),
        nllb=NllbConfig(num_encoder_layers=12, num_decoder_layers=12,
                        ffn_inner_dim=4096, vocab_size=256206, max_seq_len=1024),
        ar_t2u=ArT2UConfig(num_encoder_layers=4, num_decoder_layers=4,
                           ffn_inner_dim=4096, unit_vocab_size=10082),
        arch="medium",
    )


@register_arch("base_v2")
def _base_v2() -> UnitYConfig:
    return UnitYConfig(
        speech=SpeechEncoderConfig(conformer=_shaw_conformer()),
        nllb=NllbConfig(vocab_size=256102, max_seq_len=4096),
        nar_t2u=NarT2UConfig(unit_vocab_size=10082, char_vocab_size=10943),
        arch="base_v2",
    )


@register_arch("expressivity_v2")
def _expressivity_v2() -> UnitYConfig:
    return UnitYConfig(
        speech=SpeechEncoderConfig(conformer=_shaw_conformer()),
        nllb=NllbConfig(vocab_size=256102, max_seq_len=10000, activation="gelu"),
        nar_t2u=NarT2UConfig(num_encoder_layers=4, num_decoder_layers=4,
                             unit_vocab_size=10005, char_vocab_size=10904,
                             max_seq_len=10000, film_cond_dim=512, prosody_proj_dim=512),
        prosody_encoder_dim=512,
        ecapa=EcapaConfig(),
        arch="expressivity_v2",
    )


@register_arch("streaming")
def _streaming() -> UnitYConfig:
    base = _base_v2()
    return UnitYConfig(
        speech=SpeechEncoderConfig(conformer=_shaw_conformer(), chunk_size=8,
                                   left_chunk_num=-1),
        nllb=base.nllb,
        use_text_encoder=False,
        nar_t2u=base.nar_t2u,
        arch="streaming",
    )


def _nano_family(model_dim: int) -> UnitYConfig:
    return UnitYConfig(
        model_dim=model_dim,
        speech=SpeechEncoderConfig(
            model_dim=model_dim, feature_dim=320, fbank_stride=4,
            ffn_inner_dim=model_dim * 4, num_adaptor_heads=16,
            conformer=_xl_conformer(dim=model_dim, layers=6, heads=16,
                                    ffn=model_dim * 4)),
        nllb=NllbConfig(dim=model_dim, num_encoder_layers=1, num_decoder_layers=3,
                        num_heads=16, ffn_inner_dim=model_dim * 8,
                        vocab_size=20010, max_seq_len=1024),
        ar_t2u=ArT2UConfig(model_dim=model_dim, num_encoder_layers=1,
                           num_decoder_layers=1, num_heads=16,
                           ffn_inner_dim=model_dim * 8, unit_vocab_size=10082),
        arch="seamless_nano",
    )


@register_arch("seamless_micro")
def _seamless_micro() -> UnitYConfig:
    return _nano_family(512)


@register_arch("seamless_nano")
def _seamless_nano() -> UnitYConfig:
    return _nano_family(256)


@register_arch("tiny_v2")
def _tiny_v2() -> UnitYConfig:
    return UnitYConfig(
        model_dim=64,
        speech=SpeechEncoderConfig(
            model_dim=64, feature_dim=160, ffn_inner_dim=128, num_adaptor_heads=4,
            conformer=ConformerConfig(dim=64, ffn_inner_dim=128, num_heads=4,
                                      num_layers=2, depthwise_kernel_size=7,
                                      pos_type="shaw", shaw_max_left=8,
                                      shaw_max_right=3)),
        nllb=NllbConfig(dim=64, num_encoder_layers=2, num_decoder_layers=2,
                        num_heads=4, ffn_inner_dim=128, vocab_size=256,
                        max_seq_len=512),
        nar_t2u=NarT2UConfig(model_dim=64, num_encoder_layers=2, num_decoder_layers=2,
                             num_heads=4, ffn_inner_dim=128, unit_vocab_size=112,
                             char_vocab_size=64, dur_predictor_hidden=32,
                             max_seq_len=512),
        arch="tiny_v2",
    )


@register_arch("tiny_v1")
def _tiny_v1() -> UnitYConfig:
    return UnitYConfig(
        model_dim=64,
        speech=SpeechEncoderConfig(
            model_dim=64, feature_dim=160, ffn_inner_dim=128, num_adaptor_heads=4,
            conformer=ConformerConfig(dim=64, ffn_inner_dim=128, num_heads=4,
                                      num_layers=2, depthwise_kernel_size=7,
                                      pos_type="xl", causal_depthwise_conv=False,
                                      conv_norm="batch_norm")),
        nllb=NllbConfig(dim=64, num_encoder_layers=2, num_decoder_layers=2,
                        num_heads=4, ffn_inner_dim=128, vocab_size=256,
                        max_seq_len=512),
        ar_t2u=ArT2UConfig(model_dim=64, num_encoder_layers=2, num_decoder_layers=2,
                           num_heads=4, ffn_inner_dim=128, unit_vocab_size=112,
                           max_seq_len=256),
        arch="tiny_v1",
    )


@register_arch("tiny_expressive")
def _tiny_expressive() -> UnitYConfig:
    base = _tiny_v2()
    return UnitYConfig(
        model_dim=64,
        speech=base.speech,
        nllb=NllbConfig(dim=64, num_encoder_layers=2, num_decoder_layers=2,
                        num_heads=4, ffn_inner_dim=128, vocab_size=256,
                        max_seq_len=512, activation="gelu"),
        nar_t2u=NarT2UConfig(model_dim=64, num_encoder_layers=2, num_decoder_layers=2,
                             num_heads=4, ffn_inner_dim=128, unit_vocab_size=112,
                             char_vocab_size=64, dur_predictor_hidden=32,
                             max_seq_len=512, film_cond_dim=32, prosody_proj_dim=32),
        prosody_encoder_dim=32,
        ecapa=EcapaConfig(channels=(32, 32, 32, 32, 96), attention_channels=16,
                          res2net_scale=4, se_channels=16, embed_dim=32),
        arch="tiny_expressive",
    )
