"""The PRETSSEL expressive vocoder (counterpart of
``seamless_communication_tpu/models/pretssel/vocoder.py``):

  units -> embed + alpha * sinpos ----------------------------+
  prosody fbank -> ECAPA ++ lang embed = FiLM cond -----------+--> FFT encoder (FiLM)
     -> variance adaptor: + pitch (gated by vuv) and energy embeddings,
        added in parallel; Gaussian upsampling by the GIVEN durations;
        + alpha * sinpos
     -> FFT decoder (FiLM) -> mel projection (80) -> + postnet (5 convs)
     -> gcmvn denormalisation -> per-sample (x - mean) / scale
     -> HiFi-GAN (the PRETSSEL variant) = skip waveform
     -> SEANet post-filter on the skip
  out = 0.8 * seanet(skip) + tanh(skip)

The 16 kHz and 24 kHz configs differ in the HiFi-GAN's upsampling (160x,
240x). The FFT layers' attention has 2 heads of 128 and a key-padding mask
only: with ``SEAMLESS_FUSED_ATTN`` on, the encoder's and the decoder's
attentions of 128 or more positions run on the flash-attention kernel (K6)
under key segment ids.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from seamless_communication_torch.models.pretssel.ecapa_tdnn import (
    EcapaConfig, ecapa_forward, ecapa_init,
)
from seamless_communication_torch.models.pretssel.streamable import (
    SeanetConfig, seanet_forward, seanet_init,
)
from seamless_communication_torch.models.unity.t2u import (
    NarT2UConfig, _alpha_sin_pos, fft_layer, fft_layer_init, variance_predictor,
    variance_predictor_init,
)
from seamless_communication_torch.models.vocoder.hifigan import (
    HifiGanConfig, hifigan_forward, hifigan_init,
)
from seamless_communication_torch.ops.masks import lengths_to_padding_mask, padding_bias
from seamless_communication_torch.ops.modules import (
    conv1d, conv1d_init, embedding, embedding_init, linear, linear_init,
)
from seamless_communication_torch.ops.upsample import gaussian_upsample


def _hifigan_cfg(rates, kernels) -> HifiGanConfig:
    return HifiGanConfig(model_in_dim=80, upsample_rates=rates,
                         upsample_kernel_sizes=kernels, upsample_initial_channel=512,
                         add_ups_out_pad=True, final_tanh=False)


class PretsselConfig(NamedTuple):
    num_units: int = 10005
    model_dim: int = 256
    num_heads: int = 2
    ffn_inner_dim: int = 1024
    conv_kernel_size: int = 9
    num_encoder_layers: int = 4
    num_decoder_layers: int = 4
    num_langs: int = 38
    lang_embed_dim: int = 64
    prosody_dim: int = 512          # the ECAPA embedding
    mel_dim: int = 80
    pn_conv_dim: int = 512
    pn_layers: int = 5
    pn_kernel_size: int = 5
    # the variance adaptor has no duration predictor: durations are given;
    # pitch, vuv and energy predictors at hidden 512, kernel 5, with FiLM
    var_pred_hidden: int = 512
    var_pred_kernel: int = 5
    hifigan: HifiGanConfig = _hifigan_cfg((5, 4, 4, 2), (10, 8, 8, 4))
    seanet: SeanetConfig = SeanetConfig()
    ecapa: EcapaConfig = EcapaConfig()
    pos_pad_idx: int = 1

    @property
    def cond_dim(self) -> int:
        return self.prosody_dim + self.lang_embed_dim

    def fft_cfg(self) -> NarT2UConfig:
        return NarT2UConfig(model_dim=self.model_dim, num_heads=self.num_heads,
                            ffn_inner_dim=self.ffn_inner_dim,
                            conv_kernel_size=self.conv_kernel_size,
                            film_cond_dim=self.cond_dim, pos_pad_idx=self.pos_pad_idx)


def pretssel_16khz_config() -> PretsselConfig:
    """The ``16khz`` arch: 160 samples a mel frame."""
    return PretsselConfig(hifigan=_hifigan_cfg((5, 4, 4, 2), (10, 8, 8, 4)),
                          seanet=SeanetConfig(ratios=(8, 5, 4, 2), lstm=2))


def pretssel_24khz_config() -> PretsselConfig:
    """The ``24khz`` arch: 240 samples a mel frame."""
    return PretsselConfig(hifigan=_hifigan_cfg((5, 4, 4, 3), (10, 8, 8, 6)),
                          seanet=SeanetConfig(ratios=(8, 5, 4, 2), lstm=2))


def pretssel_init(gen: torch.Generator, cfg: PretsselConfig, *, dtype=torch.float32,
                  device=None) -> dict:
    """Random parameters. The postnet's batch norms are their folded
    per-channel affines ``{scale, bias}``; the normalisation statistics
    (gcmvn and the per-sample mean and scale) start at the identity and are
    fp32 whatever ``dtype``."""
    kw = dict(dtype=dtype, device=device)
    fft = cfg.fft_cfg()
    enc_layers = [fft_layer_init(gen, fft, **kw) for _ in range(cfg.num_encoder_layers)]
    dec_layers = [fft_layer_init(gen, fft, **kw) for _ in range(cfg.num_decoder_layers)]
    pn, ch_in = [], cfg.mel_dim
    for i in range(cfg.pn_layers):
        ch_out = cfg.pn_conv_dim if i < cfg.pn_layers - 1 else cfg.mel_dim
        pn.append({"conv": conv1d_init(gen, ch_in, ch_out, cfg.pn_kernel_size, **kw),
                   "norm": {"scale": torch.ones((ch_out,), **kw),
                            "bias": torch.zeros((ch_out,), **kw)}})
        ch_in = ch_out

    def var_pred():
        return variance_predictor_init(gen, cfg.model_dim, cfg.var_pred_hidden,
                                       cfg.var_pred_kernel, film_cond_dim=cfg.cond_dim,
                                       **kw)

    stats = dict(dtype=torch.float32, device=device)
    return {
        "prosody_encoder": ecapa_init(gen, cfg.ecapa, **kw),
        "embed_tokens": embedding_init(gen, cfg.num_units, cfg.model_dim, **kw),
        "embed_lang": embedding_init(gen, cfg.num_langs, cfg.lang_embed_dim, **kw),
        "pos_emb_alpha_enc": torch.ones((1,), **kw),
        "pos_emb_alpha_dec": torch.ones((1,), **kw),
        "encoder_layers": enc_layers,
        "pitch_predictor": var_pred(),
        "embed_pitch": conv1d_init(gen, 1, cfg.model_dim, 1, **kw),
        "vuv_predictor": var_pred(),
        "energy_predictor": var_pred(),
        "embed_energy": conv1d_init(gen, 1, cfg.model_dim, 1, **kw),
        "decoder_layers": dec_layers,
        "final_proj": linear_init(gen, cfg.model_dim, cfg.mel_dim, **kw),
        "postnet": pn,
        "hifigan": hifigan_init(gen, cfg.hifigan, **kw),
        "seanet": seanet_init(gen, cfg.seanet, **kw),
        "gcmvn_mean": torch.zeros((cfg.mel_dim,), **stats),
        "gcmvn_std": torch.ones((cfg.mel_dim,), **stats),
        "mean": torch.zeros((cfg.mel_dim,), **stats),
        "scale": torch.ones((cfg.mel_dim,), **stats),
    }


class PretsselOutput(NamedTuple):
    waveform: torch.Tensor        # (B, T_wav)
    sample_lengths: torch.Tensor  # (B,)
    mel: torch.Tensor             # (B, T_mel, 80), gcmvn-denormalised


def pretssel_cond(params: dict, cfg: PretsselConfig, prosody_fbank: torch.Tensor,
                  prosody_lengths: torch.Tensor, lang_id: torch.Tensor) -> torch.Tensor:
    """The (B, 1, cond_dim) FiLM condition: the ECAPA embedding of the
    gcmvn-normalised prosody fbank, then the language embedding."""
    pmask = lengths_to_padding_mask(prosody_lengths, prosody_fbank.shape[1])
    prosody = ecapa_forward(params["prosody_encoder"], prosody_fbank, cfg.ecapa,
                            padding_mask=pmask)[:, None, :]
    lang = embedding(params["embed_lang"], lang_id)[:, None, :]
    return torch.cat([prosody, lang], dim=-1)


def pretssel_forward(params: dict, cfg: PretsselConfig, units: torch.Tensor,
                     unit_lengths: torch.Tensor, durations: torch.Tensor,
                     prosody_fbank: torch.Tensor, prosody_lengths: torch.Tensor,
                     lang_id: torch.Tensor, *, max_mel_len: int,
                     duration_factor: float = 1.0,
                     normalize_before: bool = True) -> PretsselOutput:
    """``units`` (B, U): unit tokens (+4 offset) with their given
    ``durations`` (B, U) (deduplicated units, durations x2, a trailing EOS of
    duration 0; ``inference/pretssel_generator.py``). ``duration_factor``
    does nothing, as in the JAX package and the reference: the durations are
    given, and the expressive CLI's factor acts in the T2U's predictor."""
    del duration_factor
    cond = pretssel_cond(params, cfg, prosody_fbank, prosody_lengths, lang_id)
    mel, mel_total, mmask = pretssel_premel(params, cfg, units, unit_lengths, durations,
                                            cond, max_mel_len=max_mel_len)
    mel, wav = pretssel_wave_synth(params, cfg, mel, mmask,
                                   normalize_before=normalize_before)
    return PretsselOutput(wav, mel_total * cfg.hifigan.total_upsample, mel)


def pretssel_premel(params: dict, cfg: PretsselConfig, units: torch.Tensor,
                    unit_lengths: torch.Tensor, durations: torch.Tensor,
                    cond: torch.Tensor, *, max_mel_len: int):
    """The vocoder's half up to the mel: the unit embedding and positions,
    the FFT encoder (FiLM; post-norm layers, no final norm), the variance
    adaptor (pitch gated by sigmoid(vuv) >= 0.5, pitch and energy embeddings
    both of the same hidden states, added together; Gaussian upsampling by
    the given durations, masked by the units' padding only, so the EOS unit
    of duration 0 keeps weight), the positions again, the FFT decoder (FiLM)
    and the mel projection. Returns (mel (B, max_mel_len, mel_dim), mel
    totals (B,), mel mask)."""
    fft = cfg.fft_cfg()
    U = units.shape[1]
    # an id past the table (a unit decoder's language symbol, offset) takes
    # its last row, as the JAX package's gather clamps it
    x = embedding(params["embed_tokens"], units.clamp(max=cfg.num_units - 1))
    x = _alpha_sin_pos(x, params["pos_emb_alpha_enc"], cfg.pos_pad_idx)
    umask = lengths_to_padding_mask(unit_lengths, U)
    bias = padding_bias(umask)
    for lp in params["encoder_layers"]:
        x = fft_layer(lp, x, bias, umask, fft, cond=cond)

    pitch = variance_predictor(params["pitch_predictor"], x, umask, cond=cond)
    vuv = variance_predictor(params["vuv_predictor"], x, umask, cond=cond)
    pitch = pitch * (torch.sigmoid(vuv) >= 0.5).to(pitch.dtype)
    pitch_emb = conv1d(params["embed_pitch"], pitch[..., None].to(x.dtype))
    energy = variance_predictor(params["energy_predictor"], x, umask, cond=cond)
    energy_emb = conv1d(params["embed_energy"], energy[..., None].to(x.dtype))
    x = x + pitch_emb + energy_emb

    dur = torch.where(umask, durations.to(torch.int32), 0)
    x, mel_total = gaussian_upsample(x, dur, max_mel_len, src_mask=umask)
    mel_total = torch.clamp_max(mel_total, max_mel_len)
    x = _alpha_sin_pos(x, params["pos_emb_alpha_dec"], cfg.pos_pad_idx)
    mmask = lengths_to_padding_mask(mel_total, max_mel_len)
    mbias = padding_bias(mmask)
    for lp in params["decoder_layers"]:
        x = fft_layer(lp, x, mbias, mmask, fft, cond=cond)
    return linear(params["final_proj"], x), mel_total, mmask


def pretssel_wave_synth(params: dict, cfg: PretsselConfig, mel: torch.Tensor,
                        mmask: torch.Tensor, *, normalize_before: bool = True):
    """The vocoder's half after the mel: the postnet residual (conv, the
    folded batch norm, tanh but after the last), the gcmvn denormalisation,
    the per-sample normalisation, the padded frames zeroed after both, the
    HiFi-GAN's skip waveform, then 0.8 * SEANet(skip) + tanh(skip). Returns
    (the denormalised mel, the waveform)."""
    pn = mel
    for i, lp in enumerate(params["postnet"]):
        pn = conv1d(lp["conv"], pn, padding="SAME")
        pn = pn * lp["norm"]["scale"].to(pn.dtype) + lp["norm"]["bias"].to(pn.dtype)
        if i < cfg.pn_layers - 1:
            pn = torch.tanh(pn)
    mel = mel + pn
    mel = mel * params["gcmvn_std"][None, None] + params["gcmvn_mean"][None, None]
    mel_in = (mel - params["mean"]) / params["scale"] if normalize_before else mel
    keep = mmask[..., None]
    mel = mel * keep.to(mel.dtype)
    mel_in = mel_in * keep.to(mel_in.dtype)
    skip = hifigan_forward(params["hifigan"], mel_in, cfg.hifigan)
    refined = seanet_forward(params["seanet"], skip[..., None], cfg.seanet)[..., 0]
    T = min(skip.shape[1], refined.shape[1])
    return mel, 0.8 * refined[:, :T] + torch.tanh(skip[:, :T])
