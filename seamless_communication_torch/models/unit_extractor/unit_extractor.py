"""UnitExtractor: waveform -> XLSR layer-35 features -> k-means units
(counterpart of ``seamless_communication_tpu/models/unit_extractor/
unit_extractor.py``; reference models/unit_extractor/unit_extractor.py:37-112,
kmeans.py:14-30).

The waveform is layer-normalised row by row over its padded length (no
affine), as the JAX package does, then encoded (``wav2vec2_raw.py``); each
frame takes the nearest of the k-means centroids. Everything runs on the
device of the extractor (the CUDA card unless ``device="cpu"``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.models.unit_extractor.wav2vec2_raw import (
    Wav2Vec2RawConfig, wav2vec2_layer_output,
)


class KmeansModel:
    """Nearest-centroid quantizer: argmin over the centroids of
    ``||x||^2 - 2 x C + ||C||^2``, summed in that order, in fp32 (reference
    kmeans.py:25-30). Of equal distances the first centroid wins, as in
    ``jnp.argmin``."""

    def __init__(self, centroids):
        c = torch.as_tensor(np.asarray(centroids, np.float32))          # (K, D)
        self.centroids = c.T.contiguous()                               # (D, K)
        self.centroid_norm = (self.centroids ** 2).sum(dim=0)[None]     # (1, K)

    @classmethod
    def from_npy(cls, path: str) -> "KmeansModel":
        return cls(np.load(path))

    def to(self, device) -> "KmeansModel":
        """The same centroids on ``device``."""
        out = object.__new__(KmeansModel)
        out.centroids = self.centroids.to(device)
        out.centroid_norm = self.centroid_norm.to(device)
        return out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D) fp32 features -> (...,) int64 centroid indices."""
        x = x.float()
        dist = ((x ** 2).sum(dim=-1, keepdim=True)
                - 2.0 * torch.matmul(x, self.centroids)
                + self.centroid_norm)
        return torch.argmin(dist, dim=-1)


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class UnitExtractor:
    """``predict(waveform)`` -> one list of units a row. ``last_timings``
    holds the wall seconds of the last call's stages: ``encoder`` (the
    normalisation, the feature extractor and the layers), ``kmeans`` and
    ``to_host``."""

    def __init__(self, w2v2_params: dict, kmeans: KmeansModel,
                 cfg: Wav2Vec2RawConfig = Wav2Vec2RawConfig(), *,
                 out_layer_idx: int = 34, device=None):
        self.device = resolve_device(device)
        self.params = params_to(w2v2_params, self.device)
        self.kmeans = kmeans.to(self.device)
        self.cfg = cfg
        self.out_layer_idx = out_layer_idx
        self.last_timings: dict = {}

    def features(self, wav: torch.Tensor, lengths: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, T) waveforms (a row normalised over its padded length, as the
        JAX package does: reference unit_extractor.py:94) -> (layer
        ``out_layer_idx``'s features (B, T_frames, D), valid frames (B,))."""
        mean = wav.mean(dim=-1, keepdim=True)
        var = (wav - mean).square().mean(dim=-1, keepdim=True)
        wav = (wav - mean) * torch.rsqrt(var + 1e-5)
        return wav2vec2_layer_output(self.params, wav, lengths, self.cfg,
                                     out_layer_idx=self.out_layer_idx)

    @torch.inference_mode()
    def predict(self, waveform: np.ndarray, sample_lengths: Optional[np.ndarray] = None
                ) -> list:
        """(T,) or (B, T) float waveforms at 16 kHz and their valid sample
        counts (default: all) -> B lists of units, each cut to its valid
        frames."""
        wav = np.atleast_2d(np.asarray(waveform, np.float32))
        lens = (np.asarray(sample_lengths, np.int64) if sample_lengths is not None
                else np.full((wav.shape[0],), wav.shape[1], np.int64))
        t0 = time.perf_counter()
        feats, out_lens = self.features(torch.as_tensor(wav, device=self.device),
                                        torch.as_tensor(lens, device=self.device))
        _sync(feats)
        t1 = time.perf_counter()
        units = self.kmeans(feats)
        _sync(units)
        t2 = time.perf_counter()
        units, out_lens = units.cpu().numpy(), out_lens.cpu().numpy()
        self.last_timings = {"encoder": t1 - t0, "kmeans": t2 - t1,
                             "to_host": time.perf_counter() - t2}
        return [units[b, :int(out_lens[b])].tolist() for b in range(wav.shape[0])]

    def resynthesize_audio(self, units: list, vocoder_fn, tgt_lang: str, spkr: int = -1):
        """Units -> waveform through a given vocoder callable (reference
        unit_extractor.py:101-112)."""
        return vocoder_fn(units, tgt_lang, spkr)
