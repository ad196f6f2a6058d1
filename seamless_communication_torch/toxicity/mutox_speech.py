"""MuToX speech toxicity pipeline (counterpart of
``seamless_communication_tpu/toxicity/mutox_speech.py``; reference
toxicity/mutox/speech_pipeline.py:31-62): audio -> sentence embedding (the
SONAR speech encoder) -> MLP classifier -> a toxicity logit an utterance.

The SONAR encoders live in Meta's separate ``sonar`` package, so the
embedder is a plug-in with this contract:

    embedder(waveforms: Sequence[np.ndarray, 16 kHz mono]) -> (B, input_size)

It comes from any callable that honours it, from
``sonar_torchscript_embedder(path)`` (a TorchScript export of a SONAR
speech encoder), or from ``sonar_package_embedder(encoder_name)`` where the
``sonar`` package is installed (it raises ``ImportError`` otherwise).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from seamless_communication_torch.device import resolve_device
from seamless_communication_torch.toxicity.mutox import MutoxClassifier, MutoxConfig


def sonar_torchscript_embedder(path: str, *, device=None
                               ) -> Callable[[Sequence], np.ndarray]:
    """A TorchScript-exported SONAR speech encoder (waveform (1, T) -> (1,
    1024) sentence embedding) as an embedder, run on ``device`` (the CUDA
    card unless it says ``cpu``)."""
    dev = resolve_device(device)
    model = torch.jit.load(path, map_location=dev)
    model.eval()

    def embed(wavs: Sequence) -> np.ndarray:
        out = []
        with torch.no_grad():
            for w in wavs:
                t = torch.as_tensor(np.asarray(w, np.float32), device=dev)[None]
                out.append(model(t).squeeze(0).float().cpu().numpy())
        return np.stack(out)

    return embed


def sonar_package_embedder(encoder_name: str = "sonar_speech_encoder_eng", *,
                           device=None) -> Callable[[Sequence], np.ndarray]:
    """Meta's ``sonar`` package where it is installed (the reference
    pipeline's own path, speech_pipeline.py:42-53)."""
    from sonar.inference_pipelines.speech import SpeechToEmbeddingModelPipeline

    pipe = SpeechToEmbeddingModelPipeline(encoder=encoder_name,
                                          device=resolve_device(device))

    def embed(wavs: Sequence) -> np.ndarray:
        tensors = [torch.from_numpy(np.asarray(w, np.float32))[None] for w in wavs]
        return pipe.predict(tensors).cpu().numpy()

    return embed


class MutoxSpeechPipeline:
    """audio -> embeddings -> toxicity logits, in batches."""

    def __init__(self, classifier: MutoxClassifier,
                 embedder: Callable[[Sequence], np.ndarray]):
        self.classifier = classifier
        self.embedder = embedder

    @classmethod
    def from_files(cls, classifier_pt: str, sonar_torchscript: str,
                   cfg: MutoxConfig = MutoxConfig(), device=None) -> "MutoxSpeechPipeline":
        """From a reference mutox ``.pt`` and a TorchScript SONAR encoder
        (the offline counterpart of
        MutoxSpeechClassifierPipeline.load_model_from_name)."""
        from seamless_communication_torch.checkpoint.convert_fairseq2 import (
            load_pt_state_dict, mutox_tree_from_pt,
        )
        params = mutox_tree_from_pt(load_pt_state_dict(classifier_pt))
        return cls(MutoxClassifier(params, cfg, device=device),
                   sonar_torchscript_embedder(sonar_torchscript, device=device))

    def predict(self, wavs: Sequence, *, batch_size: int = 8) -> np.ndarray:
        """16 kHz mono waveforms -> (B,) toxicity logits (a sigmoid gives the
        probability)."""
        logits: List[np.ndarray] = []
        for i in range(0, len(wavs), batch_size):
            emb = self.embedder(wavs[i:i + batch_size])
            logits.append(self.classifier.predict(None, lambda _: emb).cpu().numpy())
        return np.concatenate(logits) if logits else np.zeros((0,), np.float32)
