"""Streaming evaluator: SimulEval-style latency and quality scores
(counterpart of ``seamless_communication_tpu/streaming/evaluator.py``;
reference cli/streaming/evaluate.py and simuleval's latency scorers).

Metrics:
  - AL (Average Lagging, Ma et al. 2019) over the emitted target words (S2TT)
  - LAAL (Length-Adaptive Average Lagging)
  - StartOffset / EndOffset in ms (S2ST)
  - quality: BLEU on text (sacrebleu's, ``cli/metrics.py``); ASR-BLEU on
    speech through a pluggable ``transcribe(wavs) -> texts`` (the reference
    uses Whisper)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from seamless_communication_torch.cli.metrics import corpus_bleu


@dataclass
class StreamingInstance:
    """Delay bookkeeping for one utterance."""
    source_duration_ms: float
    # per emitted target token: the source time (ms) read when it was emitted
    delays_ms: List[float] = field(default_factory=list)
    target_tokens: List[str] = field(default_factory=list)
    target_text: str = ""
    # speech output
    first_wav_offset_ms: Optional[float] = None
    last_wav_end_ms: Optional[float] = None
    wav_samples: int = 0
    wav_chunks: List[np.ndarray] = field(default_factory=list)
    wav_sample_rate: int = 16000


def average_lagging(delays_ms: List[float], source_ms: float, target_len: int, *,
                    length_adaptive: bool = False) -> float:
    """AL (Ma et al. 2019); LAAL normalises by max(|y|, |y*|), as simuleval's
    latency scorer does."""
    if target_len == 0 or not delays_ms:
        return 0.0
    tgt_for_rate = max(target_len, len(delays_ms)) if length_adaptive else target_len
    rate = source_ms / tgt_for_rate
    al = 0.0
    tau = 0
    for i, d in enumerate(delays_ms):
        al += d - i * rate
        tau = i + 1
        if d >= source_ms:
            break
    return al / max(tau, 1)


def score_streaming_text(instances: List[StreamingInstance],
                         references: Optional[List[str]] = None) -> dict:
    """S2TT: AL and LAAL, and BLEU when references are given."""
    al = float(np.mean([
        average_lagging(i.delays_ms, i.source_duration_ms, len(i.target_tokens))
        for i in instances]))
    laal = float(np.mean([
        average_lagging(i.delays_ms, i.source_duration_ms, len(i.target_tokens),
                        length_adaptive=True)
        for i in instances]))
    out = {"AL_ms": al, "LAAL_ms": laal}
    if references is not None:
        out["bleu"] = corpus_bleu([i.target_text.strip() for i in instances], references)
    return out


def score_streaming_speech(instances: List[StreamingInstance]) -> dict:
    """S2ST latency: StartOffset and EndOffset in ms."""
    start = [i.first_wav_offset_ms for i in instances
             if i.first_wav_offset_ms is not None]
    end = [i.last_wav_end_ms - i.source_duration_ms for i in instances
           if i.last_wav_end_ms is not None]
    return {
        "StartOffset_ms": float(np.mean(start)) if start else float("nan"),
        "EndOffset_ms": float(np.mean(end)) if end else float("nan"),
    }


def evaluate_streaming(pipeline_factory: Callable, waveforms: List[np.ndarray], *,
                       references: Optional[List[str]] = None,
                       tgt_lang: str = "eng", segment_size_ms: int = 320,
                       sample_rate: int = 16000,
                       output_is_speech: bool = False,
                       transcribe: Optional[Callable] = None) -> dict:
    """Run a fresh pipeline (``pipeline_factory()``) over each waveform and
    score the dataset. An output waveform's duration counts at its own
    sample rate (24 kHz for PRETSSEL). With ``transcribe`` and references,
    speech output also gets ASR-BLEU, each instance resampled to 16 kHz
    first."""
    from seamless_communication_torch.streaming import pipeline as streaming_pipeline
    from seamless_communication_torch.streaming.agents.common import (
        SpeechSegment, TextSegment,
    )

    instances = []
    for wav in waveforms:
        duration_ms = len(wav) / sample_rate * 1000.0
        inst = StreamingInstance(source_duration_ms=duration_ms)
        session = streaming_pipeline.StreamingSession(
            pipeline_factory(), segment_size_ms=segment_size_ms,
            sample_rate=sample_rate, tgt_lang=tgt_lang)
        for chunk_idx, seg in session.run(wav):
            elapsed_ms = min((chunk_idx + 1) * segment_size_ms, duration_ms)
            if isinstance(seg, TextSegment) and isinstance(seg.content, str):
                for w in seg.content.split():
                    inst.delays_ms.append(elapsed_ms)
                    inst.target_tokens.append(w)
                inst.target_text += seg.content
            elif isinstance(seg, SpeechSegment) and seg.content is not None:
                n = np.asarray(seg.content).size
                if n > 0:
                    if inst.first_wav_offset_ms is None:
                        inst.first_wav_offset_ms = elapsed_ms
                    out_sr = getattr(seg, "sample_rate", None) or sample_rate
                    inst.wav_samples += n
                    inst.last_wav_end_ms = elapsed_ms + inst.wav_samples / out_sr * 1000.0
                    inst.wav_sample_rate = out_sr
                    if transcribe is not None:
                        inst.wav_chunks.append(
                            np.asarray(seg.content, np.float32).reshape(-1))
        instances.append(inst)

    metrics: dict = {}
    if output_is_speech:
        metrics.update(score_streaming_speech(instances))
        if transcribe is not None and references is not None:
            from seamless_communication_torch.audio.wav import resample
            from seamless_communication_torch.cli.eval_utils import compute_asr_bleu

            # each instance at its own rate: one that emitted no speech keeps
            # 16 kHz, so no instance's rate stands in for the batch
            wavs = []
            for inst in instances:
                w = (np.concatenate(inst.wav_chunks) if inst.wav_chunks
                     else np.zeros(160, np.float32))
                if inst.wav_sample_rate != 16000:
                    w = resample(w, inst.wav_sample_rate, 16000)
                wavs.append(w)
            metrics["asr_bleu"] = compute_asr_bleu(wavs, references, transcribe=transcribe,
                                                   lang=tgt_lang)
    else:
        metrics.update(score_streaming_text(instances, references))
    metrics["num_instances"] = len(instances)
    return metrics
