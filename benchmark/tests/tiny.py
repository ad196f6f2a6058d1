"""Tiny configurations and mixes for the CPU tests: the program's tiny
archs (``tiny_v2``; the streaming tests' chunk-causal card), the cells'
drivers and checks unchanged."""

import copy
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _load(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


CONFORMER = {"dim": 64, "ffn_inner_dim": 128, "num_heads": 4, "depthwise_kernel_size": 7,
             "num_layers": 2, "pos_type": "shaw", "causal_depthwise_conv": True,
             "conv_norm": "layer_norm", "shaw_max_left": 8, "shaw_max_right": 3}
SPEECH = {"model_dim": 64, "feature_dim": 160, "ffn_inner_dim": 128, "num_adaptor_heads": 4,
          "conformer": CONFORMER}


def serve_config() -> dict:
    c = copy.deepcopy(_load("configs", "m4t_v2_large"))
    c.update(name="tiny_v2", arch="tiny_v2", tokenizer_words=40)
    c["speech_encoder"].update(SPEECH)
    c["text_decoder"].update(dim=64, num_layers=2, num_heads=4, ffn_inner_dim=128,
                             vocab_size=256)
    c["quantize"]["min_size"] = 1
    return c


def serve_traffic() -> dict:
    t = copy.deepcopy(_load("traffic", "s2tt_serve32"))
    t.update(clients=4, max_batch=2, max_wait_ms=5, trace_seconds=1, prepared_requests=8,
             audio_seconds={"min": 1.0, "max": 3.0, "count": 8},
             warmup={"group": 2, "audio_s": 3.0, "soft_max_seq_len": [0, 8]},
             check={"requests": 3})
    return t


MONO = {"model_dim": 64, "num_layers": 2, "num_heads": 4, "ffn_inner_dim": 128,
        "vocab_size": 256, "num_monotonic_energy_layers": 2, "pre_decision_ratio": 2}


def stream_config() -> dict:
    """The streaming pair at the tiny size, its weights and stream state in
    fp32: at this size one bf16 ulp that the block-wise encoder and the
    reference's full forward round apart moves the statistic past the
    cell's limit (the full-size cell reads 3e-5 - 8e-5 in bf16, PERF.md)."""
    c = copy.deepcopy(_load("configs", "seamless_streaming"))
    c.update(name="tiny_streaming", arch="tiny_v2", tokenizer_words=40, speech_from_file=True,
             weights_dtype="float32", stream_state_dtype="float32")
    c["speech_encoder"].update(SPEECH, chunk_size=4)
    c["monotonic_decoder"].update(MONO)
    c["quantize"]["min_size"] = 1
    return c


def stream_traffic() -> dict:
    t = copy.deepcopy(_load("traffic", "s2tt_pool8"))
    t.update(n_slots=3, ramp_steps=4, trace_seconds=1,
             session_chunks={"min": 3, "max": 6, "count": 4}, check={"sessions": 3})
    t["pool"].update(min_starting_wait=16, decision_threshold=0.001, max_len_b=12,
                     max_consecutive_writes=6)
    return t
