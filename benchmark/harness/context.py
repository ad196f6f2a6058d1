"""What a driver is handed for one run, and the program-side helpers the
drivers share (each imports the program inside the function)."""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

# the synthetic vocabulary of chip_smoke.synthetic_spm: no real SentencePiece
# model ships with the repository
SPM_WORDS = 1200
LANGS = ["__eng__", "__fra__"]


@dataclass
class Ctx:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object                       # torch.device
    t_process: float = field(default_factory=time.perf_counter)
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)
    # the readings (benchmark/tests/control.py): "tf32", the program with
    # TF32 on (its own switches, one step below the configuration's float32);
    # "int4", its own int4 path one step below the configuration's int8;
    # "beam", the serve cell's beam search keeping worse candidates
    control: Optional[str] = None


class Stages:
    """Logs the seconds of each set-up stage since the last, and since the
    process started."""

    def __init__(self, ctx: Ctx):
        self.ctx, self.t = ctx, time.perf_counter()

    def __call__(self, name: str) -> None:
        import torch

        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.ctx.log(f"set-up: {name} {now - self.t:.3f} s (at {now - self.ctx.t_process:.3f} s)")
        self.t = now


def apply_env(config: dict, control: Optional[str] = None) -> None:
    """The configuration's environment (a value sets the variable, null
    removes it) and its float32 precision: TF32 on only where the
    configuration states it, or for the TF32 control."""
    from reference.nn import set_tf32

    for k, v in config.get("env", {}).items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    set_tf32(bool(config.get("tf32")) or control == "tf32")


def precision_departures(config: dict) -> int:
    """How many of torch's float32 switches (cuBLAS products, cuDNN
    convolutions and RNNs) do not run at the configuration's precision."""
    from reference.nn import fp32_switches

    want = "tf32" if config.get("tf32") else "ieee"
    return sum(v != want for v in fp32_switches().values())


def host_times() -> tuple:
    """(this thread's CPU seconds, the process's CPU seconds, the seconds
    the machine's hypervisor took from its cores): what the host gave the
    work, read around a group or a window."""
    t = os.times()
    steal = 0.0
    try:
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return time.thread_time(), t.user + t.system, steal


def synthetic_spm(num_words: int = SPM_WORDS) -> bytes:
    """A seeded synthetic SentencePiece model of up to ``num_words`` words,
    as a file's bytes (a copy of chip_smoke.synthetic_spm)."""
    from seamless_communication_torch.text.spm import (
        TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, build_spm_model,
    )

    rng = np.random.default_rng(0)
    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces = sorted({"▁" + "".join(rng.choice(list(letters), rng.integers(2, 9)))
                     for _ in range(num_words)} | {".", ",", "▁the", "▁a"})
    base = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
            ("</s>", 0.0, TYPE_CONTROL)]
    return build_spm_model(base + [(p, -2.0, TYPE_NORMAL) for p in pieces])


def text_tokenizer(config: dict):
    """The NLLB tokenizer over ``synthetic_spm`` of the configuration's
    ``tokenizer_words`` words."""
    from seamless_communication_torch.text.nllb import NllbTokenizer
    from seamless_communication_torch.text.spm import SentencePieceModel

    spm = synthetic_spm(config.get("tokenizer_words", SPM_WORDS))
    return NllbTokenizer(SentencePieceModel.from_bytes(spm), langs=LANGS)


def speech_config(enc: dict):
    """The program's SpeechEncoderConfig of a configuration file's sizes."""
    from seamless_communication_torch.models.wav2vec2.encoder import SpeechEncoderConfig
    from seamless_communication_torch.ops.conformer import ConformerConfig

    keys = SpeechEncoderConfig._fields
    return SpeechEncoderConfig(**{k: v for k, v in enc.items() if k in keys and k != "conformer"},
                               conformer=ConformerConfig(**enc["conformer"]))


def unity_config(config: dict):
    """The program's UnitYConfig of the file's arch. Its speech encoder must
    have the file's sizes; a test's tiny file may set ``speech_from_file``
    to put them in place of the arch's."""
    import dataclasses

    from seamless_communication_torch.models.unity.builder import get_arch

    ucfg = get_arch(config["arch"])
    want = speech_config(config["speech_encoder"])
    if config.get("speech_from_file"):
        return dataclasses.replace(ucfg, speech=want)
    if want != ucfg.speech:
        raise SystemExit(f"{config['name']}: the arch {config['arch']!r} has the speech "
                         f"encoder {ucfg.speech}, the file states {want}")
    return ucfg
