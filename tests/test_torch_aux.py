"""The port's auxiliary subsystems against the JAX package on the CPU: the
MuToX classifier (forward, the reference ``.pt`` layout of the JAX
package's own test, the speech pipeline with a stub embedder), the
``mutox_speech`` and ``mutox_text`` CLIs with TorchScript stand-in SONAR
encoders, VAD segmentation (the energy VAD and a scripted fake silero
model), ``strip_silence``, the spectral-subtraction denoiser and the demucs
shell-out through a stand-in ``demucs`` script on ``PATH``; and the
profiling helpers against their own contract on a CPU trace (the JAX
package's xplane reader has no counterpart: the port reads the Chrome trace
that ``torch.profiler`` writes).

MuToX logits within 1e-6 (absolute; a three-layer MLP of fp32 products),
the CLIs' texts and paths identical and their scores within 1e-6,
segments identical, denoised audio within 1e-6 (the demucs path's exactly
equal: the same file, read and resampled by the same code). Weights come
from the port's inits on seeded generators; every other random input from
numpy's seeded generators."""

import gc
import json
import os
import sys
from typing import List

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.checkpoint import convert_fairseq2 as jf2
from seamless_communication_tpu.cli import mutox_speech as jcli_speech
from seamless_communication_tpu.cli import mutox_text as jcli_text
from seamless_communication_tpu.denoise import denoiser as jden
from seamless_communication_tpu.segment import vad as jvad
from seamless_communication_tpu.toxicity import mutox as jmutox
from seamless_communication_tpu.toxicity import mutox_speech as jspeech

from seamless_communication_torch.audio.wav import write_wav
from seamless_communication_torch.checkpoint import convert_fairseq2 as tf2
from seamless_communication_torch.checkpoint.from_jax import to_numpy, to_torch
from seamless_communication_torch.cli import mutox_speech as tcli_speech
from seamless_communication_torch.cli import mutox_text as tcli_text
from seamless_communication_torch.denoise import denoiser as tden
from seamless_communication_torch.segment import vad as tvad
from seamless_communication_torch.toxicity import mutox as tmutox
from seamless_communication_torch.toxicity import mutox_speech as tspeech
from seamless_communication_torch.utils import profiling

TINY = dict(input_size=16, hidden_sizes=(8, 4))
SCORE_TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mutox_sd(np_tree) -> dict:
    """The reference mutox ``.pt`` layout (Sequential ``model_all.N.1``
    linears, weights (out, in)), as ``test_aux_subsystems.py`` writes it."""
    sd = {}
    for i, layer in enumerate(np_tree["layers"]):
        sd[f"model_all.{i}.1.weight"] = torch.from_numpy(layer["linear"]["weight"].T.copy())
        sd[f"model_all.{i}.1.bias"] = torch.from_numpy(layer["linear"]["bias"].copy())
    return sd


@pytest.fixture(scope="module")
def mutox():
    np_tree = to_numpy(tmutox.mutox_init(torch.Generator().manual_seed(1),
                                         tmutox.MutoxConfig(**TINY)))
    return dict(np_tree=np_tree, tparams=to_torch(np_tree))


class SpeechEmbedder(torch.nn.Module):
    """A stand-in SONAR speech encoder: waveform (1, T) -> (1, dim), a fixed
    projection of four statistics of the waveform."""

    def __init__(self, dim: int, seed: int = 0):
        super().__init__()
        self.register_buffer("w", torch.randn((4, dim), generator=torch.Generator()
                                              .manual_seed(seed)))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        stats = torch.stack([wav.mean() * 10.0, wav.abs().mean() * 10.0, wav.std() * 10.0,
                             wav.abs().max()])
        return (stats @ self.w)[None]


class TextEmbedder(torch.nn.Module):
    """A stand-in SONAR text encoder: texts -> (B, dim), a fixed projection
    of four counts of each text."""

    def __init__(self, dim: int, seed: int = 1):
        super().__init__()
        self.register_buffer("w", torch.randn((4, dim), generator=torch.Generator()
                                              .manual_seed(seed)))

    def forward(self, texts: List[str]) -> torch.Tensor:
        rows = [torch.tensor([float(len(t)) / 10.0, float(t.count(" ")), float(t.count("e")),
                              1.0]) for t in texts]
        return torch.stack(rows) @ self.w


@pytest.mark.parametrize("layer_norm", [False, True])
def test_mutox_forward_matches_jax(layer_norm):
    cfg = dict(TINY, use_layer_norm=layer_norm)
    np_tree = to_numpy(tmutox.mutox_init(torch.Generator().manual_seed(2),
                                         tmutox.MutoxConfig(**cfg)))
    if layer_norm:      # a scale and bias other than the init's 1 and 0
        rng = np.random.default_rng(3)
        for layer in np_tree["layers"][:-1]:
            layer["norm"] = {k: rng.standard_normal(v.shape).astype(np.float32)
                             for k, v in layer["norm"].items()}
    emb = np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32)
    want = np.asarray(jmutox.mutox_forward(jax.tree.map(jnp.asarray, np_tree),
                                           jnp.asarray(emb), jmutox.MutoxConfig(**cfg)))
    got = tmutox.mutox_forward(to_torch(np_tree), torch.from_numpy(emb),
                               tmutox.MutoxConfig(**cfg))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, **SCORE_TOL)


def test_mutox_pt_round_trip_and_pipeline(mutox, tmp_path):
    """The reference ``.pt`` through both converters (the same leaves), then
    the speech pipeline with the JAX test's stub embedder (loud waveforms
    map to a toxic embedding) in batches of 2: the same logits."""
    path = tmp_path / "mutox.pt"
    torch.save({"model": mutox_sd(mutox["np_tree"])}, path)
    want = jf2.mutox_tree_from_pt(jf2.load_pt_state_dict(str(path)))
    got = tf2.mutox_tree_from_pt(tf2.load_pt_state_dict(str(path)))
    for w, g in zip(want["layers"], got["layers"]):
        for k in ("weight", "bias"):
            np.testing.assert_array_equal(g["linear"][k].numpy(), w["linear"][k])

    def stub_embedder(wavs):
        return np.stack([np.full(16, np.sign(np.mean(np.abs(w)))
                                 * (10.0 if np.abs(w).max() > 0.5 else -10.0), np.float32)
                         for w in wavs])

    quiet, loud = 0.01 * np.ones(1600, np.float32), 0.9 * np.ones(1600, np.float32)
    wavs = [quiet, loud, quiet]
    jpipe = jspeech.MutoxSpeechPipeline(jmutox.MutoxClassifier(want, jmutox.MutoxConfig(**TINY)),
                                        stub_embedder)
    tpipe = tspeech.MutoxSpeechPipeline(
        tmutox.MutoxClassifier(got, tmutox.MutoxConfig(**TINY), device="cpu"), stub_embedder)
    want_l, got_l = jpipe.predict(wavs, batch_size=2), tpipe.predict(wavs, batch_size=2)
    assert got_l.shape == (3,) and abs(got_l[0] - got_l[1]) > 1e-3
    np.testing.assert_allclose(got_l, want_l, **SCORE_TOL)


def _read_scores(path):
    lines = open(path).read().splitlines()
    rows = [line.rsplit("\t", 1) for line in lines[1:]]
    return lines[0], [r[0] for r in rows], np.array([float(r[1]) for r in rows])


def _assert_same_output(want_path, got_path, n):
    wh, wk, ws = _read_scores(want_path)
    gh, gk, gs = _read_scores(got_path)
    assert gh == wh and gk == wk and len(gk) == n
    np.testing.assert_allclose(gs, ws, **SCORE_TOL)


def test_mutox_speech_cli_matches_jax(mutox, tmp_path, monkeypatch):
    """Five WAV paths in a file, batches of 2, a TorchScript stand-in
    encoder: both CLIs write the same paths and scores."""
    clf, enc = tmp_path / "mutox.pt", tmp_path / "sonar_speech.pt"
    torch.save({"model": mutox_sd(mutox["np_tree"])}, clf)
    torch.jit.script(SpeechEmbedder(16)).save(str(enc))
    rng = np.random.default_rng(7)
    paths = []
    for i in range(5):
        p = tmp_path / f"u{i}.wav"
        write_wav(str(p), (rng.standard_normal(1600 + 400 * i) * 0.1 * (i + 1)).astype(np.float32),
                  16000)
        paths.append(str(p))
    listing = tmp_path / "in.txt"
    listing.write_text("\n".join(paths) + "\n")
    flags = ["--classifier_pt", str(clf), "--sonar_torchscript", str(enc), "--batch_size", "2"]
    monkeypatch.setattr(sys, "argv", ["mutox_speech", "eng", str(listing),
                                      str(tmp_path / "want.tsv")] + flags)
    jcli_speech.main()
    gc.collect()        # the CLI leaves its output file to be closed by the collector
    tcli_speech.main(["eng", str(listing), str(tmp_path / "got.tsv")] + flags
                     + ["--device", "cpu"])
    gc.collect()
    _assert_same_output(tmp_path / "want.tsv", tmp_path / "got.tsv", 5)


def test_mutox_text_cli_matches_jax(mutox, tmp_path, monkeypatch):
    """Five lines of text, batches of 2 (the last one short), a TorchScript
    stand-in text encoder: both CLIs write the same texts and scores."""
    clf, enc = tmp_path / "mutox.pt", tmp_path / "sonar_text.pt"
    torch.save({"model": mutox_sd(mutox["np_tree"])}, clf)
    torch.jit.script(TextEmbedder(16)).save(str(enc))
    lines = tmp_path / "in.txt"
    lines.write_text("hello there\nthe cat sat on the mat\nsee\n\nwe meet here\n")
    flags = ["--classifier_pt", str(clf), "--sonar_torchscript", str(enc), "--batch_size", "2"]
    monkeypatch.setattr(sys, "argv", ["mutox_text", "eng_Latn", str(lines),
                                      str(tmp_path / "want.tsv")] + flags)
    jcli_text.main()
    gc.collect()
    tcli_text.main(["eng_Latn", str(lines), str(tmp_path / "got.tsv")] + flags
                   + ["--device", "cpu"])
    gc.collect()
    _assert_same_output(tmp_path / "want.tsv", tmp_path / "got.tsv", 5)


def speech_and_pauses(rng, sr: int = 16000) -> np.ndarray:
    """Bursts of loud noise of 0.6-2.4 s between pauses of 0.1-0.8 s of
    faint noise: 12 s."""
    parts, n = [], 0
    while n < 12 * sr:
        for loud, (lo, hi) in ((True, (0.6, 2.4)), (False, (0.1, 0.8))):
            m = int(rng.uniform(lo, hi) * sr)
            parts.append(rng.standard_normal(m) * (0.4 if loud else 0.004))
            n += m
    return np.concatenate(parts)[:12 * sr].astype(np.float32)


class FakeSilero(torch.nn.Module):
    """The silero-vad call shape (``tests/unit/test_silero_wrapper.py``):
    ``model(chunk, sample_rate)`` -> the window's speech probability from its
    energy, and ``reset_states``."""

    def __init__(self):
        super().__init__()
        self.calls = torch.jit.Attribute(0, int)

    @torch.jit.export
    def reset_states(self) -> None:
        self.calls = 0

    def forward(self, x: torch.Tensor, sr: int) -> torch.Tensor:
        self.calls = self.calls + 1
        return torch.sigmoid(400.0 * ((x * x).mean() - 0.02))


@pytest.mark.parametrize("vad", ["energy", "silero"])
def test_vad_segments_match_jax(tmp_path, vad):
    """pdac segments of 12 s into chunks of at most 2 s, and
    ``strip_silence`` of a waveform with a second of faint noise at each
    end: the same samples."""
    wav = speech_and_pauses(np.random.default_rng(11))
    probs = {"jax": None, "port": None}
    if vad == "silero":
        path = tmp_path / "silero.jit"
        torch.jit.script(FakeSilero()).save(str(path))
        probs = {"jax": jvad.make_silero_probs_fn(str(path)),
                 "port": tvad.make_silero_probs_fn(str(path))}
    kw = dict(chunk_size_sec=2.0, pause_length=0.2)
    want = jvad.VADSegmenter(**kw, probs_fn=probs["jax"]).segment_long_input(wav)
    got = tvad.VADSegmenter(**kw, probs_fn=probs["port"]).segment_long_input(wav)
    assert got == want and len(got) >= 6
    assert all(0 < e - s <= 2 * 16000 for s, e in got)
    faint = (np.random.default_rng(12).standard_normal(16000) * 0.004).astype(np.float32)
    padded = np.concatenate([faint, wav[:3 * 16000], faint])
    want = jvad.strip_silence(padded, probs_fn=probs["jax"])
    got = tvad.strip_silence(padded, probs_fn=probs["port"])
    np.testing.assert_array_equal(got, want)
    assert len(got) < len(padded)


def test_spectral_subtract_matches_jax():
    rng = np.random.default_rng(13)
    t = np.arange(3 * 16000) / 16000
    wav = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)
           ).astype(np.float32)
    want = jden.Denoiser.spectral_subtract(wav, 16000)
    got = tden.Denoiser.spectral_subtract(wav, 16000)
    assert got.dtype == np.float32 and got.shape == wav.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


STAND_IN_DEMUCS = """#!{python} -S
# demucs IN.wav -o DIR -n MODEL [--two-stems STEM] [--float32]: writes
# DIR/MODEL/<IN's stem>/<STEM>.wav, here the input halved and at 8 kHz
import os, sys, wave
args = sys.argv[1:]
src, out, model = args[0], args[args.index("-o") + 1], args[args.index("-n") + 1]
stem = args[args.index("--two-stems") + 1]
with wave.open(src, "rb") as r:
    frames = r.readframes(r.getnframes())
import array
x = array.array("h", frames)
y = array.array("h", (v // 2 for v in x[::2]))
d = os.path.join(out, model, os.path.splitext(os.path.basename(src))[0])
os.makedirs(d, exist_ok=True)
with wave.open(os.path.join(d, stem + ".wav"), "wb") as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(8000)
    w.writeframes(y.tobytes())
"""


def test_demucs_shell_out_matches_jax(tmp_path, monkeypatch):
    """The demucs path through a stand-in ``demucs`` script on ``PATH`` (the
    input halved and written at 8 kHz): the same waveform back at 16 kHz,
    and ``denoise`` takes the command where it is found."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    script = bin_dir / "demucs"
    script.write_text(STAND_IN_DEMUCS.format(python=sys.executable))
    script.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    wav = (np.random.default_rng(14).standard_normal(8000) * 0.2).astype(np.float32)
    want = jden.Denoiser()._demucs(wav, 16000)
    got = tden.Denoiser()._demucs(wav, 16000)
    assert got.shape == (8000,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tden.Denoiser().denoise(wav, 16000), got)


def test_profiling_contract_on_a_cpu_trace(tmp_path):
    """``device_trace`` writes a Chrome trace; ``aggregate_trace`` sums its
    events by name for the given categories, largest total first, ``top``
    rows; the block's name is a user annotation; a CPU trace has no device
    events; ``StageTimer`` times and counts stages, and while it records
    spans each stage is one, inside the traced block. The device
    categories' sum is checked on a written trace."""
    def step(x):
        return torch.relu(x @ x)

    timer = profiling.StageTimer()
    timer.enable()
    x = torch.from_numpy(np.random.default_rng(15).standard_normal((64, 64)).astype(np.float32))
    with profiling.device_trace(str(tmp_path / "trace"), annotate="block") as trace:
        for _ in range(3):
            with timer.stage("step", sync_value={"out": [x]}):
                step(x)
    assert trace.path == str(tmp_path / "trace" / "trace.json")
    ops = trace.aggregate(categories=("cpu_op",), top=0)
    names = {name: n for _, n, name in ops}
    assert names["aten::mm"] == 3 and names["aten::relu"] == 3
    assert [r[0] for r in ops] == sorted((r[0] for r in ops), reverse=True)
    assert len(trace.aggregate(categories=("cpu_op",), top=2)) == 2
    ann = {name: n for _, n, name in trace.aggregate(categories=("user_annotation",))}
    assert ann == {"block": 1}
    spans, counters = timer.take()
    assert [s.name for s in spans] == ["step"] * 3 and counters == {}
    assert [s.t1 - s.t0 for s in spans] == timer.times["step"]
    assert trace.aggregate() == []
    summary = timer.summary()
    assert summary["step"]["n"] == 3 and summary["step"]["p50_ms"] > 0
    assert json.loads(timer.report()) == summary

    events = [{"ph": "X", "cat": "kernel", "name": "k_a", "dur": 2.5},
              {"ph": "X", "cat": "kernel", "name": "k_b", "dur": 4.0},
              {"ph": "X", "cat": "kernel", "name": "k_a", "dur": 2.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 1.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 50.0},
              {"ph": "i", "cat": "kernel", "name": "instant", "dur": 9.0}]
    path = tmp_path / "device.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling.aggregate_trace(str(path)) == [
        (4.5e-3, 2, "k_a"), (4e-3, 1, "k_b"), (1e-3, 1, "Memcpy HtoD")]
