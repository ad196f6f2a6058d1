"""The port's streaming evaluation against the JAX package, on the CPU:

- ``streaming/evaluator.py``: ``average_lagging`` (AL and LAAL) on fixed
  delays, ``score_streaming_text`` (with sacrebleu BLEU) and
  ``score_streaming_speech`` equal to JAX's; the ASR-BLEU plug-in case of
  tests/unit/test_aux_clis.py on the port, and a 24 kHz instance resampled
  to 16 kHz before the transcriber sees it;
- ``streaming/agents/vad.py``: ``VADAgent``'s output segments equal JAX's on
  a fixed chunk sequence (speech, silence past the limit, the source's end);
- one expressive stream with ``use_vad=True`` (a 6 s input with a 1 s
  silence) equal to JAX's pipeline (the setup of
  tests/test_torch_expressive_streaming.py);
- ``cli/metrics.py``: BLEU and chrF++ equal to sacrebleu's on random
  corpora; ``cli/eval_utils.py``: corpus BLEU and chrF, WER and CER, the
  normalizers and ``compute_quality_metrics`` equal to JAX's (which calls
  sacrebleu); ``make_whisper_transcriber``
  with a stand-in ``transformers`` (no Whisper weights exist here);
- ``cli/streaming_evaluate.py main`` on the tiny streaming models (loaders
  patched to return them) writes the metrics of ``evaluate_streaming`` over
  the same pipeline."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from seamless_communication_tpu.cli import eval_utils as jeu
from seamless_communication_tpu.streaming import evaluator as jev
from seamless_communication_tpu.streaming import pipeline as jpipe
from seamless_communication_tpu.streaming.agents import common as jcommon
from seamless_communication_tpu.streaming.agents import vad as jvad

from seamless_communication_torch.audio.wav import read_wav, resample, write_wav
from seamless_communication_torch.cli import eval_utils as teu
from seamless_communication_torch.streaming import evaluator as tev
from seamless_communication_torch.streaming import pipeline
from seamless_communication_torch.streaming.agents import common
from seamless_communication_torch.streaming.agents import vad as tvad

from test_torch_expressive_streaming import (  # noqa: F401 (module fixtures)
    _expressive, models, pretssel, same_speech,
)
from test_torch_pretssel import jcfg, tcfg
from test_torch_streaming import decoder, run

DELAYS = [
    ([320.0, 640.0, 640.0, 1280.0, 1600.0], 1500.0, 5),
    ([320.0, 320.0, 960.0], 2000.0, 6),
    ([2000.0, 2500.0], 1800.0, 2),
    ([], 1000.0, 0),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", range(len(DELAYS)))
@pytest.mark.parametrize("adaptive", [False, True])
def test_average_lagging_matches_jax(case, adaptive):
    delays, source_ms, n = DELAYS[case]
    got = tev.average_lagging(delays, source_ms, n, length_adaptive=adaptive)
    assert got == jev.average_lagging(delays, source_ms, n, length_adaptive=adaptive)


def _instances(mod):
    insts = []
    for i, (delays, source_ms, n) in enumerate(DELAYS[:3]):
        words = [f"w{j}" for j in range(len(delays))]
        inst = mod.StreamingInstance(source_duration_ms=source_ms, delays_ms=list(delays),
                                     target_tokens=words, target_text=" ".join(words))
        if i < 2:
            inst.first_wav_offset_ms = 320.0 * (i + 1)
            inst.last_wav_end_ms = source_ms + 100.0 * (i + 1)
        insts.append(inst)
    return insts


def test_scores_match_jax():
    refs = ["w0 w1 w2 w3 w4", "w0 w1 w9", "w0 w1"]
    got = tev.score_streaming_text(_instances(tev), refs)
    assert got == jev.score_streaming_text(_instances(jev), refs)
    assert set(got) == {"AL_ms", "LAAL_ms", "bleu"}
    assert tev.score_streaming_text(_instances(tev)) == jev.score_streaming_text(
        _instances(jev))
    assert tev.score_streaming_speech(_instances(tev)) == jev.score_streaming_speech(
        _instances(jev))
    empty = tev.score_streaming_speech([tev.StreamingInstance(1000.0)])
    assert np.isnan(empty["StartOffset_ms"]) and np.isnan(empty["EndOffset_ms"])


@pytest.mark.parametrize("rate", [16000, 24000])
def test_asr_bleu_plugin(monkeypatch, rate):
    """JAX's ASR-BLEU plug-in case on the port: the emitted speech is joined
    and scored by the pluggable transcriber; speech at 24 kHz reaches it
    resampled to 16 kHz, and its duration counts at 24 kHz."""
    class FakeSession:
        def __init__(self, pipeline, **kw):
            pass

        def run(self, wav):
            yield 0, common.SpeechSegment(content=np.ones(160, np.float32),
                                          sample_rate=rate, finished=False)
            yield 1, common.SpeechSegment(content=np.ones(160, np.float32),
                                          sample_rate=rate, finished=True)

    calls = {}

    def transcribe(wavs):
        calls["n"] = len(wavs)
        calls["samples"] = [len(w) for w in wavs]
        return ["hello world this is just fine"] * len(wavs)

    monkeypatch.setattr(pipeline, "StreamingSession", FakeSession)
    metrics = tev.evaluate_streaming(
        lambda: None, [np.zeros(16000, np.float32)],
        references=["hello world this is just fine"], output_is_speech=True,
        transcribe=transcribe)
    assert calls == {"n": 1, "samples": [len(resample(np.ones(320, np.float32), rate,
                                                      16000))]}
    assert metrics["asr_bleu"] == pytest.approx(100.0)
    assert metrics["StartOffset_ms"] == 320.0
    assert metrics["EndOffset_ms"] == pytest.approx(640.0 + 320 / rate * 1000 - 1000.0)
    assert metrics["num_instances"] == 1


def _chunks():
    """320 ms chunks: speech, speech, silence x3 (960 ms, past the 700 ms
    limit), speech, then silence at the source's end."""
    rng = np.random.default_rng(9)
    speech = lambda: (rng.standard_normal(5120) * 0.3 * np.repeat(  # noqa: E731
        rng.uniform(0.1, 1.0, 10), 512)).astype(np.float32)
    silence = np.zeros(5120, np.float32)
    return [speech(), speech(), silence, silence, silence, speech(), silence]


def test_vad_agent_matches_jax():
    chunks = _chunks()
    outs = {}
    for name, mod, cmod in (("jax", jvad, jcommon), ("port", tvad, common)):
        agent = mod.VADAgent()
        seq = []
        for i, c in enumerate(chunks):
            agent.push(cmod.SpeechSegment(content=list(c), tgt_lang="eng",
                                          finished=i == len(chunks) - 1))
            seg = agent.pop()
            seq.append((type(seg).__name__, None if seg.is_empty else
                        np.asarray(seg.content, np.float32).tobytes(), seg.finished,
                        agent.states.speech_started, agent.states.consecutive_silence_ms))
        agent.push(cmod.EmptySegment(finished=True))
        seg = agent.pop()
        seq.append((type(seg).__name__, seg.finished))
        outs[name] = seq
    assert outs["port"] == outs["jax"]
    kinds = [s[0] for s in outs["port"]]
    assert kinds.count("SpeechSegment") >= 3 and "EmptySegment" in kinds
    assert outs["port"][-1] == ("EmptySegment", True)


def test_expressive_stream_with_vad_matches_jax(models, pretssel):
    """``build_expressive_s2st_pipeline(use_vad=True)``: the VAD agent first,
    then JAX's segments, tokens, units and waveforms on a 6 s input with a
    1 s silence."""
    jm, tm = models
    p, tp, mean, std = pretssel
    wav = (np.random.default_rng(6).standard_normal(6 * 16000) * 0.1).astype(np.float32)
    wav[2 * 16000:3 * 16000] = 0.0
    pipe = _expressive(tm, pipeline.build_expressive_s2st_pipeline, tp, tcfg(), mean, std,
                       False, "cfg", use_vad=True, device="cpu")
    jp = _expressive(jm, jpipe.build_expressive_s2st_pipeline, p, jcfg(), mean, std,
                     False, "cfg", use_vad=True)
    assert type(pipe.agents[0]).__name__ == "VADAgent"
    got = run(pipe, pipeline.StreamingSession, wav)
    same_speech(got, run(jp, jpipe.StreamingSession, wav))
    assert list(decoder(pipe).states.target_indices) == list(
        decoder(jp).states.target_indices)
    assert any(k == "SpeechSegment" and c.size for _, k, c, _ in got)


WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "barks", ",", ".", "don't", "(laugh)",
         "3.5", "x-ray", "&amp;", "&quot;hi&quot;", "日本語", "naïve", "!", "?", "-", "<skipped>"]


@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_sacrebleu(seed):
    """``cli/metrics.py`` against sacrebleu itself: corpus BLEU with the 13a
    and char tokenizers and chrF++ equal to the last bit on random corpora
    (punctuation, numbers, entities, CJK, empty and trailing-space lines)."""
    import random

    import sacrebleu

    from seamless_communication_torch.cli import metrics

    rnd = random.Random(seed)
    for _ in range(50):
        def line():
            return " ".join(rnd.choice(WORDS) for _ in range(rnd.randint(0, 12))) + \
                rnd.choice(["", " ", ".", " ."])
        n = rnd.randint(1, 6)
        hyps, refs = [line() for _ in range(n)], [line() for _ in range(n)]
        for tok in ("13a", "char"):
            assert metrics.corpus_bleu(hyps, refs, tokenize=tok) == \
                sacrebleu.corpus_bleu(hyps, [refs], tokenize=tok).score
        assert metrics.corpus_chrf(hyps, refs) == \
            sacrebleu.corpus_chrf(hyps, [refs], word_order=2).score


HYPS = ["the cat sat on the mat", "a dog", "Won't you (laugh) come [noise] HOME?",
        "naïve café, déjà vu"]
REFS = ["the cat sat on a mat", "the dog", "won't you come home", "naive cafe deja vu"]


@pytest.mark.parametrize("lang", ["eng", "cmn", "fra"])
def test_eval_utils_match_jax(lang):
    for metric in ("bleu", "chrf"):
        assert teu.compute_corpus_metric_score(HYPS, REFS, lang=lang, metric=metric) == \
            jeu.compute_corpus_metric_score(HYPS, REFS, lang=lang, metric=metric)
    assert teu.compute_asr_error_rate(HYPS, REFS, lang=lang) == \
        jeu.compute_asr_error_rate(HYPS, REFS, lang=lang)
    for h in HYPS + REFS:
        assert teu.whisper_normalize_text(h, lang) == jeu.whisper_normalize_text(h, lang)
        for english in (False, True):
            assert teu._basic_normalize(h, english=english) == \
                jeu._basic_normalize(h, english=english)
    assert teu.get_tokenizer(lang) == jeu.get_tokenizer(lang)
    with pytest.raises(ValueError):
        teu.compute_corpus_metric_score(HYPS, REFS, metric="meteor")


def test_quality_metrics_and_asr_bleu_match_jax(tmp_path):
    got = teu.compute_quality_metrics(HYPS, REFS, lang="eng", task="asr",
                                      output_path=str(tmp_path / "t" / "s.json"))
    want = jeu.compute_quality_metrics(HYPS, REFS, lang="eng", task="asr")
    assert got == want and set(got) == {"bleu", "chrf", "wer"}
    assert json.loads((tmp_path / "t" / "s.json").read_text()) == got
    fake = lambda wavs: HYPS[:len(wavs)]  # noqa: E731
    wavs = [np.zeros(160, np.float32)] * 4
    assert teu.compute_asr_bleu(wavs, REFS, transcribe=fake) == \
        jeu.compute_asr_bleu(wavs, REFS, transcribe=fake)
    with pytest.raises(ValueError):
        teu.compute_asr_bleu(wavs, REFS)


def test_make_whisper_transcriber_with_a_stand_in(monkeypatch):
    """The lazy ``transformers`` import, the device and the reference's
    greedy decoding, through a stand-in module (no Whisper weights here)."""
    seen = {}

    class Feats:
        def __init__(self, n):
            self.input_features = torch.full((1, 2), float(n))

    class Processor:
        @classmethod
        def from_pretrained(cls, name):
            seen["processor"] = name
            return cls()

        def __call__(self, wav, sampling_rate, return_tensors):
            seen["rate"] = sampling_rate
            return Feats(len(wav))

        def get_decoder_prompt_ids(self, language, task):
            seen["prompt"] = (language, task)
            return [(1, 7)]

        def batch_decode(self, ids, skip_special_tokens):
            return [f"n{int(ids[0, 0])}"]

    class Model:
        @classmethod
        def from_pretrained(cls, name):
            return cls()

        def to(self, device):
            seen["device"] = str(device)
            return self

        def eval(self):
            return self

        def generate(self, feats, num_beams, do_sample, **kw):
            seen["gen"] = (num_beams, do_sample, kw["forced_decoder_ids"])
            return feats.long()

    mod = types.ModuleType("transformers")
    mod.WhisperProcessor, mod.WhisperForConditionalGeneration = Processor, Model
    monkeypatch.setitem(sys.modules, "transformers", mod)
    fn = teu.make_whisper_transcriber("ckpt", lang="fra", device="cpu")
    assert fn([np.zeros(5), np.zeros(9)]) == ["n5", "n9"]
    assert seen == {"processor": "ckpt", "device": "cpu", "rate": 16000,
                    "prompt": ("fr", "transcribe"), "gen": (1, False, [(1, 7)])}


def test_streaming_evaluate_cli(models, tmp_path, monkeypatch):
    """``streaming_evaluate.main`` (S2TT, silence kept) over the tiny
    streaming models writes the metrics ``evaluate_streaming`` gives over
    the same pipeline."""
    from seamless_communication_torch.cli import loading, streaming_evaluate

    _, tm = models
    for i, seconds in enumerate((1.5, 2.2)):
        wav = (np.random.default_rng(i).standard_normal(int(seconds * 16000))
               * 0.1).astype(np.float32)
        write_wav(str(tmp_path / f"{i}.wav"), wav, 16000)
    (tmp_path / "data.tsv").write_text("audio\ttgt_text\n0.wav\taa bb\n1.wav\tcc\n")
    monkeypatch.setattr(loading, "load_unity_model_and_tokenizers",
                        lambda *a, **kw: (tm["unity"], tm["cfg"], tm["text"], tm["units"],
                                          tm["chars"]))
    monkeypatch.setattr(loading, "load_monotonic_decoder",
                        lambda *a, **kw: (tm["mono"], tm["mono_cfg"]))
    got = streaming_evaluate.main([
        "--data-file", str(tmp_path / "data.tsv"), "--audio-root-dir", str(tmp_path),
        "--task", "s2tt", "--no-strip-silence", "--decision-threshold", "0.001",
        "--min-starting-wait-w2vbert", "16", "--output", str(tmp_path / "out"),
        "--device", "cpu"])
    wavs = [read_wav(str(tmp_path / f"{i}.wav"))[0] for i in range(2)]
    want = tev.evaluate_streaming(
        lambda: pipeline.build_s2t_pipeline(
            tm["unity"], tm["cfg"], tm["mono"], tm["mono_cfg"], tm["text"],
            min_starting_wait_w2vbert=16, decision_threshold=0.001, device="cpu"),
        wavs, references=["aa bb", "cc"])
    assert got == want
    assert json.loads((tmp_path / "out" / "metrics.json").read_text()) == got
    assert got["num_instances"] == 2 and set(got) >= {"AL_ms", "LAAL_ms", "bleu"}
