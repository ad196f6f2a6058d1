"""The port's span recorder (``utils/profiling.py``: ``StageTimer``,
``TRACER``, ``chrome_trace``) and the spans and counters at the layer
boundaries of the two served paths, on tiny random models on the CPU (the
port's own inits; no JAX):

- the recorder: nesting by thread, spans noted with their bounds,
  counters, ``take`` clearing both, ``stage_end`` with and without a span,
  the Chrome trace; sixteen threads at once lose no span or count;
- ``Translator.predict``: with the recorder off nothing is recorded and
  ``last_timings`` keeps its keys; on, one ``predict.fbank``,
  ``predict.encoder`` and ``predict.text_decode``, each ``beam.step``
  under the decode and over its ``beam.sync`` spans, ``beam.steps`` the
  beam's steps;
- ``DynamicBatcher``: each request's ``batcher.queue`` span carries its
  request id and names its group's ``predict`` as its parent;
- ``BatchedStreamingPool``: ``burst.writes`` the tokens ``pop`` returns,
  ``burst.row_steps`` ``n_slots`` times ``burst.decode_steps``."""

import dataclasses
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from seamless_communication_torch.inference import serving
from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
from seamless_communication_torch.inference.translator import Translator
from seamless_communication_torch.models.monotonic import model as mono
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.unity.model import unity_init
from seamless_communication_torch.models.wav2vec2.encoder import SpeechEncoderConfig
from seamless_communication_torch.ops.conformer import ConformerConfig
from seamless_communication_torch.streaming.multi import BatchedStreamingPool
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
)
from seamless_communication_torch.utils import profiling
from seamless_communication_torch.utils.profiling import TRACER

BASE = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
        ("</s>", 0.0, TYPE_CONTROL)]
WORDS = ["▁" + a + b for a in "abcdefgh" for b in "abcdefgh"]
LANGS = ["__eng__", "__fra__"]
# the chunk-causal card and policy of tests/test_torch_streaming_multi.py
CONF = dict(dim=64, ffn_inner_dim=128, num_heads=4, num_layers=2, depthwise_kernel_size=7,
            pos_type="shaw", shaw_max_left=8, shaw_max_right=3, causal_depthwise_conv=True)
SPEECH = dict(model_dim=64, feature_dim=160, ffn_inner_dim=128, num_adaptor_heads=4,
              chunk_size=4, left_chunk_num=-1)
MONO = dict(model_dim=64, num_layers=2, num_heads=4, ffn_inner_dim=128, vocab_size=256,
            num_monotonic_energy_layers=2, pre_decision_ratio=2)
POOL_KW = dict(min_starting_wait=16, decision_threshold=0.001, max_len_b=12,
               max_consecutive_writes=6, mono_quantize_int8=False)
SEG = 5120  # 320 ms at 16 kHz


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    TRACER.disable()
    TRACER.take()
    yield
    TRACER.disable()
    TRACER.take()


@pytest.fixture(scope="module")
def tokenizer():
    spm = build_spm_model(BASE + [(w, -2.0, TYPE_NORMAL) for w in WORDS])
    return NllbTokenizer(SentencePieceModel.from_bytes(spm), langs=LANGS)


@pytest.fixture(scope="module")
def translator(tokenizer):
    cfg = get_arch("tiny_v2")
    params = unity_init(torch.Generator().manual_seed(0), cfg)
    return Translator(params, cfg, tokenizer,
                      text_opts=SequenceGeneratorOptions(beam_size=2, soft_max_seq_len=(0, 8)),
                      device="cpu")


def noise(seed: int, seconds: float) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(int(seconds * 16000))
            * 0.1).astype(np.float32)


def by_name(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_span_recorder_contract(tmp_path):
    """Spans nest by thread and are taken in the order they end; ``record``
    keeps the caller's bounds; counters sum; ``take`` clears; ``stage_end``
    closes the caller's span or, on, notes one under the stage's name, and
    with no ``timings`` times nothing; the Chrome trace holds a complete
    event a span and the counters."""
    rec = profiling.StageTimer()
    assert not rec.on and rec.take() == ([], {})
    rec.enable()
    outer = rec.begin("outer")
    inner = rec.begin("inner")
    seen = {}

    def other_thread():
        s = rec.begin("other")
        seen["parent"] = s.parent
        rec.end(s)

    t = threading.Thread(target=other_thread)
    t.start()
    t.join()
    rec.end(inner)
    rec.record("queued", 1.0, 2.0, parent=outer.id, request=3)
    rec.count("n")
    rec.count("n", 4)
    timings = {}
    t0 = time.perf_counter()
    now = rec.stage_end(timings, "stage", t0, torch.device("cpu"))
    assert timings["stage"] == now - t0
    s = rec.begin("named")
    rec.stage_end(timings, "second", now, torch.device("cpu"), s)
    assert rec.stage_end(None, "untimed", 5.0, torch.device("cpu")) == 5.0
    rec.end(outer)
    spans, counters = rec.take()
    assert [x.name for x in spans] == ["other", "inner", "queued", "stage", "named", "outer"]
    named = {x.name: x for x in spans}
    assert seen["parent"] is None
    assert named["inner"].parent == outer.id and named["outer"].parent is None
    assert named["outer"].request is None and named["outer"].t0 <= named["inner"].t0
    assert (named["queued"].t0, named["queued"].t1, named["queued"].parent,
            named["queued"].request) == (1.0, 2.0, outer.id, 3)
    assert named["stage"].t0 == t0 and named["stage"].t1 == now
    assert named["named"].parent == outer.id and named["named"].t1 - named["named"].t0 \
        <= timings["second"]
    assert len({x.id for x in spans}) == len(spans)
    assert counters == {"n": 5} and rec.take() == ([], {})
    rec.disable()
    assert rec.stage_end({}, "off", t0, torch.device("cpu")) > t0
    assert rec.take() == ([], {})

    trace = profiling.chrome_trace(spans, counters, str(tmp_path / "spans.json"))
    with open(tmp_path / "spans.json") as f:
        assert json.load(f) == json.loads(json.dumps(trace))
    ev = {e["name"]: e for e in trace["traceEvents"]}
    assert all(e["ph"] == "X" for e in trace["traceEvents"]) and len(ev) == len(spans)
    assert ev["queued"]["ts"] == 1e6 and ev["queued"]["dur"] == 1e6
    assert ev["queued"]["tid"] == "request 3" and ev["inner"]["args"]["parent"] == outer.id
    assert trace["otherData"]["counters"] == {"n": 5}


def test_recorder_loses_nothing_under_threads():
    """Sixteen threads, more than the cores, open nested spans and count at
    once with the interpreter switching threads every microsecond: every
    span and every count is kept, and each span's parent is the span its
    own thread had open."""
    rec = profiling.StageTimer()
    rec.enable()
    n_threads, n_iter = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_iter):
                outer = rec.begin("outer")
                inner = rec.begin("inner")
                rec.count("n")
                rec.end(inner)
                rec.end(outer)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans, counters = rec.take()
    assert counters == {"n": n_threads * n_iter}
    assert len(spans) == 2 * n_threads * n_iter == len({s.id for s in spans})
    outer = {s.id: s for s in spans if s.name == "outer"}
    assert all(s.parent is None for s in outer.values())
    assert all(outer[s.parent].thread == s.thread and outer[s.parent].t0 <= s.t0
               for s in spans if s.name == "inner")


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_predict_spans(translator, on):
    """Off: nothing recorded, ``last_timings`` with its two keys. On: one
    span a stage of ``predict``, the fbank before the encoder, every
    ``beam.step`` under the decode and over its host reads, and
    ``beam.steps`` the steps of the beam's result."""
    if on:
        TRACER.enable()
    translator.predict([noise(1, 1.0), noise(2, 1.5)], "s2tt", "fra")
    TRACER.disable()
    spans, counters = TRACER.take()
    assert set(translator.last_timings) == {"encoder", "text_decode"}
    if not on:
        assert (spans, counters) == ([], {})
        return
    named = by_name(spans)
    fbank, enc, dec = (named[n] for n in ("predict.fbank", "predict.encoder",
                                           "predict.text_decode"))
    assert len(fbank) == len(enc) == len(dec) == 1
    fbank, enc, dec = fbank[0], enc[0], dec[0]
    assert fbank.t1 <= enc.t0 and enc.t1 <= dec.t0
    assert abs((enc.t1 - fbank.t0) - translator.last_timings["encoder"]) < 1e-3
    assert abs((dec.t1 - dec.t0) - translator.last_timings["text_decode"]) < 1e-3
    steps = named["beam.step"]
    assert counters["beam.steps"] == translator.generator.last_result.steps > 0
    assert len(steps) in (counters["beam.steps"], counters["beam.steps"] + 1)
    assert all(s.parent == dec.id for s in steps)
    step_ids = {s.id for s in steps}
    syncs = named["beam.sync"]
    assert all(s.parent in step_ids for s in syncs)
    # a host read a pass of the loop, and a second one a decode step
    assert len(syncs) == len(steps) + counters["beam.steps"]


def test_batcher_queue_spans(translator):
    """Each request's wait is one ``batcher.queue`` span with its request
    id, from its submit to its group's ``predict``, which is its parent and
    holds the group's stages."""
    TRACER.enable()
    batcher = serving.DynamicBatcher(translator, max_batch=4, max_wait_ms=50)
    reqs = [serving._Request("s2tt", "fra", None, noise(10 + i, 1.0)) for i in range(3)]
    threads = [threading.Thread(target=batcher.submit, args=(r, 120.0)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batcher.close()
    TRACER.disable()
    spans, counters = TRACER.take()
    assert all(r.error is None and r.result is not None for r in reqs)
    named = by_name(spans)
    groups = {s.id: s for s in named["predict"]}
    queue = {s.request: s for s in named["batcher.queue"]}
    assert set(queue) == {r.request_id for r in reqs}
    for r in reqs:
        q = queue[r.request_id]
        assert (q.t0, q.t1) == (r.t_enqueued, r.t_started)
        assert q.parent in groups and groups[q.parent].t0 >= q.t1
    assert {s.parent for s in named["predict.fbank"]} <= set(groups)
    assert counters["batcher.requests"] == 3
    assert counters["batcher.groups"] == len(groups)


@pytest.fixture(scope="module")
def pool_models(tokenizer):
    cfg = dataclasses.replace(get_arch("tiny_v2"), speech=SpeechEncoderConfig(
        conformer=ConformerConfig(**CONF), **SPEECH))
    mcfg = mono.MonotonicDecoderConfig(**MONO)
    gen = torch.Generator().manual_seed(3)
    return (cfg, unity_init(gen, cfg), mono.monotonic_decoder_init(gen, mcfg), mcfg)


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_pool_spans_and_burst_counters(pool_models, tokenizer, on):
    """Off: nothing recorded, ``last_timings`` with its stages. On: a push
    span over its feature extraction, the stages' spans inside the step,
    the samples pushed, the tokens written (those ``pop`` returns) and one
    row-step a slot a decode step of the burst."""
    cfg, unity, mono_params, mcfg = pool_models
    n_slots = 3
    pool = BatchedStreamingPool(unity, cfg, mono_params, mcfg, tokenizer, n_slots=n_slots,
                                device="cpu", **POOL_KW)
    n_chunks = 4      # the policy's first decode waits for the third chunk
    t = np.arange(n_chunks * SEG) / 16000
    sids = [pool.open_session(tgt_lang="eng") for _ in range(2)]
    popped, pushed = 0, 0
    if on:
        TRACER.enable()
    for j in range(n_chunks):
        for k, sid in enumerate(sids):
            chunk = (3000 * np.sin(2 * np.pi * (300 + 140 * k) * t[j * SEG:(j + 1) * SEG])
                     ).astype(np.float32)
            pool.push(sid, chunk, finished=j == n_chunks - 1)
            pushed += chunk.size
        pool.step()
        popped += sum(len(g.token_indices) for sid in sids for g in pool.pop(sid))
    TRACER.disable()
    spans, counters = TRACER.take()
    assert set(pool.last_timings) == {"encoder", "prefill", "burst"}
    if not on:
        assert (spans, counters) == ([], {})
        return
    named = by_name(spans)
    assert popped > 0 and counters["burst.writes"] == popped
    assert counters["burst.row_steps"] == n_slots * counters["burst.decode_steps"]
    assert counters["pool.audio_samples"] == pushed
    assert counters["pool.chunks"] == len(named["pool.chunk"]) > 0
    pushes = {s.id for s in named["pool.push"]}
    assert len(pushes) == 2 * n_chunks and all(s.parent in pushes or s.parent in
                                    {x.id for x in named["pool.step"]}
                                    for s in named["pool.fbank"])
    chunks = {s.id for s in named["pool.chunk"]}
    assert all(s.parent in chunks for n in ("pool.encoder", "pool.prefill", "pool.burst")
               for s in named[n])
    bursts = {s.id for s in named["pool.burst"]}
    assert named["burst.sync"] and all(s.parent in bursts for s in named["burst.sync"])
