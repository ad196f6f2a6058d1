"""Driver of served-request mixes: ``DynamicBatcher`` over a
``Translator``, fed by a closed loop of clients.

Each client sends its next request when its reply comes; requests are
handed out in the seed's order (``harness/traffic.py``). The window opens
when the clients start and closes at the end of the first batched
``predict`` that ends ``--seconds`` or more after it, so that it holds whole
groups; the groups that start after it are not run (the wrapper around
``predict`` answers them empty) and are not counted. In a traced run the
loop goes on for ``trace_seconds`` more, under the profiler, before it
closes.

The wrapper around ``predict`` is the benchmark's: it notes each call's
host interval, what the host gave it (``host_times``), its
``last_timings``, its rows and the beam's result
(``generator.last_result``), which the correctness check reads after the
window, and whether torch's float32 switches still run at the
configuration's precision."""

from __future__ import annotations

import gc
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from harness import traffic as tg
from harness import weights as wts
from harness.common import rng, sub_seed
from harness.context import Ctx, Stages, apply_env, host_times, precision_departures
from harness.context import text_tokenizer, unity_config
from harness.trace import TraceRecorder


def raw_weights(config: dict, seed: int, device):
    """The benchmark's seeded weights of the served parts, in the
    checkpoint's dtype."""
    import torch

    from seamless_communication_torch.models.nllb.model import text_decoder_init
    from seamless_communication_torch.models.wav2vec2.encoder import speech_encoder_init

    ucfg = unity_config(config)
    meta = torch.Generator()
    tmpl = {"speech_encoder": speech_encoder_init(meta, ucfg.speech, device="meta"),
            "text_decoder": text_decoder_init(meta, ucfg.nllb, device="meta")}
    return wts.draw_tree(tmpl, sub_seed(seed, "weights", config["name"]), device,
                         getattr(torch, config["weights_dtype"]))


def build_translator(config: dict, traffic: dict, raw: dict, device, kv_bits=None):
    """The program as the configuration serves it: int8 weight-only
    (the program's own quantization of the raw tree), beam and KV cache as
    stated (``kv_bits`` 4: the program's packed-int4 KV cache in its place,
    the control), the traffic's length limit."""
    from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.ops.quantization import quantize_params

    ucfg = unity_config(config)
    dec = config["text_decoder"]
    n = ucfg.nllb
    if (n.dim, n.num_decoder_layers, n.num_heads, n.ffn_inner_dim, n.vocab_size) != (
            dec["dim"], dec["num_layers"], dec["num_heads"], dec["ffn_inner_dim"],
            dec["vocab_size"]):
        raise SystemExit(f"{config['name']}: the arch's decoder {n} is not the file's {dec}")
    q = config.get("quantize")
    params = (quantize_params(raw, include=tuple(q["linears"]), bits=q["bits"],
                              min_size=q["min_size"]) if q else raw)
    opts = SequenceGeneratorOptions(
        beam_size=config["beam_size"], len_penalty=config["len_penalty"],
        soft_max_seq_len=tuple(traffic["soft_max_seq_len"]),
        kv_cache_int8=config["kv_cache"]["bits"] == 8,
        kv_cache_bits=kv_bits or config["kv_cache"]["bits"])
    return Translator(params, ucfg, text_tokenizer(config), text_opts=opts,
                      normalize_fbank=config["speech_encoder"]["normalize_fbank"],
                      device=device)


class Recorder:
    """Stands in for the Translator in front of the batcher: runs
    ``predict`` and notes each call. After ``close_at`` (host seconds) the
    call that ends first closes the window; in a traced run the profiler
    then runs for ``trace_s`` more and the next call to end closes the
    traced window. Calls after that answer empty."""

    def __init__(self, translator, wav_ids: Dict[int, int], config: dict):
        self.t = translator
        self.config = config
        self.departures = 0
        self.wav_ids = wav_ids
        self.calls: List[dict] = []
        self.close_at = math.inf
        self.trace_s = 0.0
        self.tracer: Optional[TraceRecorder] = None
        self.window_end: Optional[float] = None
        self.done = threading.Event()

    def predict(self, inputs, task, tgt_lang, **kw):
        if self.done.is_set():
            return [""] * len(inputs), None
        h0 = host_times()
        t0 = time.perf_counter()
        texts, speech = self.t.predict(inputs, task, tgt_lang, **kw)
        t1 = time.perf_counter()
        h1 = host_times()
        self.departures = max(self.departures, precision_departures(self.config))
        res = self.t.generator.last_result
        self.calls.append({"t0": t0, "t1": t1, "timings": dict(self.t.last_timings),
                           "host": [b - a for a, b in zip(h0, h1)],
                           "ids": [self.wav_ids[id(w)] for w in inputs],
                           "steps": int(res.steps), "T": int(res.tokens.shape[2]),
                           "result": res, "traced": self.window_end is not None})
        if self.window_end is None and t1 >= self.close_at:
            self.window_end = t1
            if self.tracer is None:
                self.done.set()
            else:
                self.tracer.start()
                self.close_at = time.perf_counter() + self.trace_s
        elif self.window_end is not None and self.tracer is not None and t1 >= self.close_at:
            self.tracer.stop()
            self.done.set()
        return texts, speech


def warm_up(translator, traffic: dict, seed: int) -> None:
    """The cell's shapes: one full group of the longest audio, the decode
    cut to its shortest bucket."""
    from seamless_communication_torch.inference.generator import SequenceGeneratorOptions

    w = traffic["warmup"]
    n = int(w["audio_s"] * 16000)
    wavs = [tg.noise(seed, "warmup", i, n, traffic["noise_std"]) for i in range(w["group"])]
    opts = SequenceGeneratorOptions(
        beam_size=translator.generator.text_opts.beam_size,
        len_penalty=translator.generator.text_opts.len_penalty,
        soft_max_seq_len=tuple(w["soft_max_seq_len"]),
        kv_cache_int8=translator.generator.text_opts.kv_cache_int8,
        kv_cache_bits=translator.generator.text_opts.kv_cache_bits)
    translator.predict(wavs, traffic["task"], traffic["tgt_lang"], text_generation_opts=opts)


def run(ctx: Ctx) -> dict:
    import torch

    from seamless_communication_torch.inference import serving

    tr, cfg = ctx.traffic, ctx.config
    apply_env(cfg, ctx.control)
    stage = Stages(ctx)
    raw = raw_weights(cfg, ctx.seed, ctx.device)
    stage("weights drawn")
    translator = build_translator(cfg, tr, raw, ctx.device,
                                  kv_bits=4 if ctx.control == "int4" else None)
    del raw
    stage("int8 and the translator")
    warm_up(translator, tr, ctx.seed)
    stage("warm-up group")

    # the requests a window can reach, drawn before it, so that no client
    # draws audio on the host while the worker launches
    source = tg.RequestSource(tr["audio_seconds"], ctx.seed, "serve")
    ready = [(i, secs, tg.noise(ctx.seed, "serve", i, int(secs * 16000), tr["noise_std"]))
             for i, secs in (source.next() for _ in range(tr["prepared_requests"]))]
    ready.reverse()
    stage("requests drawn")
    wav_ids: Dict[int, int] = {}
    requests: Dict[int, dict] = {}
    lock = threading.Lock()
    # the clients start together, so that the first group fills as later ones do
    start = threading.Barrier(tr["clients"] + 1)
    setup_s = time.perf_counter() - ctx.t_process
    ctx.log(f"set-up {setup_s:.3f} s")
    rec = Recorder(translator, wav_ids, cfg)
    batcher = serving.DynamicBatcher(rec, max_batch=tr["max_batch"],
                                     max_wait_ms=tr["max_wait_ms"])
    if ctx.trace:
        rec.tracer = TraceRecorder()
        rec.trace_s = tr["trace_seconds"]

    def client():
        start.wait()
        while not rec.done.is_set():
            with lock:
                item = ready.pop() if ready else None
            if item is None:
                i, secs = source.next()
                item = (i, secs, tg.noise(ctx.seed, "serve", i, int(secs * 16000),
                                          tr["noise_std"]))
            i, secs, wav = item
            with lock:
                wav_ids[id(wav)] = i
            req = serving._Request(tr["task"], tr["tgt_lang"], None, wav)
            t0 = time.perf_counter()
            batcher.submit(req, timeout=tr["request_timeout_s"])
            requests[i] = {"audio_s": secs, "t0": t0, "t1": time.perf_counter(),
                           "error": req.error, "wav": wav}

    threads = [threading.Thread(target=client, daemon=True) for _ in range(tr["clients"])]
    for t in threads:
        t.start()
    t_start = time.perf_counter()
    rec.close_at = t_start + ctx.seconds
    start.wait()
    if not rec.done.wait(ctx.seconds + tr["request_timeout_s"]):
        raise RuntimeError("no batched call ended after the window's length")
    # the groups still queued are answered empty; then the worker stops
    for t in threads:
        t.join(timeout=tr["request_timeout_s"])
    batcher.close()
    memory_peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    departures = max(rec.departures, precision_departures(cfg))

    window = [c for c in rec.calls if not c["traced"]]
    for c in rec.calls:
        c["audio_s"] = [requests[i]["audio_s"] for i in c["ids"]]
    ids = [i for c in window for i in c["ids"]]
    served = [requests[i] for i in ids if i in requests]
    failed = sum(1 for r in served if r["error"])
    window_s = rec.window_end - t_start
    audio = sum(r["audio_s"] for r in served if not r["error"])
    data = {"window_s": window_s, "calls": window, "requests": served,
            "config": cfg, "traffic": tr}
    trace = spans = None
    if ctx.trace:
        trace = rec.tracer.result()
        traced = [c for c in rec.calls if c["traced"]]
        data["traced_calls"] = traced
        spans = _spans(traced)
    # the check's sample, drawn from the seed: the longest request and others
    samples = _sample(window, requests, tr["check"]["requests"], ctx.seed)
    del batcher, rec, translator
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, samples)
    checks["precision_switches"] = departures
    return {"attempted": len(served), "failed": failed,
            "e2e": {"serve_audio_s_per_s": audio / window_s, "setup_s": setup_s},
            "data": data, "trace": trace, "spans": spans, "checks": checks,
            "memory_peak_bytes": memory_peak,
            "notes": [f"{len(window)} groups, {len(served)} requests in {window_s:.3f} s; "
                      "each group's size: wall s / worker CPU s / process CPU s / stolen s "
                      "/ decode steps / encoder s / text decode s: " + ", ".join(
                          f"{len(c['ids'])}: {c['t1'] - c['t0']:.3f} / "
                          + " / ".join(f"{v:.3f}" for v in c["host"])
                          + f" / {c['steps']} / {c['timings'].get('encoder', 0.0):.3f}"
                          f" / {c['timings'].get('text_decode', 0.0):.3f}" for c in window)]}


def _spans(calls: List[dict]) -> list:
    """Host spans of the traced calls: the encoder (host fbank included),
    the text decode, and the rest of predict."""
    out = []
    for c in calls:
        t, tm = c["t0"], c["timings"]
        enc = t + tm.get("encoder", 0.0)
        dec = enc + tm.get("text_decode", 0.0)
        out += [("predict: host fbank + speech encoder", t, enc),
                ("predict: text decode (beam search)", enc, dec),
                ("predict: detokenize, return", dec, c["t1"])]
    return out


def _sample(calls: List[dict], requests: Dict[int, dict], n: int, seed: int) -> List[dict]:
    """``n`` requests the window served, drawn from the seed, the longest
    among them, with the program's hypotheses."""
    rows = [(c, r, i) for c in calls for r, i in enumerate(c["ids"])
            if i in requests and not requests[i]["error"]]
    if not rows:
        return []
    longest = max(range(len(rows)), key=lambda j: requests[rows[j][2]]["audio_s"])
    rest = [j for j in range(len(rows)) if j != longest]
    pick = [longest] + list(rng(seed, "check").choice(rest, size=min(n - 1, len(rest)),
                                                       replace=False))
    out = []
    for j in pick:
        c, r, i = rows[j]
        res = c["result"]
        out.append({"id": i, "wav": requests[i]["wav"], "T": c["T"],
                    "tokens": res.tokens[r].cpu().numpy(),
                    "lengths": res.lengths[r].cpu().numpy(),
                    "scores": res.scores[r].double().cpu().numpy()})
    return out


def check(ctx: Ctx, samples: List[dict]) -> dict:
    """The reference over the sample, on fresh raw weights of the seed."""
    from reference import serve_check

    raw = raw_weights(ctx.config, ctx.seed, ctx.device)
    out = serve_check.check(raw, ctx.config, samples, ctx.device)
    ctx.log(f"check: {out['hypotheses']} hypotheses of {len(samples)} requests, "
            f"{out['tokens']} tokens")
    res = {k: v for k, v in out.items() if k.endswith("gap")}
    # read beside the widest, not compared: how the distances spread
    res["score_gap_median"] = float(np.median(out["gaps"])) if out["gaps"] else None
    return res
