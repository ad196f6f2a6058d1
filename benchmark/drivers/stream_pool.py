"""Driver of pooled streaming mixes: ``BatchedStreamingPool`` fed
un-paced.

Each pool step pushes the next 320 ms chunk to every open session whose
source has not ended, then runs ``step()`` and pops every session's
segments; a session whose target has finished is closed and its slot given
to the next session of the seed's order (``harness/traffic.py``). The pool
fills one slot a step, so that sessions stay staggered; the set-up ends
when the last of them has decoded for the first time (``ramp_steps``). The
window then runs whole steps until one ends ``--seconds`` or more after
it; a traced run goes on for ``trace_seconds`` more under the profiler.

Each step is timed on the host around ``step()``, which ends with a
synchronisation of the card, beside the pool's ``last_timings``. Every
session's chunks and popped segments are kept for the correctness check."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

from harness import traffic as tg
from harness import weights as wts
from harness.common import rng, sub_seed
from harness.context import Ctx, Stages, apply_env, host_times, precision_departures
from harness.context import text_tokenizer, unity_config
from harness.trace import TraceRecorder


def raw_weights(config: dict, seed: int, device):
    """The benchmark's seeded weights of the served parts (the UnitY's
    speech encoder, the EMMA decoder), in the checkpoints' dtype."""
    import torch

    from seamless_communication_torch.models.monotonic.model import (
        MonotonicDecoderConfig, monotonic_decoder_init,
    )
    from seamless_communication_torch.models.wav2vec2.encoder import speech_encoder_init

    ucfg = unity_config(config)
    mcfg = MonotonicDecoderConfig(**{k: v for k, v in config["monotonic_decoder"].items()})
    meta = torch.Generator()
    tmpl = {"speech_encoder": speech_encoder_init(meta, ucfg.speech, device="meta"),
            "monotonic_decoder": monotonic_decoder_init(meta, mcfg, device="meta")}
    return wts.draw_tree(tmpl, sub_seed(seed, "weights", config["name"]), device,
                         getattr(torch, config["weights_dtype"]),
                         energy_bias=config["monotonic_decoder"]["energy_bias"])


def build_pool(config: dict, traffic: dict, raw: dict, device, bits=None):
    """The program as the configuration serves it: the EMMA decoder
    quantized by the program (``bits`` 4: its group-wise int4 weights in
    place of int8, the control), the traffic's pool settings."""
    from seamless_communication_torch.models.monotonic.model import MonotonicDecoderConfig
    from seamless_communication_torch.ops.quantization import quantize_params
    from seamless_communication_torch.streaming.multi import BatchedStreamingPool

    ucfg = unity_config(config)
    mcfg = MonotonicDecoderConfig(**config["monotonic_decoder"])
    q = config.get("quantize")
    mono = raw["monotonic_decoder"]
    if q:
        mono = quantize_params(mono, include=tuple(q["linears"]), bits=bits or q["bits"],
                               min_size=q["min_size"])
    return BatchedStreamingPool({"speech_encoder": raw["speech_encoder"]}, ucfg, mono, mcfg,
                                text_tokenizer(config), n_slots=traffic["n_slots"],
                                mono_quantize_int8=False, device=device, **traffic["pool"])


class Feeder:
    """The sessions of a run and the pool steps that serve them."""

    def __init__(self, pool, ctx: Ctx):
        self.pool, self.ctx, self.tr = pool, ctx, ctx.traffic
        self.seg = int(self.tr["chunk_ms"] * 16)
        self.source = tg.RequestSource(self.tr["session_chunks"], ctx.seed, "stream",
                                       quantum_s=1.0)
        self.open: Dict[int, dict] = {}
        self.sessions: List[dict] = []
        self.steps: List[dict] = []
        self.departures = 0

    def open_session(self, step: int) -> None:
        i, n = self.source.next()      # the session's index draws its audio
        wav = tg.noise(self.ctx.seed, "stream", i, int(n) * self.seg,
                       self.tr["noise_std"]) * self.tr["sample_scale"]
        sid = self.pool.open_session(tgt_lang=self.tr["tgt_lang"])
        s = {"sid": sid, "chunks": [wav[k * self.seg:(k + 1) * self.seg]
                                             for k in range(int(n))],
             "next": 0, "ticks": [], "opened": step, "closed": None, "tokens": 0}
        self.open[sid] = s
        self.sessions.append(s)

    def step(self, phase: str, fill: int) -> dict:
        import torch

        k = len(self.steps)
        for _ in range(min(fill, self.tr["n_slots"] - len(self.open))):
            self.open_session(k)
        pushed = 0
        for sid, s in self.open.items():
            if s["next"] < len(s["chunks"]):
                last = s["next"] == len(s["chunks"]) - 1
                self.pool.push(sid, s["chunks"][s["next"]], finished=last)
                s["next"] += 1
                s["ticks"].append({"pushed": True, "segments": []})
                pushed += 1
            else:
                s["ticks"].append({"pushed": False, "segments": []})
        t0 = time.perf_counter()
        self.pool.step()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.departures = max(self.departures, precision_departures(self.ctx.config))
        written = 0
        counts = self.pool.enc_state.n.tolist()
        for sid in list(self.open):
            s = self.open[sid]
            for g in self.pool.pop(sid):
                s["ticks"][-1]["segments"].append([list(g.token_indices), bool(g.finished)])
                written += len(g.token_indices)
                s["tokens"] += len(g.token_indices)
            if self.pool.session_finished(sid):
                s["decisions"] = self.pool.session_decisions(sid)
                self.pool.close_session(sid)
                s["closed"] = k
                del self.open[sid]
        rec = {"t0": t0, "t1": t1, "timings": dict(self.pool.last_timings),
               "pushed": pushed, "tokens": written, "counts": counts, "phase": phase}
        self.steps.append(rec)
        return rec


def run(ctx: Ctx) -> dict:
    import torch

    tr, cfg = ctx.traffic, ctx.config
    apply_env(cfg, ctx.control)
    stage = Stages(ctx)
    raw = raw_weights(cfg, ctx.seed, ctx.device)
    stage("weights drawn")
    pool = build_pool(cfg, tr, raw, ctx.device, bits=4 if ctx.control == "int4" else None)
    del raw
    stage("int8 and the pool")
    feed = Feeder(pool, ctx)
    for _ in range(tr["ramp_steps"]):
        feed.step("ramp", 1)
    stage("ramp steps")
    setup_s = time.perf_counter() - ctx.t_process
    ctx.log(f"set-up {setup_s:.3f} s")

    h0 = host_times()
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    while feed.step("window", tr["n_slots"])["t1"] < deadline:
        pass
    window_end = feed.steps[-1]["t1"]
    host = [b - a for a, b in zip(h0, host_times())]
    trace = None
    if ctx.trace:
        tracer = TraceRecorder()
        tracer.start()
        stop = time.perf_counter() + tr["trace_seconds"]
        while feed.step("trace", tr["n_slots"])["t1"] < stop:
            pass
        tracer.stop()
    memory_peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    departures = max(feed.departures, precision_departures(cfg))
    if ctx.trace:
        trace = tracer.result()
    for sid in list(feed.open):
        pool.close_session(sid)
    feed.pool = pool = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    first = tr["ramp_steps"]
    window = [s for s in feed.steps if s["phase"] == "window"]
    last = first + len(window) - 1
    done = [s for s in feed.sessions if s["closed"] is not None and first <= s["closed"] <= last]
    failed = sum(1 for s in done if s["tokens"] == 0)
    window_s = window_end - t_start
    audio = sum(s["pushed"] for s in window) * tr["chunk_ms"] / 1000.0
    data = {"window_s": window_s, "steps": window, "config": cfg, "traffic": tr,
            "sessions": feed.sessions, "first_step": first, "last_step": last,
            "traced_steps": [s for s in feed.steps if s["phase"] == "trace"]}
    spans = [("pool.step", s["t0"], s["t1"]) for s in data["traced_steps"]]
    spans += [("host: push (feature extraction), pop", a["t1"], b["t0"])
              for a, b in zip(data["traced_steps"], data["traced_steps"][1:])]
    samples = _sample(done, tr["check"]["sessions"], ctx.seed)
    checks = check(ctx, samples)
    checks["precision_switches"] = departures
    before = sum(1 for s in done for t in s["ticks"] if t["pushed"] and t["segments"])
    return {"attempted": len(done), "failed": failed,
            "e2e": {"stream_audio_s_per_s": audio / window_s, "setup_s": setup_s},
            "data": data, "trace": trace, "spans": spans, "checks": checks,
            "memory_peak_bytes": memory_peak,
            "notes": [f"{len(window)} pool steps, {len(done)} sessions finished, "
                      f"{sum(s['tokens'] for s in done)} tokens, rounds that wrote while "
                      f"audio arrived {before}, in {window_s:.3f} s; the host gave the window "
                      f"{host[0]:.3f} s of this thread's CPU, {host[1]:.3f} s of the "
                      f"process's, {host[2]:.3f} s stolen", _step_note(window)]}


def _step_note(steps: List[dict]) -> str:
    """The window's step walls (quartiles) and each stage's total."""
    walls = sorted(s["t1"] - s["t0"] for s in steps)
    q = [walls[int(f * (len(walls) - 1))] for f in (0.25, 0.5, 0.75)] if walls else []
    stages = {}
    for s in steps:
        for k, v in s["timings"].items():
            stages[k] = stages.get(k, 0.0) + v
    return ("step s quartiles " + " ".join(f"{v:.3f}" for v in q) + "; stage s "
            + " ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items()))
            + f"; host between steps {sum(b['t0'] - a['t1'] for a, b in zip(steps, steps[1:])):.3f}")


def _sample(done: List[dict], n: int, seed: int) -> List[dict]:
    """``n`` sessions that finished in the window, drawn from the seed, the
    longest among them."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda j: len(done[j]["chunks"]))
    rest = [j for j in range(len(done)) if j != longest]
    pick = [longest] + [int(j) for j in rng(seed, "check").choice(
        rest, size=min(n - 1, len(rest)), replace=False)]
    return [done[j] for j in pick]


def check(ctx: Ctx, sessions: List[dict]) -> dict:
    """The reference over the sampled sessions, on fresh raw weights."""
    from reference import stream_check

    tr = ctx.traffic
    tok = text_tokenizer(ctx.config)
    policy = dict(tr["pool"], prefix=[tok.vocab_info.eos_idx, tok.lang_token(tr["tgt_lang"])])
    for s in sessions:
        s["prefix"] = policy["prefix"]
    raw = raw_weights(ctx.config, ctx.seed, ctx.device)
    out = stream_check.check(raw, ctx.config, policy, sessions, ctx.device)
    ctx.log(f"check: {len(sessions)} sessions, {out['decisions']} decisions, "
            f"{out['tokens']} tokens; {out['skipped']} decisions of drain rounds after a "
            f"short block not compared")
    return {k: v for k, v in out.items() if k.endswith("gap")}
