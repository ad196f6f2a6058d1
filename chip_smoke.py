#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Three phases; any failure exits non-zero.

1. Device: requires CUDA, prints the card's name and power limit, turns TF32
   off for the parity phases, builds every kernel of ``csrc/`` (one ``nvcc``
   each, all at once) and prints the build seconds.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path, with the stated tolerance; median times with CUDA events
   beside the bound (bytes over 3.35 TB/s).
3. The main path at full width: the port's ``base_v2`` (v2-large) speech
   encoder and NLLB decoder on random bf16 weights from a seeded
   ``torch.Generator``, int8 weight-only, served through
   ``Translator.predict(wav, "s2tt", "eng")`` with beam 5 and an int8 KV
   cache, for three requests; the decode-attention kernel must be launched
   24 times per decode step. Then ``tiny_v2`` on the card and on the CPU must
   give the same tokens.

The line before the last is a JSON object listing every kernel with its
launches on the main path, error, times and bound; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.

    python3 chip_smoke.py --profile

builds the kernels and profiles one 10 s base_v2 request instead (where the
main path's time goes; the table lands in ``chiprun_out/profile_s2tt.txt``).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
B_MAIN, H_MAIN, T_MAIN, DH_MAIN = 5, 16, 320, 64
STEP_TIMED = 200                   # a mid-utterance step of a T=320 cache


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, *, calls: int = 20, reps: int = 50) -> float:
    """Device time of one call of ``fn``: ``calls`` calls are captured into
    one CUDA graph, the graph is replayed ``reps`` times between CUDA events,
    and the median replay time is divided by ``calls``. Eager calls would
    time the host's launch overhead as well, since the card idles while
    Python prepares each launch."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def eager_time_ms(fn, *, iters: int = 50) -> float:
    """Median host wall time of one eager call, synchronized: what a caller
    pays per call, launch overhead included."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)                     # the card, as nvidia-smi names it
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from seamless_communication_torch.ops.kernels import build

    t0 = time.time()
    reports = build.build()
    log(f"kernels built in {time.time() - t0:.2f} s: {build.kernel_sources()}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return {"smi": smi}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def phase_decode_attention() -> dict:
    """K1 against its plain version at B=5, H=16, T=320, Dh=64."""
    import numpy as np
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    B, H, T, Dh = B_MAIN, H_MAIN, T_MAIN, DH_MAIN
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def t(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    src = t(np.array([3, 0, 3, 1, 1]), torch.int32)     # repeated origins
    # caches as the main path fills them: rows of unit-variance K/V,
    # quantized by absmax/127 per row
    kq, ks = da.quantize_kv_rows(t(rng.standard_normal((B, H, T, Dh)), torch.float32))
    vq, vs = da.quantize_kv_rows(t(rng.standard_normal((B, H, T, Dh)), torch.float32))
    caches = (kq, vq, ks, vs)
    tol = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
    max_err = 0.0
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        vecs = [t(rng.standard_normal((B, H, Dh)), dtype) for _ in range(3)]
        for step in (0, 1, 137, T - 1):
            args = (*vecs, *caches, step, src)
            got = da.fused_decode_self_attention_int8(*args)
            ref = da._reference(*args)
            torch.cuda.synchronize()
            for name, g, r in zip(("new_k", "new_v", "new_ks", "new_vs"),
                                  got[1:], ref[1:]):
                if not torch.equal(g, r):
                    bad = int((g != r).sum())
                    raise AssertionError(f"K1 {dtype} step {step}: {name} "
                                         f"differs in {bad} entries")
            err = (got[0].float() - ref[0].float()).abs()
            lim = tol[dtype] * (1 + ref[0].float().abs())
            if not bool((err <= lim).all()):
                raise AssertionError(f"K1 {dtype} step {step}: out max err "
                                     f"{float(err.max()):.3g} over tolerance")
            if dtype is torch.float32:
                max_err = max(max_err, float(err.max()))
            log(f"K1 {str(dtype):15s} step {step:3d}: caches exact, out max abs "
                f"err {float(err.max()):.3g} (rtol=atol={tol[dtype]})")
        args = (*vecs, *caches, STEP_TIMED, src)
        kernel = lambda: da.fused_decode_self_attention_int8(*args)
        plain = lambda: da._reference(*args)
        times[dtype] = (cuda_time_ms(kernel), cuda_time_ms(plain),
                        eager_time_ms(kernel), eager_time_ms(plain))
    n_src = len(set(src.tolist()))
    bounds = {}
    for dtype in times:
        elem = torch.finfo(dtype).bits // 8
        bytes_s = da.bound_bytes(B, H, T, Dh, n_src=n_src, elem=elem) / HBM_BYTES_PER_S
        # two products of Dh over the history rows, as fp32 arithmetic
        flops_s = 4 * B * H * STEP_TIMED * Dh / PEAK_FP32_FLOPS
        bounds[dtype] = (max(bytes_s, flops_s) * 1e3,
                         "bytes" if bytes_s >= flops_s else "operations")
    for dtype, (k_ms, p_ms, k_eager, p_eager) in times.items():
        log(f"K1 time {str(dtype):15s} at step {STEP_TIMED}: device kernel "
            f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
            f"{bounds[dtype][0] * 1e3:.2f} us ({bounds[dtype][1]}); eager call "
            f"with host overhead: kernel {k_eager * 1e3:.1f} us, plain "
            f"{p_eager * 1e3:.1f} us; library: none (no single PyTorch call "
            f"computes this function)")
    # the main path runs the decoder in fp32 (the int8 embedding lookup is fp32)
    k_ms, p_ms = times[torch.float32][:2]
    return {"name": "decode_attention_int8", "route": "cuda",
            "source": "seamless_communication_torch/csrc/decode_attention.cu",
            "replaces": "seamless_communication_tpu/ops/kernels/decode_attention.py:75",
            "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bounds[torch.float32][0], "bound_by": bounds[torch.float32][1],
            "library_ms": None}


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def synthetic_tokenizer(num_words: int = 1200):
    """An NLLB tokenizer over a seeded synthetic SentencePiece vocabulary of
    up to ``num_words`` words (no real SentencePiece model ships with the
    repo)."""
    import numpy as np

    from seamless_communication_torch.text.nllb import NllbTokenizer
    from seamless_communication_torch.text.spm import (
        TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
    )

    rng = np.random.default_rng(0)
    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces = sorted({"\u2581" + "".join(rng.choice(list(letters), rng.integers(2, 9)))
                     for _ in range(num_words)} | {".", ",", "\u2581the", "\u2581a"})
    base = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
            ("</s>", 0.0, TYPE_CONTROL)]
    return NllbTokenizer(SentencePieceModel.from_bytes(build_spm_model(
        base + [(p, -2.0, TYPE_NORMAL) for p in pieces])), langs=["__eng__", "__fra__"])


def check_hypotheses(res, prefix, max_len: int, eos: int) -> None:
    """Every kept hypothesis starts with the forced prefix and ends in EOS or
    at the hard maximum; scores are finite."""
    import torch

    best = res.tokens[:, 0].cpu()
    lens = res.lengths[:, 0].cpu()
    if not torch.isfinite(res.scores[:, 0]).all():
        raise AssertionError(f"non-finite scores {res.scores[:, 0].tolist()}")
    for b in range(best.shape[0]):
        if best[b, :2].tolist() != list(prefix):
            raise AssertionError(f"hypothesis {b} starts {best[b, :2].tolist()}, "
                                 f"not the prefix {list(prefix)}")
        n = int(lens[b])
        if not (int(best[b, n - 1]) == eos or n == max_len):
            raise AssertionError(f"hypothesis {b} ends in {int(best[b, n - 1])} at "
                                 f"length {n} < {max_len}")


def build_base_v2():
    """The port's base_v2 (v2-large) speech encoder and NLLB decoder on the
    card: random bf16 weights from a seeded generator, int8 weight-only.
    Returns (translator, tokenizer, cfg, noise) where ``noise(seconds)`` is
    seeded 16 kHz audio; the translator was warmed up on one short request."""
    import numpy as np
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.ops.quantization import quantize_params

    dev = torch.device("cuda")
    cfg = get_arch("base_v2")
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = quantize_params(unity.unity_init(gen, cfg, dtype=torch.bfloat16,
                                              device=dev))
    torch.cuda.synchronize()
    log(f"base_v2 params (bf16, int8 weight-only) built in {time.time() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    tok = synthetic_tokenizer()
    translator = Translator(params, cfg, tok)            # beam 5, int8 KV on the card
    rng = np.random.default_rng(1)

    def noise(seconds):
        return (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)

    # warm-up (cuBLAS handles, allocator) outside any counted run
    translator.predict(noise(1.0), "s2tt", "eng", text_generation_opts=(
        SequenceGeneratorOptions(soft_max_seq_len=(0, 8))))
    return translator, tok, cfg, noise


def phase_main_path(smi: str) -> dict:
    """base_v2 (v2-large) S2TT through Translator.predict, three requests."""
    import torch

    from seamless_communication_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    translator, tok, cfg, noise = build_base_v2()
    requests = [("4 s", noise(4.0)), ("10 s", noise(10.0)),
                ("batch of 2: 10 s + 7 s", [noise(10.0), noise(7.0)])]
    prefix = tok.target_prefix("eng").tolist()
    stats = []
    torch.cuda.synchronize()
    reset_launch_counts()
    for name, wav in requests:
        before = launch_counts["decode_attention_int8"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        texts, _ = translator.predict(wav, "s2tt", "eng")
        torch.cuda.synchronize()
        wall = time.time() - t0
        res = translator.generator.last_result
        steps = res.steps
        max_len = res.tokens.shape[-1]
        launches = launch_counts["decode_attention_int8"] - before
        check_hypotheses(res, prefix, max_len, cfg.nllb.eos_idx)
        if launches != cfg.nllb.num_decoder_layers * steps:
            raise AssertionError(f"{name}: K1 launched {launches} times in {steps} "
                                 f"decode steps, not {cfg.nllb.num_decoder_layers} "
                                 "per step")
        tokens = int((res.lengths[:, 0] - 2).sum())
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"request {name}: wall {wall * 1e3:.1f} ms, {steps} decode steps "
            f"(max_len {max_len}), {wall * 1e3 / steps:.2f} ms per step "
            f"(wall incl. encoder / steps), {tokens} tokens generated, "
            f"K1 launches {launches}, peak {peak:.2f} GiB, texts "
            f"{[t[:40] for t in texts]} [{smi}]")
        stats.append({"request": name, "wall_ms": wall * 1e3, "steps": steps,
                      "tokens": tokens, "peak_gib": peak, "k1_launches": launches})
    return {"launches": launch_counts["decode_attention_int8"], "requests": stats}


def phase_tiny_cuda_vs_cpu() -> None:
    """tiny_v2 in fp32 with int8 KV: the card (K1) and the CPU (the plain
    composition) must give the same tokens."""
    import numpy as np
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.ops.kernels import launch_counts

    cfg = get_arch("tiny_v2")
    params = unity.unity_init(torch.Generator().manual_seed(0), cfg)
    tok = synthetic_tokenizer(200)                  # fits tiny_v2's 256 ids
    assert tok.vocab_info.size <= cfg.nllb.vocab_size
    opts = SequenceGeneratorOptions(soft_max_seq_len=(1, 40), kv_cache_int8=True)
    wav = (np.random.default_rng(2).standard_normal(3 * 16000) * 0.1).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        tr = Translator(params, cfg, tok, text_opts=opts, device=device)
        before = launch_counts["decode_attention_int8"]
        tr.predict([wav, wav[:32000]], "s2tt", "eng")
        res = tr.generator.last_result
        out[device] = (res.tokens[:, 0].cpu(), res.lengths[:, 0].cpu())
        launches = launch_counts["decode_attention_int8"] - before
        log(f"tiny_v2 on {device}: {res.steps} steps, K1 launches {launches}, "
            f"best lengths {out[device][1].tolist()}")
        expected = cfg.nllb.num_decoder_layers * res.steps if device == "cuda" else 0
        if launches != expected:
            raise AssertionError(f"tiny_v2 on {device}: {launches} K1 launches, "
                                 f"expected {expected}")
    if not (torch.equal(out["cuda"][0], out["cpu"][0])
            and torch.equal(out["cuda"][1], out["cpu"][1])):
        raise AssertionError(f"tiny_v2 tokens differ between the card and the CPU: "
                             f"{out['cuda'][0].tolist()} vs {out['cpu'][0].tolist()}")
    log("tiny_v2 tokens identical on the card (K1) and the CPU (plain composition)")


def profile_main_path(smi: str, out_dir: str = "chiprun_out") -> None:
    """One 10 s base_v2 request, cut to 63 decode steps, under ``torch.profiler``: where the wall time
    of the main path goes. Prints the encoder's share, the decode's time per
    step, the card's busy share and the kernels by device time, and writes
    the full table to ``<out_dir>/profile_s2tt.txt``."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.models.unity import model as unity

    translator, _, cfg, noise = build_base_v2()
    wav = noise(10.0)
    fbank, flens = translator._audio_to_fbank(wav, 16000)
    fb = torch.as_tensor(fbank, device="cuda")
    fl = torch.as_tensor(flens, device="cuda")
    enc_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            unity.encode_speech(translator.params, cfg, fb, fl)
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    # 63 decode steps: the profiler's own cost grows with the events it keeps
    opts = SequenceGeneratorOptions(soft_max_seq_len=(0, 64))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        translator.predict(wav, "s2tt", "eng", text_generation_opts=opts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = translator.generator.last_result.steps
    # kernels only: the aten ops that launched them carry the same device time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    log(f"profile 10 s request [{smi}]: wall {wall_ms:.1f} ms under the profiler, "
        f"{steps} decode steps; encoder alone {statistics.median(enc_ms):.1f} ms "
        f"(median of 3, no profiler); kernels busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / wall_ms:.1f} % of the wall; {launches} kernel launches = "
        f"{launches / steps:.0f} per decode step")
    for e in events[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:7d} x  {e.key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_s2tt.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))


def main() -> int:
    import torch

    dev = phase_device()
    if sys.argv[1:] == ["--profile"]:
        profile_main_path(dev["smi"])
        return 0
    k1 = phase_decode_attention()
    main_path = phase_main_path(dev["smi"])
    k1["launches"] = main_path["launches"]
    phase_tiny_cuda_vs_cpu()
    log(json.dumps({"main_path": main_path["requests"], "card": dev["smi"]}))
    log(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
