#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Four phases; any failure exits non-zero.

1. Device: requires CUDA, prints the card's name and power limit, turns TF32
   off for the parity phases, builds every kernel of ``csrc/`` (one ``nvcc``
   each, all at once) and prints the build seconds.
2. Each kernel (K1 int8-KV and K2 packed-int4-KV decode attention) against
   its plain PyTorch version on the card, at the shapes of the main path,
   with the stated tolerance; device times by CUDA-graph replay beside the
   bound (bytes over 3.35 TB/s).
3. The main path at full width: the port's ``base_v2`` (v2-large) UnitY and
   unit HiFi-GAN on random bf16 weights from a seeded ``torch.Generator``,
   the UnitY tree int8 weight-only, beam 5.
   a. ``Translator.predict(wav, "s2tt", "eng")`` with an int8 KV cache, three
      requests: K1 launched 24 times per decode step.
   b. ``Translator.predict(wav, "s2st", "eng")`` with ``kv_cache_bits=4``, a
      4 s and a 10 s request: K2 launched 24 times per decode step, K1
      never; the waveforms finite, within [-1, 1] and whole unit frames.
   Each path's launches are counted from 0 just before it.
4. ``tiny_v2`` on the card and on the CPU: S2TT with int8 KV, and S2ST with
   the tiny vocoder with int8 KV (K1) and int4 KV (K2), must give the same
   tokens and units, and waveforms within 1e-4.

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

# the decode-attention kernels: (id, wrapper, plain version, row quantizer,
# bits per cached value, source, the TPU kernel it replaces)
KERNELS = {
    "decode_attention_int8": ("K1", "fused_decode_self_attention_int8", "_reference",
                              "quantize_kv_rows", 8,
                              "seamless_communication_torch/csrc/decode_attention.cu",
                              "seamless_communication_tpu/ops/kernels/decode_attention.py:75"),
    "decode_attention_int4": ("K2", "fused_decode_self_attention_int4", "_reference_int4",
                              "quantize_kv_rows_int4", 4,
                              "seamless_communication_torch/csrc/decode_attention_int4.cu",
                              "seamless_communication_tpu/ops/kernels/decode_attention.py:267"),
}


def phase_decode_attention(name: str) -> dict:
    """One decode-attention kernel against its plain version at B=5, H=16,
    T=320, Dh=64: new caches and scales bit-equal, ``out`` within rtol = atol
    = 2e-5 in fp32 and 1.6e-2 in bf16, at steps 0, 1, 137 and 319."""
    import numpy as np
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    kid, wrapper, plain_name, quantizer, bits, source, replaces = KERNELS[name]
    fused, plain_fn = getattr(da, wrapper), getattr(da, plain_name)
    B, H, T, Dh = B_MAIN, H_MAIN, T_MAIN, DH_MAIN
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def t(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    src = t(np.array([3, 0, 3, 1, 1]), torch.int32)     # repeated origins
    # caches as the main path fills them: rows of unit-variance K/V,
    # quantized per row (absmax/127 for int8, absmax/7 and packed for int4)
    quantize = getattr(da, quantizer)
    kq, ks = quantize(t(rng.standard_normal((B, H, T, Dh)), torch.float32))
    vq, vs = quantize(t(rng.standard_normal((B, H, T, Dh)), torch.float32))
    caches = (kq, vq, ks, vs)
    tol = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
    max_err = 0.0
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        vecs = [t(rng.standard_normal((B, H, Dh)), dtype) for _ in range(3)]
        for step in (0, 1, 137, T - 1):
            args = (*vecs, *caches, step, src)
            got = fused(*args)
            ref = plain_fn(*args)
            torch.cuda.synchronize()
            for cache, g, r in zip(("new_k", "new_v", "new_ks", "new_vs"),
                                   got[1:], ref[1:]):
                if not torch.equal(g, r):
                    bad = int((g != r).sum())
                    raise AssertionError(f"{kid} {dtype} step {step}: {cache} "
                                         f"differs in {bad} entries")
            err = (got[0].float() - ref[0].float()).abs()
            lim = tol[dtype] * (1 + ref[0].float().abs())
            if not bool((err <= lim).all()):
                raise AssertionError(f"{kid} {dtype} step {step}: out max err "
                                     f"{float(err.max()):.3g} over tolerance")
            if dtype is torch.float32:
                max_err = max(max_err, float(err.max()))
            log(f"{kid} {str(dtype):15s} step {step:3d}: caches exact, out max abs "
                f"err {float(err.max()):.3g} (rtol=atol={tol[dtype]})")
        args = (*vecs, *caches, STEP_TIMED, src)
        kernel = lambda: fused(*args)
        plain = lambda: plain_fn(*args)
        times[dtype] = (cuda_time_ms(kernel), cuda_time_ms(plain),
                        eager_time_ms(kernel), eager_time_ms(plain))
    n_src = len(set(src.tolist()))
    bounds = {}
    for dtype in times:
        elem = torch.finfo(dtype).bits // 8
        bytes_s = da.bound_bytes(B, H, T, Dh, n_src=n_src, elem=elem,
                                 bits=bits) / HBM_BYTES_PER_S
        # two products of Dh over the history rows, as fp32 arithmetic
        flops_s = 4 * B * H * STEP_TIMED * Dh / PEAK_FP32_FLOPS
        bounds[dtype] = (max(bytes_s, flops_s) * 1e3,
                         "bytes" if bytes_s >= flops_s else "operations")
    for dtype, (k_ms, p_ms, k_eager, p_eager) in times.items():
        log(f"{kid} time {str(dtype):15s} at step {STEP_TIMED}: device kernel "
            f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
            f"{bounds[dtype][0] * 1e3:.2f} us ({bounds[dtype][1]}); eager call "
            f"with host overhead: kernel {k_eager * 1e3:.1f} us, plain "
            f"{p_eager * 1e3:.1f} us; library: none (no single PyTorch call "
            f"computes this function)")
    # the main path runs the decoder in fp32 (the int8 embedding lookup is fp32)
    k_ms, p_ms = times[torch.float32][:2]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
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


def synthetic_char_tokenizer():
    """A char tokenizer over the letters, the word boundary and the
    characters of "<unk>" and of the punctuation pieces."""
    from seamless_communication_torch.text.char_tokenizer import CharTokenizer
    from seamless_communication_torch.text.spm import (
        TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
    )

    chars = ["\u2581"] + list("abcdefghijklmnopqrstuvwxyz.,<>")
    base = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
            ("</s>", 0.0, TYPE_CONTROL)]
    return CharTokenizer(SentencePieceModel.from_bytes(build_spm_model(
        base + [(c, -1.0, TYPE_NORMAL) for c in chars])))


LANG_SPKR = {"multilingual": {"eng": 0, "fra": 1}, "multispkr": {"eng": [0], "fra": [1]}}
# the tiny unit vocoder of tests/integration/conftest.py
TINY_VOCODER = dict(num_units=100, unit_embed_dim=32, num_langs=4, lang_embed_dim=8,
                    num_spkrs=4, spkr_embed_dim=8, dur_predictor_hidden=16)
TINY_HIFIGAN = dict(model_in_dim=48, upsample_initial_channel=64, upsample_rates=(4, 2),
                    upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
                    resblock_dilation_sizes=((1, 2),))


def s2st_translator(params, cfg, tok, vocoder, vocoder_cfg, **kw):
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer

    return Translator(params, cfg, tok,
                      UnitTokenizer(vocoder_cfg.num_units, ["eng", "fra"], "base_v2"),
                      synthetic_char_tokenizer(), vocoder_params=vocoder,
                      vocoder_cfg=vocoder_cfg, lang_spkr_idx_map=LANG_SPKR, **kw)


def build_base_v2():
    """The port's base_v2 (v2-large) UnitY (speech encoder, NLLB decoder, NAR
    T2U) and unit HiFi-GAN (``CodeHifiGanConfig()``) on the card: random bf16
    weights from a seeded generator, the UnitY tree int8 weight-only and the
    vocoder not quantized, as the JAX package loads them. Returns
    (translator, tokenizer, cfg, noise) where ``noise(seconds)`` is seeded 16
    kHz audio; the translator was warmed up on one short S2ST request, and the
    dtype each stage computes in is printed."""
    import numpy as np
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.vocoder.codehifigan import (
        CodeHifiGanConfig, code_hifigan_forward, code_hifigan_init,
    )
    from seamless_communication_torch.ops.quantization import quantize_params

    dev = torch.device("cuda")
    cfg = get_arch("base_v2")
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = quantize_params(unity.unity_init(gen, cfg, dtype=torch.bfloat16,
                                              device=dev))
    vocoder_cfg = CodeHifiGanConfig()
    vocoder = code_hifigan_init(gen, vocoder_cfg, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    log(f"base_v2 params (bf16; UnitY int8 weight-only, vocoder bf16) built in "
        f"{time.time() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"on the card")
    tok = synthetic_tokenizer()
    # beam 5, int8 KV on the card unless a request asks for kv_cache_bits=4
    translator = s2st_translator(params, cfg, tok, vocoder, vocoder_cfg)
    rng = np.random.default_rng(1)

    def noise(seconds):
        return (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)

    # warm-up (cuBLAS and cuDNN handles, allocator) outside any counted run
    wav = noise(1.0)
    translator.predict(wav, "s2st", "eng", text_generation_opts=(
        SequenceGeneratorOptions(soft_max_seq_len=(0, 8))))
    with torch.inference_mode():
        fbank, flens = translator._audio_to_fbank(wav, 16000)
        enc = unity.encode_speech(translator.params, cfg, torch.as_tensor(fbank, device=dev),
                                  torch.as_tensor(flens, device=dev))
        ids = torch.as_tensor(tok.target_prefix("eng")[None], device=dev)
        feats = unity.decode_text(translator.params, cfg, ids, enc)
        one = torch.ones((1,), dtype=torch.long, device=dev)
        wave = code_hifigan_forward(translator.vocoder_params, vocoder_cfg,
                                    one[:, None], one, one, one).waveform
    log(f"stage dtypes: speech encoder {enc.seqs.dtype}; text decoder and "
        f"re-decode {feats.dtype} (the int8 embedding lookup returns fp32), the "
        f"NAR T2U computes in the dtype of these features; vocoder {wave.dtype}")
    return translator, tok, cfg, noise


def phase_s2tt(translator, tok, cfg, noise, smi: str) -> dict:
    """base_v2 (v2-large) S2TT through Translator.predict, three requests:
    K1 launched 24 times per decode step, K2 never."""
    import torch

    from seamless_communication_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

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
        log(f"S2TT request {name}: wall {wall * 1e3:.1f} ms, {steps} decode steps "
            f"(max_len {max_len}), {wall * 1e3 / steps:.2f} ms per step "
            f"(wall incl. encoder / steps), {tokens} tokens generated, "
            f"K1 launches {launches}, peak {peak:.2f} GiB, texts "
            f"{[t[:40] for t in texts]} [{smi}]")
        stats.append({"request": f"s2tt {name}", "wall_ms": wall * 1e3, "steps": steps,
                      "tokens": tokens, "peak_gib": peak, "k1_launches": launches})
    if launch_counts["decode_attention_int4"]:
        raise AssertionError("S2TT with int8 KV launched K2")
    return {"launches": launch_counts["decode_attention_int8"], "requests": stats}


def phase_s2st(translator, tok, cfg, noise, smi: str) -> dict:
    """base_v2 (v2-large) S2ST through Translator.predict with
    ``kv_cache_bits=4``, a 4 s and a 10 s request: K2 launched 24 times per
    decode step and K1 never; every waveform finite, within [-1, 1], and a
    whole number of 320-sample frames, at least one a unit and at most the
    vocoder's cap of 4 a unit (of the units bucketed to 32)."""
    import numpy as np
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions, _bucket,
    )
    from seamless_communication_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    opts = SequenceGeneratorOptions(kv_cache_bits=4)
    hop = translator.vocoder_cfg.hifigan.total_upsample
    prefix = tok.target_prefix("eng").tolist()
    layers = cfg.nllb.num_decoder_layers
    stats = []
    torch.cuda.synchronize()
    reset_launch_counts()
    for name, wav in [("4 s", noise(4.0)), ("10 s", noise(10.0))]:
        before = dict(launch_counts)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        texts, speech = translator.predict(wav, "s2st", "eng", text_generation_opts=opts)
        torch.cuda.synchronize()
        wall = time.time() - t0
        res = translator.generator.last_result
        steps, max_len = res.steps, res.tokens.shape[-1]
        k2 = launch_counts["decode_attention_int4"] - before["decode_attention_int4"]
        k1 = launch_counts["decode_attention_int8"] - before["decode_attention_int8"]
        check_hypotheses(res, prefix, max_len, cfg.nllb.eos_idx)
        if k2 != layers * steps or k1:
            raise AssertionError(f"S2ST {name}: K2 launched {k2} times and K1 {k1} "
                                 f"times in {steps} decode steps, not {layers} K2 "
                                 "launches per step and no K1")
        for u, w in zip(speech.units, speech.audio_wavs):
            frames = len(w) // hop
            if len(w) % hop or not len(u) <= frames <= 4 * _bucket(len(u), 32):
                raise AssertionError(f"S2ST {name}: {len(w)} samples for {len(u)} "
                                     f"units are not whole {hop}-sample frames "
                                     "within the cap")
            if not (np.isfinite(w).all() and np.abs(w).max(initial=0.0) <= 1.0):
                raise AssertionError(f"S2ST {name}: waveform not finite or outside "
                                     "[-1, 1]")
        units = sum(len(u) for u in speech.units)
        audio_s = sum(len(w) for w in speech.audio_wavs) / speech.sample_rate
        peak = torch.cuda.max_memory_allocated() / 2**30
        split = {k: v * 1e3 for k, v in translator.last_timings.items()}
        log(f"S2ST request {name} (kv_cache_bits=4): wall {wall * 1e3:.1f} ms = "
            + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
            + f" ms; {steps} decode steps (max_len {max_len}), K2 launches {k2}, "
            f"{units} units, {audio_s:.2f} s of audio, peak {peak:.2f} GiB, texts "
            f"{[t[:40] for t in texts]} [{smi}]")
        stats.append({"request": f"s2st {name}", "wall_ms": wall * 1e3,
                      "stages_ms": split, "steps": steps, "units": units,
                      "audio_s": audio_s, "peak_gib": peak, "k2_launches": k2})
    return {"launches": launch_counts["decode_attention_int4"], "requests": stats}


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


def phase_tiny_s2st() -> None:
    """tiny_v2 S2ST in fp32 with the tiny vocoder of
    tests/integration/conftest.py, on the card with int8 KV (K1) and with
    packed-int4 KV (K2), and on the CPU (the plain composition) with each:
    text tokens and units identical; waveforms within 1e-4 absolute (fp32
    convolutions of cuDNN and of the CPU, summed in other orders, end in a
    tanh that keeps the samples within [-1, 1])."""
    import numpy as np
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.vocoder.codehifigan import (
        CodeHifiGanConfig, code_hifigan_init,
    )
    from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig
    from seamless_communication_torch.ops.kernels import launch_counts

    cfg = get_arch("tiny_v2")
    gen = torch.Generator().manual_seed(0)
    params = unity.unity_init(gen, cfg)
    vocoder_cfg = CodeHifiGanConfig(**TINY_VOCODER, hifigan=HifiGanConfig(**TINY_HIFIGAN))
    vocoder = code_hifigan_init(gen, vocoder_cfg)
    tok = synthetic_tokenizer(200)                  # fits tiny_v2's 256 ids
    wav = (np.random.default_rng(3).standard_normal(3 * 16000) * 0.1).astype(np.float32)
    for bits, kernel, kid in ((8, "decode_attention_int8", "K1"),
                              (4, "decode_attention_int4", "K2")):
        opts = SequenceGeneratorOptions(soft_max_seq_len=(1, 40), kv_cache_int8=True,
                                        kv_cache_bits=bits)
        out = {}
        for device in ("cuda", "cpu"):
            tr = s2st_translator(params, cfg, tok, vocoder, vocoder_cfg, text_opts=opts,
                                 device=device)
            before = launch_counts[kernel]
            _, speech = tr.predict([wav, wav[:32000]], "s2st", "fra")
            res = tr.generator.last_result
            launches = launch_counts[kernel] - before
            out[device] = (res.tokens[:, 0].cpu(), res.lengths[:, 0].cpu(), speech)
            log(f"tiny_v2 S2ST kv_cache_bits={bits} on {device}: {res.steps} steps, "
                f"{kid} launches {launches}, units {[len(u) for u in speech.units]}, "
                f"samples {[len(w) for w in speech.audio_wavs]}")
            expected = cfg.nllb.num_decoder_layers * res.steps if device == "cuda" else 0
            if launches != expected:
                raise AssertionError(f"tiny_v2 S2ST on {device}: {launches} {kid} "
                                     f"launches, expected {expected}")
        (tc, lc, sc), (tp, lp, sp) = out["cuda"], out["cpu"]
        if not (torch.equal(tc, tp) and torch.equal(lc, lp) and sc.units == sp.units):
            raise AssertionError(f"tiny_v2 S2ST kv_cache_bits={bits}: tokens or units "
                                 "differ between the card and the CPU")
        err = 0.0
        for a, b in zip(sc.audio_wavs, sp.audio_wavs):
            if a.shape != b.shape:
                raise AssertionError(f"tiny_v2 S2ST: waveform shapes {a.shape} "
                                     f"and {b.shape}")
            err = max(err, float(np.abs(a - b).max(initial=0.0)))
        if err > 1e-4:
            raise AssertionError(f"tiny_v2 S2ST kv_cache_bits={bits}: waveforms "
                                 f"differ by {err:.3g} > 1e-4")
        log(f"tiny_v2 S2ST kv_cache_bits={bits}: tokens and units identical on the "
            f"card ({kid}) and the CPU (plain composition), waveform max abs "
            f"difference {err:.3g}")


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
    k1 = phase_decode_attention("decode_attention_int8")
    k2 = phase_decode_attention("decode_attention_int4")
    base_v2 = build_base_v2()
    # each kernel's launches are counted over its own path, reset just before
    s2tt = phase_s2tt(*base_v2, dev["smi"])
    k1["launches"] = s2tt["launches"]
    s2st = phase_s2st(*base_v2, dev["smi"])
    k2["launches"] = s2st["launches"]
    del base_v2
    phase_tiny_cuda_vs_cpu()
    phase_tiny_s2st()
    log(json.dumps({"main_path": s2tt["requests"] + s2st["requests"],
                    "card": dev["smi"]}))
    log(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
