#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Four phases; any failure exits non-zero.
Each part's wall seconds are printed as ``phase <label>: <s> s``.

1. Device: requires CUDA, prints the card's name and power limit, turns TF32
   off for the parity phases, builds every kernel of ``csrc/`` (one ``nvcc``
   each, all at once) and prints the build seconds.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path, with the stated tolerance; device times by CUDA-graph
   replay beside the bound (the larger of bytes over 3.35 TB/s and
   operations over the fp32 rate), and the launch floor (a one-element
   in-place add, timed the same way): K1 int8-KV and K2 packed-int4-KV
   decode attention, held to their plain versions over a sweep of shapes,
   steps, beam-origin patterns and cluster sizes (``DECODE_SWEEP``), timed
   L2-warm, HBM-cold (the graph's calls rotate over 100 MB of distinct
   caches) at T=320 and T=1024, and at each cluster size; K5 row-indexed
   decode attention (the lazy reorder, K1's design) over the same sweep on a
   uniform, a beam-history, an identity and a one-slot row-origin table and
   at each cluster size, timed L2-warm and HBM-cold, and HBM-cold at T=1024
   beside K1 in turn; K4 fbank of a 4 s and a
   10 s waveform (beside the launch floor, and cuFFT's ``rfft`` of the
   prepared frames as a part); K3b ``int8_vocab_topk_v2`` (two launches:
   the stream, then the selection; its first launch timed alone too, and
   k=128 on the repeated rows) and K3a ``int8_vocab_topk`` (the same two
   launches with a list a tile, at its default tile and at 512, 1024 and
   2048, timed in turns with K3b) at the base_v2 vocabulary
   (V=256102, D=1024, k=11, N=5 and 10), with the time of the
   full-vocabulary step the candidate beam replaces; K6 flash
   attention at the fused option's main-path shapes (the Shaw encoder at 4
   and 10 s, the re-decode, the NAR T2U's FFT layers) in fp32 and bf16,
   beside the library's ``scaled_dot_product_attention`` with the same
   float mask (in fp32 also equal with and without residuals, and the key
   tiles it skips under segment ids counted); K6b and K6c (the backward,
   ``flash_attention_bwd.cu``) at the
   same shapes against the plain backward, K6 with its residuals, and the
   library's SDPA backward and forward + backward as yardsticks, the
   elements of each gradient that differ from the plain backward at all,
   and the tile pairs of ``skippable_tiles`` that K6c and fp32 K6b leave
   out. In bf16, K6, K6b and K6c are the tensor-core kernels (``wgmma`` fed
   by TMA); in fp32 register-blocked SIMT kernels fed by TMA. Then a sweep
   of every head dim they all specialise (16, 32, 64, 128) x a key count that is
   and one that is not a multiple of 8 x a bias, segment ids and neither
   (fp32 K6, K6b and K6c also with 32- and 64-row or -key blocks), the
   attention shapes of phase 3g's train steps in both dtypes, and the NAR
   T2U's FFT shape with rows in a segment no key has, whose key tiles K6c
   and fp32 K6b may not skip (``phase_flash_sweep``); and K6 at the
   streaming re-encode's shape (T = 512 with the chunk-causal bias of the
   ``streaming`` arch, fp32 and bf16, beside SDPA; ``streaming_flash_case``),
   and at PRETSSEL's FFT decoder shape (B=1, H=2, Dh=128, T=1280 with key
   segment ids, fp32 and bf16, beside SDPA; ``pretssel_flash_case``); K1
   at 3k's batched decode (B = 40 rows: a group of 8 at beam 5, T=320,
   Dh=64; L2-warm and HBM-cold beside its bound and the plain version, the
   cluster size ``split_plan`` picks; ``decode_batch_case``) and K6 at 3l's
   pooled adaptor (B = 4 slots, H=16, T=257, Dh=64, four valid lengths as
   key segment ids, fp32 and bf16 beside SDPA; ``adaptor_flash_case``); K6,
   K6b and K6c at the heads one rank computes under 3m's ``model=2`` (the
   10 s Shaw shape with H=8, fp32 and bf16, beside SDPA and the bounds;
   ``rank_flash_case``); K6 at the XLSR2-1B encoder's shape of 3n (B=2,
   H=16, Dh=80, T=499 with 499 and 350 valid keys as key segment ids, fp32
   with both block heights and bf16, beside SDPA and the bound;
   ``xlsr_flash_case``), and K6 alone at Dh=80 over the sweep's Tk x bias
   cases, where the backward raises (``SWEEP_DH_FWD``).
   ``python3 chip_smoke.py --kernels`` stops after this phase.
3. The main path at full width: the port's ``base_v2`` (v2-large) UnitY (with
   its text encoder) and unit HiFi-GAN on random bf16 weights from a seeded
   ``torch.Generator``, the UnitY tree int8 weight-only, beam 5.
   a. ``Translator.predict(wav, "s2tt", "eng")`` with an int8 KV cache, two
      requests cut to 127 decode steps: K1 launched 24 times per decode step.
   b. ``Translator.predict(wav, "s2st", "eng")`` with ``kv_cache_bits=4``, a
      4 s and a 10 s request cut to 127 decode steps: K2 launched 24 times
      per decode step, K1 never; the waveforms finite, within [-1, 1] and
      whole unit frames.
   c. ``Translator.predict(text, "t2tt" | "t2st", "fra", src_lang="eng")``
      with ``SEAMLESS_CANDIDATE_BEAM=1`` and int8 KV, three requests: K3b
      launched twice (stream, selection) and K1 24 times per decode step, K3a
      and K2 never; then
      a cut T2TT request with and without the candidate beam gives identical
      tokens.
   d. The lazy beam reorder and the generation options, int8 KV, the
      decodes cut to 127 steps: a T2TT request with SEAMLESS_LAZY_REORDER=1
      and without (identical tokens; K5 24 times a step and K1 never, and
      the other way round), the same with no_repeat_ngram_size=2 (no bigram
      twice), and an S2ST request through a MinTox Translator (the ASR of
      the input as source, a word of the first pass banned, the re-run free
      of it).
   e. ``SEAMLESS_FUSED_ATTN=1``: the speech encoder with the option on and
      off (outputs within 2e-3), then an S2ST request of 10 s and a T2ST
      request of a 140-token source: K6 launched as often as the requests'
      shapes make attentions eligible (both lengths at least 128: the 24
      encoder layers, the re-decode, the T2U), K1 24 times a text step.
   f. The port's ``base`` (SeamlessM4T v1-large: XL conformer, AR T2U) with
      the option on: an S2TT and an S2ST request of 10 s, the text and the
      unit decodes cut to 127 steps: K1 24 times a text step and 6 times a
      unit step, K6 24 times in the XL encoder and where the re-decode and
      the AR T2U's encoder reach 128.
   g. The finetune trainer (``UnitYFinetune``) on ``base_v2`` at full width
      and depth, bf16 params not quantized, the text encoder frozen, the
      option on: 3 S2T steps (K6, K6b and K6c 48 times a step, the third
      loss below the first), a step under the profiler, a
      ``remat="full"`` step (K6 twice), 2 v2 S2S steps (the NAR T2U; the
      loss's parts before and after each) and the same with the option off
      (the first loss within 1e-3 relative of the option's);
      then gradient parity at 4 conformer + 4 decoder layers in fp32, S2T
      and S2S with the whole T2U, the option on against off.
   h. The offline entry point: ``base_v2`` and ``CodeHifiGanConfig()`` on
      seeded bf16 weights written by the port's exporter as fp16 ``.pt``
      files (2.27 B parameters, 4.7 GiB) with synthetic SentencePiece
      files and two cards inheriting the packaged ones, in a temporary
      directory removed at the end; read back by
      ``load_unity_model_and_tokenizers(..., quantize=True)`` and
      ``load_vocoder`` (each leaf held before quantizing to the file's
      value, exactly; the load's stages timed); then
      ``cli.predict.main`` in-process: a 10 s S2ST request cut to 127 decode
      steps (K1 24 times a step, the WAV 16 kHz, finite, within [-1, 1],
      text and units those of a Translator built on the loaded tree), and an
      S2TT request with ``--quantize_bits 4`` (its hypotheses checked, one
      int4 linear held to its dequantized plain product).
   i. SeamlessStreaming: the ``streaming`` UnitY (chunk-causal conformer,
      no text encoder or decoder, NAR T2U) and the dense_1b EMMA decoder on
      seeded bf16 weights written as fp16 ``.pt`` files and read back by
      ``load_unity_model_and_tokenizers`` and ``load_monotonic_decoder``;
      the encoder with the fused option and without (within 2e-3); then
      with ``SEAMLESS_FUSED_ATTN=1`` 10 s of audio streamed in 320 ms chunks
      through ``build_s2t_pipeline`` and ``build_s2st_pipeline`` +
      ``StreamingSession`` in each mode (unfused, fused re-encode,
      incremental), the EMMA decoder int8: ms a chunk against the 320 ms
      budget, xRT, tokens, READ/WRITE actions and the smallest margin of the
      decision statistic to the threshold, units and audio seconds, K6
      launches (more than 0 in the fused mode), peak memory.
   j. SeamlessExpressive: ``expressivity_v2`` (the ECAPA prosody encoder,
      the FiLM NAR T2U, the tanh-GELU NLLB) and the 24 kHz PRETSSEL on
      seeded bf16 weights written as fp16 ``.pt`` files and read back by
      the loaders inside ``cli.expressivity_predict.main`` (every leaf the
      file's value), which serves 10 s of noise with
      ``SEAMLESS_FUSED_ATTN=1`` and int8 weights, the text decode cut to
      127 steps: the wall by stage (speech encoder, prosody encoder, text
      decode and ms a step, re-decode, T2U, PRETSSEL pre-mel, wave
      synthesis), units, mel frames, 24 kHz audio seconds, peak memory; K1
      24 times a step, K6 inside PRETSSEL as often as its shapes make
      eligible; the WAV finite and within [-1, 1]; PRETSSEL again with the
      option off (within 1e-3). Then one expressive streaming session of 10
      s, fused (``build_expressive_s2st_pipeline`` on 3i's loaded streaming
      models), its text decode cut to 127 tokens: ms a chunk, xRT; and the
      same with ``use_vad=True`` (the VAD agent first) on 6 s with a 1 s
      silence.
   k. Serving (after 3e, on base_v2's int8 tree): ``inference.serving.serve``
      with ``max_batch=8``, the decode cut to 127 steps; eight S2TT requests
      of 4-10 s posted at once as base64 WAV over HTTP, answered 200 by one
      batched ``predict`` (K1 24 times a step over 40 rows), then the same
      eight alone, then an S2ST request whose WAV is finite and within
      [-1, 1]: latencies, requests per card-second batched and alone, ms a
      decode step, K1 launches, peak memory.
   l. The streaming pool (after 3j, on 3i's loaded models, the option on,
      EMMA int8): ``BatchedStreamingPool(n_slots=4)`` with four 10 s
      sessions one 320 ms chunk apart (session 0 on 3i's waveform): ms a pool
      step, each session's xRT, K6 launches (the adaptor), peak memory,
      beside 3i's incremental S2TT stream; session 0's decisions equal that
      stream's up to the first decision with a margin under 1e-3; then one
      session through /v1/stream/open, push, poll and close.
   m. Finetuning (after 3g, ``phase_finetune``): ``base_v2`` written as an
      fp16 ``.pt`` and a seeded conformer-shaw ``.pt``, a manifest of 8 WAVs
      of 4-10 s, ``cli.finetune.main`` in-process (S2T, batch 2, one epoch,
      an eval every 2 steps, ``--init_speech_encoder``, the best model and
      the state as checkpoint directories, the option on: K6, K6b, K6c as
      counted for each batch; the best model loads back leaf for leaf);
      resume from the state directory against the uninterrupted steps;
      one step under each remat policy (dots, offload_dots, full); then
      two gloo processes on the one card train one step at 4 + 4 layers in
      fp32 on the meshes (data 2), (model 2) and (pipe 2, remat full), each
      held to the step without a mesh (loss 1e-4, params 2e-4).
   n. The auxiliary models (``phase_aux``): ``cli.audio_to_units.main`` on
      10 s with the full-width XLSR2-1B (0.96 B parameters, written as an
      fp32 ``.pt``) and a 10000 x 1280 k-means, ``SEAMLESS_FUSED_ATTN=1``:
      K6 at head dim 80 once a layer run (35), 499 units, the wall by
      stage; the encoder with the option off (layer 35 within atol 2e-3 +
      rtol 2e-3) and k-means on the card against the CPU; the UnitY2
      aligner at full width, card against CPU (log-probs 1e-4, durations
      equal); ``cli.mutox_speech.main`` with the full-width classifier and
      a TorchScript stand-in encoder, card against CPU (1e-5); VAD
      segmentation and spectral subtraction of 60 s (host work, timed); the
      unit extraction again under ``utils.profiling.device_trace``.
   o. Evaluation (after 3m, ``phase_eval``, on 3h's fp16 base_v2 ``.pt``
      and 3i's streaming models, ``SEAMLESS_FUSED_ATTN=1``, decodes cut to
      64 tokens): the native runtime (``native/*.cpp`` built with g++) held
      to the numpy fbank, WAV reader and loader and the Python SentencePiece
      encoder; ``cli.evaluate.main`` (m4t_evaluate) S2TT on four WAVs, one
      corrupted, through the native loader (its hypothesis empty); the
      ``Transcriber`` on 10 s and on 24 s that the VAD splits at a silence,
      and ``lid_scores``; m4t_evaluate S2ST with ``--compute_asr_bleu``
      (the port's Transcriber on the written WAVs); ``evaluate_streaming``
      on one 10 s S2TT stream (AL, LAAL). K1 24 times a decode step and K6
      as the encoders' shapes make eligible, each held to the decodes and
      encodes made.
   Each path's launches are counted from 0 just before it.
4. ``tiny_v2`` on the card and on the CPU: S2TT with int8 KV, S2ST with the
   tiny vocoder with int8 KV (K1) and int4 KV (K2), and T2TT and T2ST with
   the tree int8 and the candidate beam (K3b, K1), must give the same tokens
   and units, and waveforms within 1e-4; so must the lazy reorder (K5), the
   n-gram block, banned sequences, MinTox and FbankInput; and, with the
   fused option on (K6), ``tiny_v1`` S2ST and T2ST (the AR unit decode on
   K1) and ``tiny_v2`` S2ST; ``tiny_v2`` S2ST through ``.pt`` files and the
   loaders (same text, waveforms within 1e-4); the tiny streaming models
   of ``tests/test_torch_streaming.py`` (S2TT in each mode, S2ST linear and
   tree: the same tokens, segments and units, waveforms within 1e-4);
   ``tiny_expressive`` with the tiny PRETSSEL of
   ``tests/test_torch_pretssel.py``, fused (S2ST with the prosody input and
   ``PretsselGenerator``, and the expressive streaming pipeline: the same
   tokens, units and segments, waveforms within 1e-4); the tiny serving
   case: the pool on the chunk-causal tiny card with three staggered
   sessions (the CPU pool's segments) and the batcher over HTTP on tiny_v2
   with int8 KV (the CPU ``predict``'s tokens and texts on the same
   groups); and
   two ``tiny_v2`` train
   steps with the option
   on (K6, K6b, K6c on the card) give the CPU's losses within 1e-5 and its
   params within 1e-4.

The line before the last is a JSON object listing every kernel with its
launches on the main path, error, times and bound; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.

    python3 chip_smoke.py --profile

builds the kernels and, instead, profiles one 10 s base_v2 S2TT request and
one T2TT request with the candidate beam and without it (where the main
path's time goes; the tables land in ``profile_*.txt`` files in the output
directory of ``profile_main_path``).

    python3 chip_smoke.py --k6-parts
    python3 chip_smoke.py --k6b-parts [bf16|fp32]
    python3 chip_smoke.py --k6c-parts [bf16|fp32]
    python3 chip_smoke.py --k3b-parts
    python3 chip_smoke.py --k3a-parts
    python3 chip_smoke.py --k4-parts

time fp32 K6 at every ``FLASH_SHAPES`` shape, bf16 K6b (K6c) at the 10 s
Shaw shape (``fp32``: fp32 K6b (K6c) at every shape), K3b's stream or K3a's
first launch at the base_v2 vocabulary, or K4 at 4 s and 10 s, as built and
with one part left out at a time (``kernel_parts``): where its time goes.

    python3 chip_smoke.py --offline

builds the kernels and runs only phase 3h and phase 4's ``tiny_v2`` through
the loaders.

    python3 chip_smoke.py --streaming

builds the kernels and runs only phase 2's K6 at the streaming shape, phase
3i and phase 4's tiny streaming models.

    python3 chip_smoke.py --expressive

builds the kernels and runs only phase 2's K6 at PRETSSEL's shape, phase
3j and phase 4's tiny expressive case.

    python3 chip_smoke.py --serving

builds the kernels and runs only phase 2's K1 and K6 serving shapes, phase
3k, phase 3i (which loads the streaming models), phase 3l and phase 4's
tiny serving case.

    python3 chip_smoke.py --finetune

builds the kernels and runs only phase 2's per-rank K6/K6b/K6c case and
phase 3m.

    python3 chip_smoke.py --aux

builds the kernels and runs only phase 3n.

    python3 chip_smoke.py --eval

builds the kernels and runs only phase 3o, on a base_v2 ``.pt`` it writes
and streaming models drawn in memory.

    python3 chip_smoke.py --k12-trace

times copies of K1 at the main path's shape, as built and with variants
(``K12_VARIANTS``), and prints when each stage of the kernel ends
(``k12_trace``).

    python3 chip_smoke.py --k5-trace

does the same for K5 (``K5_VARIANTS``: its ways of bringing in its rows)
beside K1 at each cluster size (``k5_trace``).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Optional

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
B_MAIN, H_MAIN, T_MAIN, DH_MAIN = 5, 16, 320, 64
STEP_TIMED = 200                   # a mid-utterance step of a T=320 cache
V_MAIN, D_MAIN = 256102, 1024      # base_v2's vocabulary and width
K_CAND = 11                        # candidates a beam: 2 * beam 5 + 1


def log(*a):
    print(*a, flush=True)


PHASE_S: dict = {}      # each phase's wall seconds, in the order run


def timed(label: str, fn, *a, **kw):
    """``fn(*a, **kw)``, its wall seconds logged and kept in ``PHASE_S``."""
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    PHASE_S[label] = time.perf_counter() - t0
    log(f"phase {label}: {PHASE_S[label]:.1f} s")
    return out


@functools.lru_cache(maxsize=None)
def warmup_stream():
    """One side stream for every warm-up of ``cuda_time_ms``: cuBLAS keeps a
    workspace (32 MiB) for each stream it has run on until the process ends,
    so a new stream a timing would leave that much allocated each time."""
    import torch

    return torch.cuda.Stream()


def cuda_time_ms(fn, *, calls: int = 20, reps: int = 50) -> float:
    """Device time of one call of ``fn``: ``calls`` calls are captured into
    one CUDA graph, the graph is replayed ``reps`` times between CUDA events,
    and the median replay time is divided by ``calls``. Eager calls would
    time the host's launch overhead as well, since the card idles while
    Python prepares each launch."""
    import torch

    side = warmup_stream()
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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
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


# the parity sweep of K1 and K2: (B, T, Dh), the main path's shape among
# them; T=127 at Dh 16 and 48 gives packed-int4 rows of 8 and 24 bytes,
# which K2 copies with cp.async instead of bulk copies
DECODE_SWEEP = ((5, 128, 64), (5, 320, 64), (5, 1024, 64), (1, 320, 64), (10, 320, 64),
                (40, 320, 64), (5, 320, 128), (5, 8192, 64), (5, 127, 16), (5, 127, 48))
B_SERVE = 40                       # 3k's batched decode: a group of 8 at beam 5
T_COLD, STEP_COLD = 1024, 640      # the HBM-cold reading at hard_max_seq_len
COLD_BYTES = 100e6                 # cache bytes a cold reading rotates over: 2x L2


def decode_origins(B: int) -> dict:
    """The beam-origin patterns of the sweep: repeated (the main path's
    [3, 0, 3, 1, 1], and so on in blocks of 5), identity, all from beam 1."""
    rep = [min(B - 1, 5 * (i // 5) + (3, 0, 3, 1, 1)[i % 5]) for i in range(B)]
    return {"repeated": rep, "identity": list(range(B)), "all-one": [min(1, B - 1)] * B}


def decode_inputs(rng, name: str, B: int, T: int, Dh: int, dtype, H: int = H_MAIN):
    """q, k_t, v_t in ``dtype`` and caches as the main path fills them: rows of
    unit-variance K/V quantized per row (absmax/127, or absmax/7 packed)."""
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    quantize = getattr(da, KERNELS[name][3])
    dev = torch.device("cuda")
    rows = [quantize(torch.as_tensor(rng.standard_normal((B, H, T, Dh)),
                                     dtype=torch.float32, device=dev)) for _ in range(2)]
    vecs = [torch.as_tensor(rng.standard_normal((B, H, Dh)), device=dev).to(dtype)
            for _ in range(3)]
    (kq, ks), (vq, vs) = rows
    return vecs, (kq, vq, ks, vs)


def hold_decode_case(name: str, label: str, args, cluster=None) -> float:
    """One launch of K1 or K2 against its plain version: the new caches and
    scales bit-equal, ``out`` within rtol = atol = 2e-5 (fp32) or 1.6e-2
    (bf16). Returns out's max abs error."""
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    kid, _, plain_name = KERNELS[name][:3]
    got = da._launch(name, *args, cluster=cluster)
    ref = getattr(da, plain_name)(*args)
    torch.cuda.synchronize()
    for cache, g, r in zip(("new_k", "new_v", "new_ks", "new_vs"), got[1:], ref[1:]):
        if not torch.equal(g, r):
            bad = (g != r).nonzero()
            raise AssertionError(f"{kid} {label}: {cache} differs in {len(bad)} entries, "
                                 f"first at {bad[0].tolist()}")
    dtype = args[0].dtype
    tol = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}[dtype]
    err = (got[0].float() - ref[0].float()).abs()
    if not bool((err <= tol * (1 + ref[0].float().abs())).all()):
        raise AssertionError(f"{kid} {label}: out max err {float(err.max()):.3g} over "
                             f"rtol = atol = {tol}")
    return float(err.max())


def decode_bound_ms(name: str, B: int, T: int, Dh: int, step: int, src, dtype) -> tuple:
    """The least time of one call on the card: the larger of its bytes over
    3.35 TB/s and its fp32 flops (two products of Dh over the rows t < step)
    over 67 TFLOP/s. Returns (ms, "bytes" or "operations")."""
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    elem = torch.finfo(dtype).bits // 8
    bytes_s = da.bound_bytes(B, H_MAIN, T, Dh, n_src=len(set(src)), elem=elem,
                             bits=KERNELS[name][4]) / HBM_BYTES_PER_S
    flops_s = 4 * B * H_MAIN * step * Dh / PEAK_FP32_FLOPS
    return max(bytes_s, flops_s) * 1e3, "bytes" if bytes_s >= flops_s else "operations"


def cold_time_ms(name: str, rng, B: int, T: int, Dh: int, step: int, dtype) -> float:
    """Device ms of one call whose caches come from HBM: the graph-captured
    calls rotate over distinct cache sets, one set a call, at least 20 of
    them and enough that ``COLD_BYTES`` of cache reads (the rows up to
    ``step`` a call) pass between two calls on one set."""
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    fn = getattr(da, KERNELS[name][1])
    read = B * H_MAIN * (step + 1) * (2 * Dh * KERNELS[name][4] // 8 + 2 * 4)  # K, V, scales
    n = max(20, math.ceil(COLD_BYTES / read))
    src = torch.tensor(decode_origins(B)["repeated"], dtype=torch.int32, device="cuda")
    sets = [decode_inputs(rng, name, B, T, Dh, dtype) for _ in range(n)]
    turn = [0]

    def call():
        vecs, caches = sets[turn[0] % n]
        turn[0] += 1
        return fn(*vecs, *caches, step, src)

    ms = cuda_time_ms(call, calls=n)
    del sets
    torch.cuda.empty_cache()
    return ms


def launch_floor_ms() -> float:
    """Device ms of the least kernel, a one-element in-place add, timed as
    the kernels are (``cuda_time_ms``): what a graph-replayed launch costs
    however little it does."""
    import torch

    x = torch.zeros(1, device="cuda")
    return cuda_time_ms(lambda: x.add_(1.0))


def phase_decode_attention(name: str, floor_ms: float) -> dict:
    """K1 or K2 against its plain version, then its times.

    Parity: at every (B, T, Dh) of ``DECODE_SWEEP`` (H=16), in fp32 and bf16,
    for each origin pattern of ``decode_origins``, at steps 0, 1, T/2 + 7,
    T - 1 and the first rows of the second and last slices of the split
    (``split_plan``); at the main path's shape also with each cluster size
    forced (1, 2, 4, 8) at steps 0, 137, T - 1 and each slice boundary.
    Caches and scales bit-equal, ``out`` within rtol = atol = 2e-5 (fp32),
    1.6e-2 (bf16).

    Times at the main path's shape (B=5, T=320, Dh=64, step 200, origins
    [3, 0, 3, 1, 1]): L2-warm (``ms``: 20 calls on one cache set), HBM-cold
    (``ms_hbm``: ``cold_time_ms``) and each forced cluster size warm; then
    HBM-cold at T=1024, step 640 beside its bound."""
    import numpy as np
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    kid, wrapper, plain_name, _, bits, source, replaces = KERNELS[name]
    fused, plain_fn = getattr(da, wrapper), getattr(da, plain_name)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    for B, T, Dh in DECODE_SWEEP:
        plan = da.split_plan(B, H_MAIN, T, Dh, bits)
        bounds = [r.start for r in plan.slices(T)[1:] if r.start < T]
        steps = sorted({0, 1, T // 2 + 7, T - 1, *bounds[:1], *bounds[-1:]} & set(range(T)))
        for dtype in (torch.float32, torch.bfloat16):
            vecs, caches = decode_inputs(rng, name, B, T, Dh, dtype)
            for pattern, origins in decode_origins(B).items():
                src = torch.tensor(origins, dtype=torch.int32, device=dev)
                for step in steps:
                    label = (f"B={B} T={T} Dh={Dh} {str(dtype)[6:]} {pattern} step "
                             f"{step}")
                    err = hold_decode_case(name, label, (*vecs, *caches, step, src))
                    max_err[dtype] = max(max_err[dtype], err)
                    cases += 1
        log(f"{kid} sweep B={B} T={T} Dh={Dh}: cluster {plan.cluster}, slices of "
            f"{plan.slice_rows} rows, tiles of {plan.tile_rows}, {plan.stages} stages, "
            f"{plan.smem_bytes} B of dynamic shared memory; steps {steps}, 3 origin "
            "patterns, fp32 and bf16: caches exact, out within tolerance")
    B, T, Dh = B_MAIN, T_MAIN, DH_MAIN
    src = torch.tensor(decode_origins(B)["repeated"], dtype=torch.int32, device=dev)
    times = {}
    cluster_ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        vecs, caches = decode_inputs(rng, name, B, T, Dh, dtype)
        for cluster in (1, 2, 4, 8):
            rows = da.split_plan(B, H_MAIN, T, Dh, bits, cluster).slice_rows
            for step in sorted({0, 137, T - 1, *range(rows, T, rows)}):
                hold_decode_case(name, f"cluster {cluster} {str(dtype)[6:]} step {step}",
                                 (*vecs, *caches, step, src), cluster)
                cases += 1
            args = (*vecs, *caches, STEP_TIMED, src)
            cluster_ms[(dtype, cluster)] = cuda_time_ms(
                lambda: da._launch(name, *args, cluster=cluster))
        args = (*vecs, *caches, STEP_TIMED, src)
        times[dtype] = {
            "ms": cuda_time_ms(lambda: fused(*args)),
            "plain_ms": cuda_time_ms(lambda: plain_fn(*args)),
            "eager_ms": eager_time_ms(lambda: fused(*args)),
            "ms_hbm": cold_time_ms(name, rng, B, T, Dh, STEP_TIMED, dtype),
            "ms_hbm_1024": cold_time_ms(name, rng, B, T_COLD, Dh, STEP_COLD, dtype),
            "bound": decode_bound_ms(name, B, T, Dh, STEP_TIMED, src.tolist(), dtype),
            "bound_1024": decode_bound_ms(name, B, T_COLD, Dh, STEP_COLD, src.tolist(),
                                          dtype)}
    log(f"{kid}: {cases} cases against {plain_name}: caches and scales exact, out max "
        f"abs err {max_err[torch.float32]:.3g} (fp32, tol 2e-5), "
        f"{max_err[torch.bfloat16]:.3g} (bf16, tol 1.6e-2)")
    plan = da.split_plan(B, H_MAIN, T, Dh, bits)
    for dtype, tm in times.items():
        bound, by = tm["bound"]
        bound_c, _ = tm["bound_1024"]
        log(f"{kid} time {str(dtype):15s} B={B} H={H_MAIN} T={T} Dh={Dh} step "
            f"{STEP_TIMED} (cluster {plan.cluster}): L2-warm {tm['ms'] * 1e3:.2f} us, "
            f"HBM-cold {tm['ms_hbm'] * 1e3:.2f} us, bound {bound * 1e3:.2f} us ({by}), "
            f"launch floor {floor_ms * 1e3:.2f} us; plain {tm['plain_ms'] * 1e3:.2f} us; "
            f"eager call with host overhead {tm['eager_ms'] * 1e3:.1f} us; library: none "
            f"(no single PyTorch call computes this function)")
        log(f"{kid} time {str(dtype):15s} T={T_COLD} step {STEP_COLD}: HBM-cold "
            f"{tm['ms_hbm_1024'] * 1e3:.2f} us, bound {bound_c * 1e3:.2f} us = "
            f"{100 * bound_c / tm['ms_hbm_1024']:.1f} % of the bound's rate")
        log(f"{kid} time {str(dtype):15s} by cluster size, L2-warm: " + ", ".join(
            f"{c}: {cluster_ms[(dtype, c)] * 1e3:.2f} us" for c in (1, 2, 4, 8)))
    # the main path runs the decoder in fp32 (the int8 embedding lookup is fp32)
    tm = times[torch.float32]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": max_err[torch.float32], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound"][0],
            "bound_by": tm["bound"][1], "library_ms": None, "ms_hbm": tm["ms_hbm"],
            "floor_ms": floor_ms, "ms_hbm_1024": tm["ms_hbm_1024"],
            "bound_ms_1024": tm["bound_1024"][0]}


# the vocabulary top-k kernels: (id, wrapper, the TPU kernel it replaces)
VOCAB_KERNELS = {
    "vocab_topk_v2": ("K3b", "int8_vocab_topk_v2",
                      "seamless_communication_tpu/ops/kernels/vocab_topk.py:170"),
    "vocab_topk": ("K3a", "int8_vocab_topk",
                   "seamless_communication_tpu/ops/kernels/vocab_topk.py:45"),
}
K3A_TILES = (512, 1024, 2048)      # K3a's tiles held and timed beside its default


def check_topk(label: str, got, ref, plain_logits) -> int:
    """Ids identical, except where the plain logits at the two ids are within
    1e-5 relative (printed and counted as a tie); vals within rtol = atol =
    1e-5; logz within rtol 1e-5. Returns the number of ties."""
    import torch

    (gv, gi, gz), (rv, ri, rz) = got, ref
    if gi.dtype != torch.int32 or gi.shape != ri.shape:
        raise AssertionError(f"{label}: ids {gi.dtype} {tuple(gi.shape)}")
    ties = 0
    for n, j in (gi != ri).nonzero().tolist():
        a, b = int(gi[n, j]), int(ri[n, j])
        la, lb = float(plain_logits[n, a]), float(plain_logits[n, b])
        if abs(la - lb) > 1e-5 * max(abs(la), abs(lb)):
            raise AssertionError(f"{label}: row {n} rank {j} id {a} ({la!r}) against "
                                 f"the plain version's {b} ({lb!r})")
        log(f"  {label}: tie at row {n} rank {j}: ids {a} and {b}, plain logits "
            f"{la!r} and {lb!r}")
        ties += 1
    verr = (gv - rv).abs()
    if not bool((verr <= 1e-5 * (1 + rv.abs())).all()):
        raise AssertionError(f"{label}: vals max err {float(verr.max()):.3g}")
    zerr = (gz - rz).abs()
    if not bool((zerr <= 1e-5 * rz.abs()).all()):
        raise AssertionError(f"{label}: logz max err {float(zerr.max()):.3g}")
    return ties


def phase_vocab_topk(smi: str) -> list:
    """K3b and K3a (at its default tile, ``fill_tile`` of the stream's grid,
    and at each tile of ``K3A_TILES``) against their plain version
    ``_reference`` at V=256102, D=1024, k=11, N=5 and 10, x rows of unit
    variance in fp32 and bf16: on the int8 table of a seeded unit-variance
    (V, D) matrix, and on a table whose rows repeat every 1000 (equal logits
    across tiles and blocks, which must go to the lowest id), there also at
    k = ``MAX_K``. Then device times by CUDA-graph replay of each function
    and its first launch alone, in turns (K3b, K3a at each tile, K3b), the
    plain version, and the full-vocabulary step the candidate beam replaces
    (the widened tied projection, the log-softmax and the stable sort over
    K*V)."""
    import torch

    from seamless_communication_torch.ops.kernels import vocab_topk as vt
    from seamless_communication_torch.ops.quantization import (
        quantize_embedding, tied_projection_quantized,
    )
    from seamless_communication_torch.ops.topk import top_k

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    table, scale = quantize_embedding(torch.randn((V_MAIN, D_MAIN), generator=gen,
                                                  device=dev))
    reps = -(-V_MAIN // 1000)
    tie_table = table[:1000].repeat(reps, 1)[:V_MAIN].contiguous()
    tie_scale = scale[:1000].repeat(reps)[:V_MAIN].contiguous()
    xs = {n: torch.randn((n, D_MAIN), generator=gen, device=dev) for n in (5, 10)}
    # (id, label, the function, its first launch alone)
    variants = [("K3b", "K3b", vt.int8_vocab_topk_v2, vt._launch_stream)]
    default = {n: vt.fill_tile(V_MAIN, vt._stream_grid(n, D_MAIN, V_MAIN, K_CAND))
               for n in xs}
    for tile in (None, *K3A_TILES):
        variants.append(("K3a", f"K3a tile={tile or 'default'}",
                         functools.partial(vt.int8_vocab_topk, tile=tile),
                         lambda x, *a, tile=tile: vt._launch_stream(
                             x, *a, tile or default[x.shape[0]])))
    log(f"K3a default tile (fill_tile of the stream's grid): "
        + ", ".join(f"N={n} {t}" for n, t in default.items()))
    max_err, ties = {"K3a": 0.0, "K3b": 0.0}, {"K3a": 0, "K3b": 0}
    for kid, name, fn, _ in variants:
        for n, x32 in xs.items():
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                for tname, (t, s) in (("random", (table, scale)),
                                      ("repeated rows", (tie_table, tie_scale))):
                    got = fn(x, t, s, K_CAND)
                    ref = vt._reference(x, t, s, K_CAND)
                    plain_logits = torch.matmul(x.float(), t.to(dtype).float().T) * s
                    torch.cuda.synchronize()
                    label = f"{name} N={n} {str(dtype)[6:]} {tname}"
                    ties[kid] += check_topk(label, got, ref, plain_logits)
                    err = float((got[0] - ref[0]).abs().max())
                    if dtype is torch.float32:
                        max_err[kid] = max(max_err[kid], err)
                    log(f"{label}: ids match (ties allowed), vals max abs err {err:.3g}, "
                        f"logz max abs err {float((got[2] - ref[2]).abs().max()):.3g}")
        # the largest k, on the repeated rows: the 128 best are copies of one
        # row, ids ascending
        for n, x32 in xs.items():
            got = fn(x32, tie_table, tie_scale, vt.MAX_K)
            ref = vt._reference(x32, tie_table, tie_scale, vt.MAX_K)
            plain_logits = torch.matmul(x32, tie_table.float().T) * tie_scale
            torch.cuda.synchronize()
            ties[kid] += check_topk(f"{name} N={n} float32 repeated rows k={vt.MAX_K}", got,
                                    ref, plain_logits)
        log(f"{name} k={vt.MAX_K} on the repeated rows: ids match")
    times, plain = {}, {}
    for n, x32 in xs.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for name, fn, first in [v[1:] for v in variants] + [variants[0][1:]]:
                f_ms = cuda_time_ms(lambda: fn(x, table, scale, K_CAND))
                k_ms = cuda_time_ms(lambda: first(x, table, scale, K_CAND))
                times.setdefault((name, n, dtype), []).append((f_ms, k_ms))
            plain[n, dtype] = cuda_time_ms(lambda: vt._reference(x, table, scale, K_CAND),
                                           calls=3, reps=10)
    bounds = {}
    for n, dtype in plain:
        elem = torch.finfo(dtype).bits // 8
        bytes_s = vt.bound_bytes(n, D_MAIN, V_MAIN, K_CAND, elem=elem) / HBM_BYTES_PER_S
        flops_s = 2 * n * V_MAIN * D_MAIN / PEAK_FP32_FLOPS
        bounds[n, dtype] = (max(bytes_s, flops_s) * 1e3,
                            "bytes" if bytes_s >= flops_s else "operations")
    for (name, n, dtype), runs in times.items():
        us = " and ".join(f"whole function {f * 1e3:.2f} us, first launch alone "
                          f"{k * 1e3:.2f} us" for f, k in runs)
        k3b = " / ".join(f"{f * 1e3:.2f}" for f, _ in times["K3b", n, dtype])
        log(f"{name} time N={n} {str(dtype)[6:]:8s}: {us}; K3b's function in the same "
            f"turn {k3b} us; plain {plain[n, dtype] * 1e3:.2f} us, bound "
            f"{bounds[n, dtype][0] * 1e3:.2f} us ({bounds[n, dtype][1]}); library: none "
            f"(no single PyTorch call computes this function) [{smi}]")
    for kid in ("K3a", "K3b"):
        log(f"{kid}: {ties[kid]} ties between near-equal plain logits")
    entries = []
    # the decoder runs in fp32, beam 5 with B=1 gives N=5
    for name, kid, label in (("vocab_topk_v2", "K3b", "K3b"),
                             ("vocab_topk", "K3a", "K3a tile=default")):
        f_ms = min(f for f, _ in times[label, 5, torch.float32])
        entry = {"name": name, "route": "cuda",
                 "source": "seamless_communication_torch/csrc/vocab_topk.cu",
                 "replaces": VOCAB_KERNELS[name][2], "max_abs_err": max_err[kid],
                 "ms": f_ms, "plain_ms": plain[5, torch.float32],
                 "bound_ms": bounds[5, torch.float32][0],
                 "bound_by": bounds[5, torch.float32][1], "library_ms": None}
        if kid == "K3a":
            entry["tile"] = default[5]
            entry["ms_by_tile"] = {tile: times[f"K3a tile={tile}", 5, torch.float32][0][0]
                                   for tile in K3A_TILES}
        entries.append(entry)
    embed = {"embedding_i8": table, "row_scale": scale}
    for n, x in xs.items():
        B, K = n // 5, 5
        scores = torch.zeros((B, K), device=dev)

        def full_vocab_step():
            lp = torch.log_softmax(tied_projection_quantized(embed, x[:, None])[:, 0],
                                   dim=-1)
            return top_k((scores[:, :, None] + lp.reshape(B, K, V_MAIN)).reshape(B, -1),
                          2 * K)

        log(f"full-vocabulary step the candidate beam replaces, N={n} (B={B}, beam "
            f"{K}): {cuda_time_ms(full_vocab_step, calls=3, reps=10) * 1e3:.2f} us "
            f"[{smi}]")
    return entries


def beam_history_table(B: int, T: int, seed: int):
    """A (B, T) row-origin table as a beam search leaves it: at each step
    every beam continues a random earlier beam (``row_src[src]``) and owns
    its new row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rs = np.tile(np.arange(B, dtype=np.int32)[:, None], (1, T))
    for t in range(1, T):
        rs = rs[rng.integers(0, B, B)]
        rs[:, t] = np.arange(B)
    return rs


def indexed_tables(B: int, T: int, seed: int) -> dict:
    """The row-origin tables K5 is held on, (B, T) int32 on the card:
    uniform draws from [0, B), a beam history (``beam_history_table``), the
    identity (every beam its own slot) and one slot for every row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    tables = {"uniform": rng.integers(0, B, (B, T)),
              "beam history": beam_history_table(B, T, seed),
              "identity": np.tile(np.arange(B)[:, None], (1, T)),
              "single slot": np.full((B, T), B - 1)}
    return {k: torch.as_tensor(v.astype(np.int32), device="cuda") for k, v in tables.items()}


def hold_indexed_case(label: str, args, cluster=None) -> float:
    """One launch of K5 against ``_indexed_reference``: ``out`` within rtol
    = atol = 2e-5 (fp32) or 1.6e-2 (bf16). Returns its max abs error."""
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    got = da._launch_indexed(*args, cluster=cluster)
    ref = da._indexed_reference(*args)
    torch.cuda.synchronize()
    tol = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}[args[0].dtype]
    err = (got.float() - ref.float()).abs()
    if not bool((err <= tol * (1 + ref.float().abs())).all()):
        raise AssertionError(f"K5 {label}: out max err {float(err.max()):.3g} over rtol = "
                             f"atol = {tol}")
    return float(err.max())


def indexed_bound_ms(table, step: int, Dh: int, dtype) -> tuple:
    """K5's least time on the card for this table and step: the larger of
    the bytes the function must move (``indexed_bound_bytes``) over 3.35
    TB/s and its fp32 flops over 67 TFLOP/s."""
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    B = table.shape[0]
    elem = torch.finfo(dtype).bits // 8
    bytes_s = da.indexed_bound_bytes(table, step, H_MAIN, Dh, elem=elem) / HBM_BYTES_PER_S
    flops_s = 4 * B * H_MAIN * step * Dh / PEAK_FP32_FLOPS
    return max(bytes_s, flops_s) * 1e3, "bytes" if bytes_s >= flops_s else "operations"


def indexed_cold_time_ms(rng, B: int, T: int, Dh: int, step: int, dtype, table) -> float:
    """Device ms of one K5 call whose caches come from HBM: the
    graph-captured calls rotate over distinct cache sets, at least 20 and
    at least ``COLD_BYTES`` of caches in all, one set a call."""
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    one = B * H_MAIN * T * (2 * Dh + 2 * 4)
    n = max(20, math.ceil(COLD_BYTES / one))
    sets = [decode_inputs(rng, "decode_attention_int8", B, T, Dh, dtype) for _ in range(n)]
    turn = [0]

    def call():
        vecs, caches = sets[turn[0] % n]
        turn[0] += 1
        return da.indexed_decode_self_attention_int8(*vecs, *caches, table, step)

    ms = cuda_time_ms(call, calls=n)
    del sets
    torch.cuda.empty_cache()
    return ms


def phase_indexed(smi: str, floor_ms: float) -> dict:
    """K5 against its plain version ``_indexed_reference``.

    Parity: at every (B, T, Dh) of ``DECODE_SWEEP`` (H=16), in fp32 and
    bf16, on each table of ``indexed_tables`` (uniform, beam history,
    identity, one slot), at steps 0, 1, T/2 + 7, T - 1 and the first rows of
    the second and last slices of the split (``split_plan(...,
    indexed=True)``); at the main path's shape also with each cluster size
    forced (1, 2, 4, 8) at steps 0, 137, T - 1 and each slice boundary.
    ``out`` within rtol = atol = 2e-5 (fp32), 1.6e-2 (bf16).

    Times at the main path's shape (B=5, T=320, Dh=64, step 200, the
    beam-history table): L2-warm (``ms``), HBM-cold (``ms_hbm``) and each
    forced cluster size warm, beside the launch floor; then HBM-cold at
    T=1024, step 640 on a uniform table beside K1 HBM-cold at the same shape
    (taken in turn: K1, K5, K5, K1) and K5's bound."""
    import numpy as np
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    rng = np.random.default_rng(4)
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    for B, T, Dh in DECODE_SWEEP:
        plan = da.split_plan(B, H_MAIN, T, Dh, 8, indexed=True)
        bounds = [r.start for r in plan.slices(T)[1:] if r.start < T]
        steps = sorted({0, 1, T // 2 + 7, T - 1, *bounds[:1], *bounds[-1:]} & set(range(T)))
        tables = indexed_tables(B, T, T + Dh)
        for dtype in (torch.float32, torch.bfloat16):
            vecs, caches = decode_inputs(rng, "decode_attention_int8", B, T, Dh, dtype)
            for tname, table in tables.items():
                for step in steps:
                    label = f"B={B} T={T} Dh={Dh} {str(dtype)[6:]} {tname} step {step}"
                    err = hold_indexed_case(label, (*vecs, *caches, table, step))
                    max_err[dtype] = max(max_err[dtype], err)
                    cases += 1
        log(f"K5 sweep B={B} T={T} Dh={Dh}: cluster {plan.cluster}, slices of "
            f"{plan.slice_rows} rows, tiles of {plan.tile_rows}, {plan.stages} stages, "
            f"{plan.smem_bytes} B of dynamic shared memory; steps {steps}, 4 tables, fp32 "
            "and bf16: out within tolerance")
    B, T, Dh = B_MAIN, T_MAIN, DH_MAIN
    table = indexed_tables(B, T, 5)["beam history"]
    times, cluster_ms = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        vecs, caches = decode_inputs(rng, "decode_attention_int8", B, T, Dh, dtype)
        for cluster in (1, 2, 4, 8):
            rows = da.split_plan(B, H_MAIN, T, Dh, 8, cluster, indexed=True).slice_rows
            for step in sorted({0, 137, T - 1, *range(rows, T, rows)}):
                hold_indexed_case(f"cluster {cluster} {str(dtype)[6:]} step {step}",
                                  (*vecs, *caches, table, step), cluster)
                cases += 1
            args = (*vecs, *caches, table, STEP_TIMED)
            cluster_ms[(dtype, cluster)] = cuda_time_ms(
                lambda: da._launch_indexed(*args, cluster=cluster))
        args = (*vecs, *caches, table, STEP_TIMED)
        times[dtype] = {
            "ms": cuda_time_ms(lambda: da.indexed_decode_self_attention_int8(*args)),
            "plain_ms": cuda_time_ms(lambda: da._indexed_reference(*args)),
            "ms_hbm": indexed_cold_time_ms(rng, B, T, Dh, STEP_TIMED, dtype, table),
            "bound": indexed_bound_ms(table, STEP_TIMED, Dh, dtype)}
    log(f"K5: {cases} cases against _indexed_reference: out max abs err "
        f"{max_err[torch.float32]:.3g} (fp32, tol 2e-5), {max_err[torch.bfloat16]:.3g} "
        f"(bf16, tol 1.6e-2)")
    plan = da.split_plan(B, H_MAIN, T, Dh, 8, indexed=True)
    for dtype, tm in times.items():
        bound, by = tm["bound"]
        log(f"K5 time {str(dtype):15s} B={B} H={H_MAIN} T={T} Dh={Dh} step {STEP_TIMED}, "
            f"beam-history table (cluster {plan.cluster}): L2-warm {tm['ms'] * 1e3:.2f} us, "
            f"HBM-cold {tm['ms_hbm'] * 1e3:.2f} us, bound {bound * 1e3:.2f} us ({by}), "
            f"launch floor {floor_ms * 1e3:.2f} us; plain {tm['plain_ms'] * 1e3:.2f} us; "
            f"library: none (no single PyTorch call computes this function) [{smi}]")
        log(f"K5 time {str(dtype):15s} by cluster size, L2-warm: " + ", ".join(
            f"{c}: {cluster_ms[(dtype, c)] * 1e3:.2f} us" for c in (1, 2, 4, 8)))
    # HBM-cold at hard_max_seq_len beside K1, in turn
    uniform = indexed_tables(B, T_COLD, 7)["uniform"]
    cold = {"K1": [], "K5": []}
    for who in ("K1", "K5", "K5", "K1"):
        cold[who].append(
            cold_time_ms("decode_attention_int8", rng, B, T_COLD, Dh, STEP_COLD,
                         torch.float32) if who == "K1" else
            indexed_cold_time_ms(rng, B, T_COLD, Dh, STEP_COLD, torch.float32, uniform))
    b1024, _ = indexed_bound_ms(uniform, STEP_COLD, Dh, torch.float32)
    k1_bound, _ = decode_bound_ms("decode_attention_int8", B, T_COLD, Dh, STEP_COLD,
                                  decode_origins(B)["repeated"], torch.float32)
    log(f"K5 time fp32 T={T_COLD} step {STEP_COLD}, uniform table, HBM-cold: "
        + ", ".join(f"{x * 1e3:.2f}" for x in cold["K5"]) + f" us (bound {b1024 * 1e3:.2f} "
        f"us = {100 * b1024 / min(cold['K5']):.1f} % of the bound's rate); K1 at the same "
        f"shape in turn: " + ", ".join(f"{x * 1e3:.2f}" for x in cold["K1"])
        + f" us (its bound {k1_bound * 1e3:.2f} us) [{smi}]")
    tm = times[torch.float32]
    return {"name": "decode_attention_indexed", "route": "cuda",
            "source": "seamless_communication_torch/csrc/decode_attention_indexed.cu",
            "replaces": "seamless_communication_tpu/ops/kernels/decode_attention.py:534",
            "max_abs_err": max_err[torch.float32], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound"][0],
            "bound_by": tm["bound"][1], "library_ms": None, "ms_hbm": tm["ms_hbm"],
            "floor_ms": floor_ms, "ms_hbm_1024": min(cold["K5"]),
            "bound_ms_1024": b1024, "k1_ms_hbm_1024": min(cold["K1"])}


FBANK_CASES = ((4.0, 512), (10.0, 1024))   # (seconds, max_frames) of K4's waveforms


def fbank_waveform(rng, seconds: float):
    """Seeded speech-like noise (noise shaped by a slow envelope) plus a
    tone, at 16 kHz, on the card."""
    import numpy as np
    import torch

    n = int(16000 * seconds)
    tt = np.arange(n) / 16000.0
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * tt) ** 2
    wav = (0.1 * envelope * rng.standard_normal(n)
           + 0.2 * np.sin(2 * np.pi * 220.0 * tt)).astype(np.float32)
    return torch.as_tensor(wav, device="cuda")


def phase_fbank(smi: str, floor_ms: float) -> dict:
    """K4 against its plain version at 16 kHz on ``FBANK_CASES``: a 4 s
    waveform with max_frames 512 and a 10 s one with max_frames 1024. On the
    energetic bins (plain log-mel > 0, as tests/unit/test_pallas_kernels.py
    holds the JAX kernel) within atol 2e-2, rtol 1e-3 and a mean error below
    2e-3; frames past the end within 1e-6. Device times beside the launch
    floor and the bound: the larger of the bytes (the samples read, the
    output written) over the memory rate and the fp32 operations of the
    frames that read a sample (an FFT's and the mel filters' nonzero
    weights', ``fbank.bound``) over the fp32 rate. cuFFT's batched
    ``torch.fft.rfft`` of the prepared frames is timed as a part of the
    function (the port never calls it)."""
    import numpy as np
    import torch

    from seamless_communication_torch.ops.kernels import fbank as fb

    rng = np.random.default_rng(6)
    max_err, results = 0.0, {}
    for seconds, max_frames in FBANK_CASES:
        x = fbank_waveform(rng, seconds)
        n = x.shape[0]
        got = fb.fbank(x, max_frames=max_frames)
        ref = fb._reference(x, max_frames)
        torch.cuda.synchronize()
        m = ref > 0
        err = (got - ref).abs()
        lim = 2e-2 + 1e-3 * ref.abs()
        past = fb.needed_frames(n, max_frames)
        past_err = float((got[past:] - ref[past:]).abs().max()) if past < max_frames else 0.0
        if not (bool((err[m] <= lim[m]).all()) and float(err[m].mean()) < 2e-3
                and past_err <= 1e-6):
            raise AssertionError(f"K4 {seconds} s: max err {float(err[m].max()):.3g}, "
                                 f"mean {float(err[m].mean()):.3g} on energetic bins, "
                                 f"{past_err:.3g} past the end")
        max_err = max(max_err, float(err[m].max()))
        k_ms = cuda_time_ms(lambda: fb.fbank(x, max_frames=max_frames))
        p_ms = cuda_time_ms(lambda: fb._reference(x, max_frames))
        frames = fb._frames_prepared(x, max_frames)
        rfft_ms = cuda_time_ms(lambda: torch.fft.rfft(frames, n=fb.NFFT, dim=-1))
        nbytes, flops = fb.bound(n, max_frames)
        bytes_s, flops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FP32_FLOPS
        bound = (max(bytes_s, flops_s) * 1e3, "bytes" if bytes_s >= flops_s else "operations")
        results[seconds] = (k_ms, p_ms, bound)
        plan = fb.frame_plan(max_frames)
        log(f"K4 {seconds:.0f} s, max_frames {max_frames} ({plan['blocks']} blocks of "
            f"{plan['frames']} frames): {int(m.sum())} energetic bins, max abs err "
            f"{float(err[m].max()):.3g}, mean {float(err[m].mean()):.3g} (atol 2e-2 + rtol "
            f"1e-3, mean < 2e-3), past the end {past_err:.3g}; device kernel "
            f"{k_ms * 1e3:.2f} us, launch floor {floor_ms * 1e3:.2f} us, plain "
            f"{p_ms * 1e3:.2f} us, bound {bound[0] * 1e3:.2f} us ({bound[1]}: "
            f"{flops / 1e9:.3f} Gflop, {nbytes / 1e6:.3f} MB); library: none [{smi}]")
        log(f"K4 {seconds:.0f} s: cuFFT torch.fft.rfft of the {max_frames} prepared frames "
            f"(a part, not the function): {rfft_ms * 1e3:.2f} us [{smi}]")
    k_ms, p_ms, bound = results[10.0]
    return {"name": "fbank", "route": "cuda",
            "source": "seamless_communication_torch/csrc/fbank.cu",
            "replaces": "seamless_communication_tpu/ops/kernels/fbank_pallas.py:74",
            "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None, "ms_4s": results[4.0][0]}


# K6 at the shapes of the main path with the fused option on (B=1, H=16,
# Dh=64; the Translator pads the fbank to a multiple of 128 frames, so 4 s
# and 10 s of audio reach the conformer as 256 and 512 frames):
# (label, Tq = Tk, bias, valid keys) with bias "shaw" (relative logits and
# key padding folded into ab), "causal" (the re-decode's causal and padding
# ab) or "segments" (key padding as segment ids, no ab)
FLASH_SHAPES = (("Shaw encoder 4 s", 256, "shaw", 249),
                ("Shaw encoder 10 s", 512, "shaw", 499),
                ("re-decode self-attention", 128, "causal", 120),
                ("NAR T2U FFT layers", 2048, "segments", 636))
FLASH_MAIN = "Shaw encoder 10 s"      # the shape of the kernels line


def flash_inputs(rng, T: int, kind: str, valid: int, dev):
    """fp32 qs (scaled), k, v, the fp32 ``ab`` (or None) and the segment ids
    (or None) of one ``FLASH_SHAPES`` entry."""
    import torch

    B, H, Dh = 1, H_MAIN, DH_MAIN
    qkv = [torch.as_tensor(rng.standard_normal((B, H, T, Dh)), dtype=torch.float32,
                           device=dev) for _ in range(3)]
    qkv[0] = qkv[0] / Dh ** 0.5
    pad = torch.where(torch.arange(T, device=dev) < valid, 0.0, -1e9)
    ab32 = seg = None
    if kind == "shaw":
        ab32 = torch.as_tensor(rng.standard_normal((B, H, T, T)) * 0.5,
                               dtype=torch.float32, device=dev) + pad
    elif kind == "causal":
        causal = torch.triu(torch.full((T, T), -1e9, device=dev), diagonal=1)
        ab32 = (causal + pad).expand(B, H, T, T).contiguous()
    else:
        seg = (torch.ones((B, T), dtype=torch.int32, device=dev),
               (pad > -1e8).to(torch.int32)[None].contiguous())
    return qkv, ab32, seg


def phase_flash_attention(smi: str) -> dict:
    """K6 ``flash_attention`` against its plain version ``_reference`` at
    ``FLASH_SHAPES`` in fp32 and bf16: ``out`` within rtol = atol = 1e-5 in
    fp32 and 1.6e-2 in bf16, and bit-equal to the ``out`` of a launch with
    residuals. Device times by CUDA-graph replay of the kernel's wrapper,
    the plain version and the library yardstick
    ``torch.nn.functional.scaled_dot_product_attention`` with the same float
    mask (ab, or the segment mask as a float), beside the bound (the
    products of the logits these inputs leave unmasked, ``unmasked_pairs``).
    Under segment ids the fp32 kernel leaves out the key tiles of
    ``skippable_tiles_fwd``; their count is shown."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from seamless_communication_torch.ops.kernels import flash_attention as fl

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    B, H, Dh = 1, H_MAIN, DH_MAIN
    tol = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
    rows, max_err = {}, 0.0
    for label, T, kind, valid in FLASH_SHAPES:
        qkv, ab32, seg = flash_inputs(rng, T, kind, valid, dev)
        for dtype in (torch.float32, torch.bfloat16):
            qs, k, v = (x.to(dtype) for x in qkv)
            ab = None if ab32 is None else ab32.to(dtype)
            args = (qs, k, v, ab, *(seg or (None, None)))
            got = fl.flash_attention(*args)
            with_res = fl._launch(*args, residuals=True)[0]
            ref = fl._reference(*args)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            if not bool((err <= tol[dtype] * (1 + ref.float().abs())).all()):
                raise AssertionError(f"K6 {label} {dtype}: out max err "
                                     f"{float(err.max()):.3g} over tolerance")
            if not torch.equal(got, with_res):
                raise AssertionError(f"K6 {label} {dtype}: out with residuals differs "
                                     "from out without them")
            if dtype is torch.float32:
                max_err = max(max_err, float(err.max()))
            mask = ab if ab is not None else torch.where(
                seg[0][:, None, :, None] == seg[1][:, None, None, :], 0.0,
                fl.MASK_VALUE).to(dtype)
            k_ms = cuda_time_ms(lambda: fl.flash_attention(*args))
            p_ms = cuda_time_ms(lambda: fl._reference(*args), calls=5, reps=20)
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=mask, scale=1.0), calls=5, reps=20)
            pairs = fl.unmasked_pairs(B, H, T, T, ab, *(seg or (None, None)))
            bound = fl.bound(B, H, T, T, Dh, dtype, ab is not None, seg is not None,
                             pairs)
            rows[label, dtype] = (k_ms, p_ms, lib_ms, bound)
            how = "wgmma"
            if dtype is torch.float32:
                skip = fl.skippable_tiles_fwd(*(seg or (None, None)), T, T, ab)
                # each block height, the choice of fp32_block_rows beside
                heights = ", ".join(
                    f"{r} rows {cuda_time_ms(lambda: fl._launch(*args, block_rows=r)) * 1e3:.2f} us"
                    for r in (32, 64))
                how = (f"{fl.fp32_block_rows(B, H, T)}-row blocks ({heights}), "
                       f"{int(skip.sum())} of {skip.numel()} tile pairs skipped")
            log(f"K6 {label}, T={T} ({valid} valid keys), {str(dtype)[6:]} ({how}): out max "
                f"abs err {float(err.max()):.3g} (rtol=atol={tol[dtype]}), equal with "
                f"residuals; device kernel "
                f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, library SDPA with "
                f"the float mask {lib_ms * 1e3:.2f} us, bound {bound[0] * 1e3:.2f} us "
                f"({bound[1]}; {pairs} unmasked logits of {H * T * T}), kernel at "
                f"{k_ms / bound[0]:.1f}x its bound [{smi}]")
    k_ms, p_ms, lib_ms, bound = rows[FLASH_MAIN, torch.float32]
    b_ms, b_p_ms, b_lib_ms, b_bound = rows[FLASH_MAIN, torch.bfloat16]
    # fp32, the kernel that inference runs, at every shape of the main path
    shapes = {label: {"ms": r[0], "plain_ms": r[1], "library_ms": r[2], "bound_ms": r[3][0],
                      "bound_by": r[3][1]}
              for (label, dtype), r in rows.items() if dtype is torch.float32}
    return {"name": "flash_attention", "route": "cuda",
            "source": "seamless_communication_torch/csrc/flash_attention.cu",
            "replaces": "seamless_communication_tpu/ops/fused_attention.py:54",
            "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms, "fp32_shapes": shapes,
            # the bf16 kernel (wgmma, TMA) at the same shape
            "bf16": {"ms": b_ms, "plain_ms": b_p_ms, "bound_ms": b_bound[0],
                     "bound_by": b_bound[1], "library_ms": b_lib_ms}}


def bwd_error(name: str, got, ref, dtype) -> float:
    """The largest error of one gradient of K6b/K6c against the plain
    backward; raises over the tolerance. fp32: 1e-4 * (1 + |ref|). bf16, where
    the kernels round p and dS at the plain backward's points: each element
    within one bf16 ulp (2^-7 * |ref| + 1e-5 * max |ref|) and ||err|| <= 2^-9
    * ||ref||, so a missed rounding point (about 0.4 % on most elements)
    fails."""
    import torch

    err = (got.float() - ref.float()).abs()
    mag = ref.float().abs()
    if dtype is torch.float32:
        ok = bool((err <= 1e-4 * (1 + mag)).all())
    else:
        ok = (bool((err <= 2.0 ** -7 * mag + 1e-5 * mag.max()).all())
              and float(err.norm()) <= 2.0 ** -9 * float(mag.norm()))
    if not ok:
        raise AssertionError(f"K6b/K6c {name} {dtype}: max err {float(err.max()):.3g}, "
                             f"||err|| {float(err.norm()):.3g} of ||ref|| "
                             f"{float(mag.norm()):.3g}: over tolerance")
    return float(err.max())


def phase_flash_attention_bwd(smi: str) -> tuple[dict, dict]:
    """K6b ``flash_attention_bwd_dkv`` and K6c ``flash_attention_bwd_dq``
    against the plain backward ``_reference_bwd`` at ``FLASH_SHAPES`` in fp32
    and bf16, both fed K6's own ``out``, ``m`` and ``l`` and one seeded dO:
    dq, dk, dv and dab within ``bwd_error``'s tolerance. K6's ``out`` with
    residuals must equal its ``out`` without them bit for bit, and ``m``,
    ``l`` agree with ``_reference_fwd``. Device times by CUDA-graph replay:
    each kernel, K6 with residuals, each kernel's plain version
    (``_reference_bwd`` of its part) and the whole plain backward; beside them
    each kernel's bound (``bound_bwd`` of its part) and the backward's. The
    library yardstick, also by CUDA-graph replay, each forward + backward
    captured whole: ``scaled_dot_product_attention`` with the same float
    mask, forward + backward beside K6 + K6b + K6c through
    ``FlashAttention``, and its backward alone (forward + backward less
    forward). No one PyTorch call computes one kernel's part (SDPA's backward
    computes dq, dk, dv and, with ``ab``, the mask's gradient), so each
    kernel's ``library_ms`` is null and both rows carry ``pair``: K6b + K6c
    together against the whole plain backward and SDPA's backward. Also
    printed: how many elements of dq, dk, dv and dab differ from
    ``_reference_bwd`` at all (TF32 off), the (row tile, key tile) pairs of
    ``skippable_tiles`` that K6c and fp32 K6b leave out, and fp32 K6b and
    K6c with 32- and 64-row (key) blocks beside the choice of
    ``fp32_block_rows``. Both rows carry every shape's fp32 numbers in
    ``fp32_shapes``. First, the fp32 kernels' shared memory and stages
    equal ``fp32_bwd_shape``'s."""
    import ctypes

    import numpy as np
    import torch
    import torch.nn.functional as F

    from seamless_communication_torch.ops.kernels import build
    from seamless_communication_torch.ops.kernels import flash_attention as fl

    dev = torch.device("cuda")
    # the plan's shared memory (fp32_bwd_shape, which the CPU tests hold to
    # the card's limit) is the kernels' own
    shape_fn = build.load("flash_attention_bwd").flash_attention_bwd_f32_shape
    shape_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    shape_fn.restype = ctypes.c_int
    for part in ("dkv", "dq"):
        for dh in fl.BWD_HEAD_DIMS:
            for block in (32, 64):
                smem, stages = ctypes.c_int(), ctypes.c_int()
                if shape_fn(int(part == "dkv"), dh, block, ctypes.byref(smem),
                            ctypes.byref(stages)) != 0 or fl.fp32_bwd_shape(
                                part, dh, block) != (smem.value, stages.value):
                    raise AssertionError(f"fp32 {part} Dh={dh} block={block}: the kernel has "
                                         f"{smem.value} bytes, {stages.value} stages; "
                                         f"fp32_bwd_shape says {fl.fp32_bwd_shape(part, dh, block)}")
    rng = np.random.default_rng(19)
    B, H, Dh = 1, H_MAIN, DH_MAIN
    rows, max_err = {}, {"dkv": 0.0, "dq": 0.0}
    for label, T, kind, valid in FLASH_SHAPES:
        qkv, ab32, seg = flash_inputs(rng, T, kind, valid, dev)
        do32 = torch.as_tensor(rng.standard_normal((B, H, T, Dh)), dtype=torch.float32,
                               device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            qs, k, v = (x.to(dtype) for x in qkv)
            ab = None if ab32 is None else ab32.to(dtype)
            segs = seg or (None, None)
            do = do32.to(dtype)
            need_dab = kind == "shaw"       # the decoder's causal ab needs none
            out, m, l = fl._launch(qs, k, v, ab, *segs, residuals=True)
            plain_out = fl._launch(qs, k, v, ab, *segs)[0]
            _, m_ref, l_ref = fl._reference_fwd(qs, k, v, ab, *segs)
            got = fl.flash_attention_bwd(qs, k, v, ab, *segs, out, m, l, do,
                                         need_dab=need_dab)
            ref = fl._reference_bwd(qs, k, v, ab, *segs, out, m, l, do)
            torch.cuda.synchronize()
            if not torch.equal(out, plain_out):
                raise AssertionError(f"K6 {label} {dtype}: out with residuals differs "
                                     f"from out without them")
            res_err = max(float(((m - m_ref).abs() / (1 + m_ref.abs())).max()),
                          float(((l - l_ref).abs() / (1 + l_ref.abs())).max()))
            if res_err > 1e-5:
                raise AssertionError(f"K6 {label} {dtype}: m, l off by {res_err:.3g}")
            errs, differ = {}, {}
            for name, g, r in zip(("dq", "dk", "dv", "dab"), got, ref):
                if name == "dab" and not need_dab:
                    if g is not None:
                        raise AssertionError("K6c wrote dab that nobody asked for")
                    continue
                errs[name] = bwd_error(f"{label} {name}", g, r, dtype)
                differ[name] = int((g != r).sum())
            skip = fl.skippable_tiles(m, *segs, T)
            if dtype is torch.float32:
                max_err["dkv"] = max(max_err["dkv"], errs["dk"], errs["dv"])
                max_err["dq"] = max(max_err["dq"], errs["dq"], errs.get("dab", 0.0))
            args = fl._bwd_args(qs, k, v, ab, *segs, out, m, l, do)
            dq, dk, dv = (torch.empty_like(x) for x in got[:3])
            dab = None if got[3] is None else fl.empty_bias(B, H, T, T, dtype, dev)
            dkv_ms = cuda_time_ms(lambda: fl._launch_one(fl.KERNEL_DKV, args, dk, dv))
            dq_ms = cuda_time_ms(lambda: fl._launch_one(fl.KERNEL_DQ, args, dq, dab))
            heights = ""
            if dtype is torch.float32:
                # each block height, the choice of fp32_block_rows beside
                heights = "; " + ", ".join(
                    f"{r}-key blocks K6b {cuda_time_ms(lambda: fl._launch_one(fl.KERNEL_DKV, args, dk, dv, r)) * 1e3:.2f} us, "
                    f"{r}-row blocks K6c {cuda_time_ms(lambda: fl._launch_one(fl.KERNEL_DQ, args, dq, dab, r)) * 1e3:.2f} us"
                    for r in (32, 64)) + (f" (the plan: {fl.fp32_block_rows(B, H, T)})")
            fwd_res_ms = cuda_time_ms(
                lambda: fl._launch(qs, k, v, ab, *segs, residuals=True))
            plain_ms = {part: cuda_time_ms(
                lambda: fl._reference_bwd(qs, k, v, ab, *segs, out, m, l, do, part=part),
                calls=5, reps=20) for part in ("all", "dkv", "dq")}
            pairs = fl.unmasked_pairs(B, H, T, T, ab, *segs)
            bargs = (B, H, T, T, Dh, dtype, ab is not None, seg is not None, pairs,
                     need_dab)
            b_all = fl.bound_bwd(*bargs)
            b_dkv = fl.bound_bwd(*bargs, part="dkv")
            b_dq = fl.bound_bwd(*bargs, part="dq")
            # the library yardstick: SDPA with the same float mask; each
            # forward + backward is captured whole into the CUDA graph (the
            # backward runs on the forward's stream), and SDPA's backward
            # alone is its forward + backward less its forward
            mask = ab if ab is not None else torch.where(
                seg[0][:, None, :, None] == seg[1][:, None, None, :], 0.0,
                fl.MASK_VALUE).to(dtype)
            leaves = [x.detach().clone().requires_grad_() for x in (qs, k, v)]
            lmask = mask.detach().clone().requires_grad_(need_dab)
            lib_in = leaves + ([lmask] if need_dab else [])
            ab_leaf = None if ab is None else ab.detach().clone().requires_grad_(need_dab)
            k6_in = leaves + ([ab_leaf] if need_dab else [])

            def lib_fwd():
                return F.scaled_dot_product_attention(*leaves, attn_mask=lmask, scale=1.0)

            def lib_step():
                torch.autograd.grad(lib_fwd(), lib_in, do)

            def k6_step():
                torch.autograd.grad(fl.flash_attention(*leaves, ab_leaf, *segs), k6_in, do)

            lib_fwd_ms = cuda_time_ms(lib_fwd, calls=5, reps=20)
            lib_step_ms = cuda_time_ms(lib_step, calls=5, reps=20)
            k6_step_ms = cuda_time_ms(k6_step, calls=5, reps=20)
            lib_bwd_ms = lib_step_ms - lib_fwd_ms
            rows[label, dtype] = (dkv_ms, dq_ms, plain_ms, lib_bwd_ms, b_dkv, b_dq, differ,
                                  int(skip.sum()))
            tol_label = "1e-4 * (1 + |ref|)" if dtype is torch.float32 else "one bf16 ulp"
            skipped = (f"{int(skip.sum())} of {skip.numel()} tile pairs skipped by K6c"
                       + (" and K6b" if dtype is torch.float32 else ""))
            log(f"K6b/K6c {label}, T={T} ({valid} valid keys), {str(dtype)[6:]}: max abs "
                f"err " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
                + f" ({tol_label}); elements that differ from the plain backward at all "
                + ", ".join(f"{n} {d} of {got[i].numel()}" for i, (n, d) in enumerate(differ.items()))
                + f"; {skipped}; m, l within {res_err:.2g}; device K6b {dkv_ms * 1e3:.2f} us (bound "
                f"{b_dkv[0] * 1e3:.2f}, {b_dkv[1]}; plain {plain_ms['dkv'] * 1e3:.2f}), "
                f"K6c {dq_ms * 1e3:.2f} us (bound {b_dq[0] * 1e3:.2f}, {b_dq[1]}; plain "
                f"{plain_ms['dq'] * 1e3:.2f}), together {(dkv_ms + dq_ms) * 1e3:.2f} us "
                f"against the backward's bound {b_all[0] * 1e3:.2f} us ({b_all[1]}; {pairs} "
                f"unmasked logits), whole plain backward {plain_ms['all'] * 1e3:.2f} us; K6 "
                f"with residuals {fwd_res_ms * 1e3:.2f} us (CUDA-graph replay){heights} [{smi}]")
            log(f"  yardstick (CUDA-graph replay of whole forward + backward steps): "
                f"SDPA forward {lib_fwd_ms * 1e3:.2f} us, forward + backward "
                f"{lib_step_ms * 1e3:.2f} us, so its backward {lib_bwd_ms * 1e3:.2f} us; "
                f"K6 + K6b + K6c through FlashAttention {k6_step_ms * 1e3:.2f} us")
    dkv_ms, dq_ms, plain_ms, lib_ms, b_dkv, b_dq, _, _ = rows[FLASH_MAIN, torch.float32]
    bf = rows[FLASH_MAIN, torch.bfloat16]
    # fp32, the kernels the fp32 trainer runs, at every shape
    shapes = {"dkv": {}, "dq": {}}
    for (label, dtype), r in rows.items():
        if dtype is not torch.float32:
            continue
        for part, ms, b, outs in (("dkv", r[0], r[4], ("dk", "dv")),
                                  ("dq", r[1], r[5], ("dq", "dab"))):
            shapes[part][label] = {
                "ms": ms, "plain_ms": r[2][part], "bound_ms": b[0], "bound_by": b[1],
                "pair_ms": r[0] + r[1], "pair_library_ms": r[3], "skipped_pairs": r[7],
                "differ": {n: d for n, d in r[6].items() if n in outs}}
    bf16 = {"dkv": {"ms": bf[0], "plain_ms": bf[2]["dkv"], "bound_ms": bf[4][0],
                    "bound_by": bf[4][1]},
            "dq": {"ms": bf[1], "plain_ms": bf[2]["dq"], "bound_ms": bf[5][0],
                   "bound_by": bf[5][1]},
            "pair": {"ms": bf[0] + bf[1], "plain_ms": bf[2]["all"], "library_ms": bf[3]}}
    src = "seamless_communication_torch/csrc/flash_attention_bwd.cu"
    lib = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    via = "seamless_communication_tpu/ops/fused_attention.py:54 -> "
    pair = {"kernels": "flash_attention_bwd_dkv + flash_attention_bwd_dq",
            "ms": dkv_ms + dq_ms, "plain_ms": plain_ms["all"], "library_ms": lib_ms,
            "library": "scaled_dot_product_attention backward (dq, dk, dv, d mask)"}
    return ({"name": "flash_attention_bwd_dkv", "route": "cuda", "source": src,
             "replaces": f"{via}{lib}:941", "max_abs_err": max_err["dkv"],
             "ms": dkv_ms, "plain_ms": plain_ms["dkv"], "bound_ms": b_dkv[0],
             "bound_by": b_dkv[1], "library_ms": None, "pair": pair,
             "fp32_shapes": shapes["dkv"],
             # the bf16 kernel (wgmma, TMA) at the same shape, and the pair
             # with K6c in bf16 against SDPA's bf16 backward
             "bf16": {**bf16["dkv"], "pair": bf16["pair"]}},
            {"name": "flash_attention_bwd_dq", "route": "cuda", "source": src,
             "replaces": f"{via}{lib}:1287", "max_abs_err": max_err["dq"],
             "ms": dq_ms, "plain_ms": plain_ms["dq"], "bound_ms": b_dq[0],
             "bound_by": b_dq[1], "library_ms": None, "pair": pair,
             "fp32_shapes": shapes["dq"],
             "bf16": {**bf16["dq"], "pair": bf16["pair"]}})


# the bf16 kernels' head dims, each with a key count that is a multiple of 8
# and one that is not (130: ab's rows padded, the last key tile ragged)
SWEEP_DH = (16, 32, 64, 128)
SWEEP_DH_FWD = (80,)            # K6 alone: the XLSR encoder's (K6b, K6c take it not)
SWEEP_TK = (136, 130)
SWEEP_BIAS = ("ab", "segments", "none")
# the attentions of phase 3g's bf16 train steps on base_v2 (B=2, H=16,
# Dh=64; two valid lengths a batch): (label, T = Tq = Tk, bias, valid
# lengths) with bias "ab" (the conformer's relative logits and key padding),
# "causal" (the decoder's causal and padding ab) or "segments" (the NAR
# T2U's FFT layers, key padding as segment ids)
TRAIN_SHAPES = (("3g conformer", 500, "ab", (500, 350)),
                ("3g decoder self-attention", 160, "causal", (160, 120)),
                ("3g T2U FFT layers", 1136, "segments", (1136, 850)))


def hold_flash_case(label: str, qkv, ab32, segs, do32, dtype) -> dict:
    """K6, K6b and K6c on one case against their plain versions: K6's out
    within rtol = atol = 1.6e-2 (bf16) or 1e-5 (fp32) of ``_reference`` and
    bit-equal with and without residuals; K6b (on K6's residuals) and K6c
    within ``bwd_error`` of ``_reference_bwd``. ``ab32`` goes into rows
    padded to 8 elements, as ``try_flash`` makes it. Returns the largest
    error of out, dq, dk and dv."""
    import torch

    from seamless_communication_torch.ops.kernels import flash_attention as fl

    qs, k, v = (x.to(dtype) for x in qkv)
    ab = None
    if ab32 is not None:
        ab = fl.empty_bias(*ab32.shape, dtype, ab32.device).copy_(ab32)
    sg = segs or (None, None)
    do = do32.to(dtype)
    out, m, l = fl._launch(qs, k, v, ab, *sg, residuals=True)
    alone = fl._launch(qs, k, v, ab, *sg)[0]
    ref = fl._reference(qs, k, v, ab, *sg)
    got = fl.flash_attention_bwd(qs, k, v, ab, *sg, out, m, l, do, need_dab=ab is not None)
    want = fl._reference_bwd(qs, k, v, ab, *sg, out, m, l, do)
    torch.cuda.synchronize()
    tol = 1.6e-2 if dtype is torch.bfloat16 else 1e-5
    err = (out.float() - ref.float()).abs()
    if not bool((err <= tol * (1 + ref.float().abs())).all()):
        raise AssertionError(f"K6 {label}: out max err {float(err.max()):.3g}")
    if not torch.equal(out, alone):
        raise AssertionError(f"K6 {label}: out with residuals differs")
    errs = {"out": float(err.max())}
    for name, g, r in zip(("dq", "dk", "dv", "dab"), got, want):
        if r is not None:
            errs[name] = bwd_error(f"{label} {name}", g, r, dtype)
    return errs


def hold_flash_fwd(label: str, qkv, ab32, segs, dtype) -> float:
    """K6 alone on one case: ``out`` within rtol = atol = 1.6e-2 (bf16) or
    1e-5 (fp32) of ``_reference`` and bit-equal with and without residuals.
    Returns the largest error."""
    import torch

    from seamless_communication_torch.ops.kernels import flash_attention as fl

    qs, k, v = (x.to(dtype) for x in qkv)
    ab = None
    if ab32 is not None:
        ab = fl.empty_bias(*ab32.shape, dtype, ab32.device).copy_(ab32)
    args = (qs, k, v, ab, *(segs or (None, None)))
    out = fl._launch(*args, residuals=True)[0]
    alone = fl._launch(*args)[0]
    ref = fl._reference(*args)
    torch.cuda.synchronize()
    tol = 1.6e-2 if dtype is torch.bfloat16 else 1e-5
    err = (out.float() - ref.float()).abs()
    if not bool((err <= tol * (1 + ref.float().abs())).all()):
        raise AssertionError(f"K6 {label}: out max err {float(err.max()):.3g}")
    if not torch.equal(out, alone):
        raise AssertionError(f"K6 {label}: out with residuals differs")
    return float(err.max())


def hold_fp32_rows(label: str, qkv, ab32, segs, do32=None) -> float:
    """fp32 K6 with each block height (32 and 64 query rows) against
    ``_reference``: ``out`` within rtol = atol = 1e-5, and bit-equal with and
    without residuals; with ``do32``, fp32 K6b and K6c too with each block
    height (32 and 64 keys, rows) against ``_reference_bwd`` within
    ``bwd_error``. Returns the largest error."""
    import torch

    from seamless_communication_torch.ops.kernels import flash_attention as fl

    ab = None
    if ab32 is not None:
        ab = fl.empty_bias(*ab32.shape, torch.float32, ab32.device).copy_(ab32)
    args = (*qkv, ab, *(segs or (None, None)))
    ref = fl._reference(*args)
    worst = 0.0
    for rows in (32, 64):
        out = fl._launch(*args, block_rows=rows)[0]
        res = fl._launch(*args, residuals=True, block_rows=rows)[0]
        torch.cuda.synchronize()
        err = (out - ref).abs()
        if not bool((err <= 1e-5 * (1 + ref.abs())).all()):
            raise AssertionError(f"K6 {label}, {rows}-row blocks: out max err "
                                 f"{float(err.max()):.3g}")
        if not torch.equal(out, res):
            raise AssertionError(f"K6 {label}, {rows}-row blocks: out with residuals "
                                 "differs")
        worst = max(worst, float(err.max()))
    if do32 is not None:
        out, m, l = fl._launch(*args, residuals=True)
        want = fl._reference_bwd(*args, out, m, l, do32)
        bargs = fl._bwd_args(*args, out, m, l, do32)
        B, H, Tq, Tk, Dh = bargs.shapes
        for rows in (32, 64):
            dq = torch.empty((B, H, Tq, Dh), device=out.device)
            dk, dv = (torch.empty((B, H, Tk, Dh), device=out.device) for _ in range(2))
            dab = None if ab is None else fl.empty_bias(B, H, Tq, Tk, torch.float32, out.device)
            fl._launch_one(fl.KERNEL_DKV, bargs, dk, dv, rows)
            fl._launch_one(fl.KERNEL_DQ, bargs, dq, dab, rows)
            torch.cuda.synchronize()
            for name, g, w in zip(("dq", "dk", "dv", "dab"), (dq, dk, dv, dab), want):
                if w is not None:
                    worst = max(worst, bwd_error(f"{label} {rows}-row blocks {name}", g, w,
                                                 torch.float32))
    return worst


def phase_flash_sweep(smi: str) -> None:
    """K6, K6b and K6c (``hold_flash_case``) at every head dim the kernels
    specialise (``SWEEP_DH``) x ``SWEEP_TK`` x ``SWEEP_BIAS``, Tq from 130 to
    200, B=2, H=3, bf16, and fp32 too at Tk = 130 with ab (the kernels read
    ab's rows by their stride); then in bf16 at the shapes of phase 3g's
    train steps (``TRAIN_SHAPES``). q, k and v heads are split from (B, T,
    H * Dh) activations as the model hands them over; ab is Shaw-like, with
    key padding."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    worst = {"out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}

    def case(B, H, dh, tq, tk, kind, valid):
        heads = lambda t, sc=1.0: torch.as_tensor(
            rng.standard_normal((B, t, H, dh)) * sc, dtype=torch.float32,
            device=dev).transpose(1, 2)
        qkv = [heads(tq, dh ** -0.5), heads(tk), heads(tk)]
        do32 = torch.as_tensor(rng.standard_normal((B, H, tq, dh)), dtype=torch.float32,
                               device=dev)
        keep = (torch.arange(tk, device=dev)[None]
                < torch.tensor(valid, device=dev)[:, None])                  # (B, Tk)
        pad = torch.where(keep, 0.0, -1e9)[:, None, None, :]
        ab32 = segs = None
        if kind == "ab":
            ab32 = torch.as_tensor(rng.standard_normal((B, H, tq, tk)) * 0.5,
                                   dtype=torch.float32, device=dev) + pad
        elif kind == "causal":
            causal = torch.triu(torch.full((tq, tk), -1e9, device=dev), diagonal=1)
            ab32 = (causal + pad).expand(B, H, tq, tk)
        elif kind == "segments":
            segs = (torch.ones((B, tq), dtype=torch.int32, device=dev),
                    keep.to(torch.int32).contiguous())
        return qkv, ab32, segs, do32

    n, fp32_err = 0, 0.0
    for dh in SWEEP_DH:
        for tk in SWEEP_TK:
            for kind in SWEEP_BIAS:
                tq = 130 + 10 * n % 80
                n += 1
                qkv, ab32, segs, do32 = case(2, 3, dh, tq, tk, kind, (tk, tk - 21))
                for dtype in (torch.bfloat16, torch.float32):
                    label = f"sweep Dh={dh} Tq={tq} Tk={tk} {kind} {str(dtype)[6:]}"
                    errs = hold_flash_case(label, qkv, ab32, segs, do32, dtype)
                    if dtype is torch.bfloat16:
                        worst = {k: max(v, errs[k]) for k, v in worst.items()}
                fp32_err = max(fp32_err, hold_fp32_rows(label, qkv, ab32, segs, do32))
    log(f"K6/K6b/K6c sweep: {n} cases (Dh {SWEEP_DH} x Tk {SWEEP_TK} x {SWEEP_BIAS}, "
        f"bf16 and fp32) within tolerance; bf16 max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"; fp32 K6 (within 1e-5), K6b and K6c (within 1e-4 * (1 + |ref|)) with 32- and "
        f"64-row (key) blocks, max abs err {fp32_err:.3g} [{smi}]")
    # K6 alone at the head dims of its forward only; the backward raises there
    from seamless_communication_torch.ops.kernels import flash_attention as fl

    n_fwd, fwd_err = 0, {"bf16": 0.0, "fp32": 0.0}
    for dh in SWEEP_DH_FWD:
        for tk in SWEEP_TK:
            for kind in SWEEP_BIAS:
                tq = 130 + 10 * n_fwd % 80
                n_fwd += 1
                qkv, ab32, segs, _ = case(2, 3, dh, tq, tk, kind, (tk, tk - 21))
                label = f"sweep Dh={dh} Tq={tq} Tk={tk} {kind}"
                fwd_err["bf16"] = max(fwd_err["bf16"], hold_flash_fwd(
                    label + " bf16", qkv, ab32, segs, torch.bfloat16))
                fwd_err["fp32"] = max(fwd_err["fp32"], hold_fp32_rows(
                    label + " fp32", qkv, ab32, segs))
        qs, k, v = qkv
        out, m, l = fl._launch(qs, k, v, None, None, None, residuals=True)
        try:
            fl.flash_attention_bwd(qs, k, v, None, None, None, out, m, l, out)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError(f"K6b/K6c took head dim {dh}")
    log(f"K6 sweep of its forward-only head dims: {n_fwd} cases (Dh {SWEEP_DH_FWD} x Tk "
        f"{SWEEP_TK} x {SWEEP_BIAS}) within tolerance; max abs err bf16 "
        f"{fwd_err['bf16']:.3g}, fp32 (32- and 64-row blocks) {fwd_err['fp32']:.3g}; the "
        f"backward raises: {refused} [{smi}]")
    for label, T, kind, valid in TRAIN_SHAPES:
        qkv, ab32, segs, do32 = case(2, H_MAIN, DH_MAIN, T, T, kind, valid)
        for dtype in (torch.bfloat16, torch.float32):
            errs = hold_flash_case(label, qkv, ab32, segs, do32, dtype)
            log(f"K6/K6b/K6c {label}, B=2, T={T} (valid {valid}), {kind}, "
                f"{str(dtype)[6:]}: within tolerance; max abs err "
                + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" [{smi}]")
    # the NAR T2U's FFT shape with rows in a segment no key has: their keys
    # are all masked (m at the mask level), so K6c and fp32 K6b may skip
    # none of their row tiles' key tiles, while they skip the padding's
    # elsewhere
    from seamless_communication_torch.ops.kernels import flash_attention as fl

    T, valid = 2048, 636
    qkv, _, segs, do32 = case(1, H_MAIN, DH_MAIN, T, T, "segments", (valid,))
    q_seg = segs[0].clone()
    q_seg[:, 1500:1564] = 7
    segs = (q_seg, segs[1])
    _, m, _ = fl._reference_fwd(*(x.to(torch.bfloat16) for x in qkv), None, *segs)
    skip = fl.skippable_tiles(m, *segs, T)
    skip_fwd = fl.skippable_tiles_fwd(*segs, T, T)
    for dtype in (torch.bfloat16, torch.float32):
        errs = hold_flash_case("FFT all-masked rows", qkv, None, segs, do32, dtype)
        log(f"K6/K6b/K6c NAR T2U FFT, T={T} ({valid} valid keys), rows 1500-1563 in a "
            f"segment no key has, {str(dtype)[6:]}: within tolerance; max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; K6c and fp32 K6b skip {int(skip.sum())} of {skip.numel()} tile pairs, fp32 "
            f"K6 {int(skip_fwd.sum())} of {skip_fwd.numel()} [{smi}]")


# Parts of K6b and K6c left out one at a time (text replaced in a copy of
# their source), by dtype: where their time goes. The results of all but
# the first are wrong.
K6B_PARTS = {
    "bf16": {
        "as built": [],
        "no fp32 products (S^T, dP^T)": [(
            "    if (warp < 2)\n      dots<DH, BQ>(k32, q32, tr_s, warp, lane);\n    else\n"
            "      dots<DH, BQ>(v32, do32, tr_d, warp - 2, lane);\n", "")],
        "no expf": [("const float ex = expf(x - mi);", "const float ex = x - mi;")],
        "no widening of Q, dO": [(
            "    widen<DH, BQ>(st, q32, tid);\n    widen<DH, BQ>(st + S::kRowBytes, do32, tid);\n",
            "")],
        "no ab reads": [("if (HAS_AB) x += ab_at(ab_s, c, r0 + 8 * u);", "if (HAS_AB) x += 0.5f;")],
        "no dV, dK wgmma (and so no p, dS)": [
            (f"    for (int kk = 0; kk < BQ / 16; ++kk)\n      hopper::Wgmma<DH>::rs(\n          {g},",
             f"    for (int kk = 0; kk < 0; ++kk)\n      hopper::Wgmma<DH>::rs(\n          {g},")
            for g in ("dv", "dk")],
    },
    "fp32": {
        "as built": [],
        "no S^T, dP^T products": [(
            "    for (int d4 = 0; d4 < DH / 4; ++d4) {\n      constexpr int kChunks = SWZ / 16;\n"
            "      const int part = d4 / kChunks, cc = d4 % kChunks;\n"
            "      const uint8_t* r_at = rows_t + part * BQ * SWZ",
            "    for (int d4 = 0; d4 < 0; ++d4) {\n      constexpr int kChunks = SWZ / 16;\n"
            "      const int part = d4 / kChunks, cc = d4 % kChunks;\n"
            "      const uint8_t* r_at = rows_t + part * BQ * SWZ")],
        "no expf": [("kok[c] ? expf(x - mi) * il : 0.f", "kok[c] ? (x - mi) * il : 0.f")],
        "no ab reads": [("if (a.has_ab) x += ab_at<BQ>(ab_t, r, kgrp + j);",
                         "if (a.has_ab) x += 0.5f;")],
        "no dV, dK products": [
            ("      accumulate_rows<DH, BQ, VK, VD, PLD>(p_s + VK * kg, do_t, dg, nrows, acc);\n", ""),
            ("      accumulate_rows<DH, BQ, VK, VD, PLD>(ds_s + VK * kg, q_t, dg, nrows, acc);\n", "")],
        "no tile skipping": [("    const bool rule = seg && kt < kMaxSkipTiles;",
                              "    const bool rule = false;")],
    },
}
K6C_PARTS = {
    "bf16": {
        "as built": [],
        "no fp32 products (S, dP)": [(
            "    if (wl < 2)\n      dots_dq<DH>(q_s, st, tr_s, wl, lane);\n    else\n"
            "      dots_dq<DH>(do_s, st + S::kKvBytes, tr_d, wl - 2, lane);\n", "")],
        "no expf": [("const float p = kok ? expf(x - mi[u]) * il[u] : 0.f;",
                     "const float p = kok ? (x - mi[u]) * il[u] : 0.f;")],
        "no ab reads": [("        ab0 = ab_pair(ab_s, r0, col);\n        ab1 = ab_pair(ab_s, r0 + 8, col);",
                         "        ab0 = make_float2(0.5f, 0.5f);\n        ab1 = ab0;")],
        "no dab stores": [("    if (a.dab != nullptr) {\n      // while the product runs",
                           "    if (false) {\n      // while the product runs")],
        "no dQ wgmma": [("    for (int kk = 0; kk < BK / 16; ++kk)\n      hopper::Wgmma<DH>::rs(dq, da[kk],",
                         "    for (int kk = 0; kk < 0; ++kk)\n      hopper::Wgmma<DH>::rs(dq, da[kk],")],
    },
    "fp32": {
        "as built": [],
        "no S, dP products": [(
            "    for (int d4 = 0; d4 < DH / 4; ++d4) {\n      constexpr int kChunks = SWZ / 16;\n"
            "      const int part = d4 / kChunks, cc = d4 % kChunks;\n"
            "      const uint8_t* r_at = rows_s + part * BM * SWZ",
            "    for (int d4 = 0; d4 < 0; ++d4) {\n      constexpr int kChunks = SWZ / 16;\n"
            "      const int part = d4 / kChunks, cc = d4 % kChunks;\n"
            "      const uint8_t* r_at = rows_s + part * BM * SWZ")],
        "no expf": [("const float ex = expf(x - mi[i]);", "const float ex = x - mi[i];")],
        "no ab reads": [("if (a.has_ab) x += ab_at<BM>(ab_t, rgrp + r, j);",
                         "if (a.has_ab) x += 0.5f;")],
        "no dab stores": [("    if (a.out1 != nullptr) {\n      for (int e = gt; e < GR * BK / 4;",
                           "    if (false) {\n      for (int e = gt; e < GR * BK / 4;")],
        "no dQ product": [("rows_in_order(4 * ((min(BK, a.Tk - k0) + 3) / 4), [&]",
                           "rows_in_order(0, [&]")],
        "no tile skipping": [("      if (seg && !at_mask[0]) {", "      if (false) {")],
    },
}


# Parts of fp32 K6 left out one at a time: where its time goes (all but the
# first give wrong results)
K6_PARTS = {
    "as built": [],
    "no S product": [("    for (int d4 = 0; d4 < DH / 4; ++d4) {",
                      "    for (int d4 = 0; d4 < 0; ++d4) {")],
    "no P V product": [("    for (int j4 = 0; j4 < BK / 4; ++j4) {",
                        "    for (int j4 = 0; j4 < 0; ++j4) {")],
    "no expf of p": [("        const float p = live ? expf(sc[i][c] - m_new) : 0.f;",
                      "        const float p = live ? sc[i][c] - m_new : 0.f;")],
    "no ab reads": [("          sc[i][c] += *reinterpret_cast<const float*>(ab_at + off + 16 * i * 128);",
                     "          sc[i][c] += 0.5f;")],
}

# Parts of K3b's stream (its first launch) left out: the products (the
# widening and the FMAs), so that what remains is the table's stream, the
# logits' bookkeeping and the lists.
K3B_PARTS = {
    "as built": [],
    "no products (the stream alone)": [(
        "#pragma unroll\n        for (int u = 0; u < 4; ++u) {\n          float w[8][4];",
        "#pragma unroll\n        for (int u = 0; u < 0; ++u) {\n          float w[8][4];")],
}
# K3a's first launch is K3b's stream with a list a tile
K3A_PARTS = {
    **K3B_PARTS,
    "the flushes left out but each block's last (wrong out)": [(
        "const bool flush = kPerTile && (t + 1 == t1 || (t + 1) % span == 0);",
        "const bool flush = kPerTile && t + 1 == t1;")],
}
K4_PARTS = {
    "as built": [],
    "staging only (wrong out)": [(
        "  const int f = f0 + warp;\n", "  if (n > 0) return;\n  const int f = f0 + warp;\n")],
    "without the FFT (wrong out)": [(
        "  fft256(zr, zi, re, im, tw_c, tw_s, lane);\n",
        "  for (int m = 0; m < 8; ++m) {\n    re[lane + 32 * m] = zr[m];\n"
        "    im[lane + 32 * m] = zi[m];\n  }\n  __syncwarp();\n")],
    "without the mel (wrong out)": [(
        "      if (j < len[u]) acc[u] = fmaf(re[lo[u] + j], w_s[off[u] + j], acc[u]);\n",
        "      if (j < len[u]) acc[u] = re[lo[u]] + w_s[off[u]];\n")],
}


def kernel_parts(smi: str, which: str, dtype: str = "bf16") -> None:
    """``python3 chip_smoke.py --k6b-parts [bf16|fp32]`` (``--k6c-parts``,
    ``--k6-parts``, ``--k3b-parts``, ``--k3a-parts``, ``--k4-parts``): K6b
    (K6c) of ``dtype``, bf16 at ``FLASH_MAIN`` and fp32 at every
    ``FLASH_SHAPES`` shape, fp32 K6 at every shape, K3b's stream at N = 5
    and 10 in fp32, K3a's first launch there at each tile of ``K3A_TILES``,
    or K4 at ``FBANK_CASES``, as built and with each
    part of ``K6B_PARTS[dtype]`` (``K6C_PARTS[dtype]``, ``K6_PARTS``,
    ``K3B_PARTS``, ``K3A_PARTS``, ``K4_PARTS``) left out, each a copy of its source built with the
    package's nvcc flags into a temporary directory and loaded in place of
    the built library; device µs by CUDA-graph replay, the best of three."""
    import ctypes
    import concurrent.futures
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from seamless_communication_torch.ops.kernels import build
    from seamless_communication_torch.ops.kernels import flash_attention as fl

    from seamless_communication_torch.ops.kernels import vocab_topk as vt

    parts, kernel, kid = {"k6b": (K6B_PARTS[dtype], fl.KERNEL_DKV, "K6b"),
                          "k6c": (K6C_PARTS[dtype], fl.KERNEL_DQ, "K6c"),
                          "k6": (K6_PARTS, fl.KERNEL, "K6"),
                          "k3b": (K3B_PARTS, vt.KERNEL, "K3b"),
                          "k3a": (K3A_PARTS, vt.KERNEL_V1, "K3a"),
                          "k4": (K4_PARTS, "fbank", "K4")}[which]
    src = build.CSRC_DIR / {"k3b": "vocab_topk.cu", "k3a": "vocab_topk.cu", "k4": "fbank.cu",
                            "k6": "flash_attention.cu"}.get(which, "flash_attention_bwd.cu")
    tmp = Path(tempfile.mkdtemp())
    for header in build._sources(src, [])[1:]:
        (tmp / header.name).write_bytes(header.read_bytes())

    def compile_part(i_name):
        i, name = i_name
        text = src.read_text()
        for old, new in parts[name]:
            if text.count(old) != 1:
                raise AssertionError(f"{which}-parts {name}: the source has changed")
            text = text.replace(old, new)
        cu, lib = tmp / f"part{i}.cu", tmp / f"part{i}.so"
        cu.write_text(text)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                       check=True, capture_output=True)
        return name, lib

    with concurrent.futures.ThreadPoolExecutor(len(parts)) as pool:
        libs = list(pool.map(compile_part, enumerate(parts)))
    dev = torch.device("cuda")
    if which == "k4":
        from seamless_communication_torch.ops.kernels import fbank as fb

        rng = np.random.default_rng(6)
        cases = [(seconds, max_frames, fbank_waveform(rng, seconds))
                 for seconds, max_frames in FBANK_CASES]
        try:
            for name, lib in libs:
                so = ctypes.CDLL(str(lib))
                so.fbank.argtypes, so.fbank.restype = fb._ARGTYPES, ctypes.c_int
                so.cuda_error_string.argtypes = [ctypes.c_int]
                so.cuda_error_string.restype = ctypes.c_char_p
                fb._function[:] = [so.fbank, so.cuda_error_string]
                us = [min(cuda_time_ms(lambda: fb.fbank(x, max_frames=mf))
                          for _ in range(3)) * 1e3 for _, mf, x in cases]
                log(f"K4, {name}: " + ", ".join(f"{sec:.0f} s {t:.2f} us" for (sec, _, _), t
                                                 in zip(cases, us)) + f" [{smi}]")
        finally:
            fb._function.clear()
        return
    if which in ("k3b", "k3a"):
        from seamless_communication_torch.ops.quantization import quantize_embedding

        gen = torch.Generator(device=dev).manual_seed(0)
        table, scale = quantize_embedding(torch.randn((V_MAIN, D_MAIN), generator=gen,
                                                      device=dev))
        xs = {n: torch.randn((n, D_MAIN), generator=gen, device=dev) for n in (5, 10)}
        try:
            for name, lib in libs:
                so = ctypes.CDLL(str(lib))
                vt._functions.clear()
                vt._grids.clear()
                for entry, argtypes in vt._ENTRY.items():
                    fn = getattr(so, entry)
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                    so.cuda_error_string.argtypes = [ctypes.c_int]
                    so.cuda_error_string.restype = ctypes.c_char_p
                    vt._functions[entry] = (fn, so.cuda_error_string)
                for tile in (None,) if which == "k3b" else K3A_TILES:
                    us = {n: min(cuda_time_ms(lambda: vt._launch_stream(x, table, scale,
                                                                         K_CAND, tile))
                                 for _ in range(3)) * 1e3 for n, x in xs.items()}
                    what = "K3b stream" if tile is None else f"K3a first launch, tile={tile}"
                    log(f"{what}, fp32, {name}: N=5 {us[5]:.2f} us, N=10 {us[10]:.2f} us "
                        f"[{smi}]")
        finally:
            vt._functions.clear()
            vt._grids.clear()
        return
    if which == "k6":
        cases = {}
        for label, T, kind, valid in FLASH_SHAPES:
            qkv, ab32, seg = flash_inputs(np.random.default_rng(19), T, kind, valid, dev)
            ab = None if ab32 is None else fl.empty_bias(*ab32.shape, torch.float32,
                                                         dev).copy_(ab32)
            cases[label] = (*qkv, ab, *(seg or (None, None)))
        try:
            for name, lib in libs:
                so = ctypes.CDLL(str(lib))
                fn = getattr(so, kernel)
                fn.argtypes, fn.restype = fl._ENTRY[kernel][1], ctypes.c_int
                so.cuda_error_string.argtypes = [ctypes.c_int]
                so.cuda_error_string.restype = ctypes.c_char_p
                fl._functions[kernel] = (fn, so.cuda_error_string)
                us = {label: min(cuda_time_ms(lambda: fl._launch(*args)) for _ in range(3))
                      * 1e3 for label, args in cases.items()}
                log(f"K6 fp32, {name}: " + ", ".join(f"{label} {t:.2f} us"
                                                     for label, t in us.items()) + f" [{smi}]")
        finally:
            fl._functions.pop(kernel, None)
        return
    torch_dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    shapes = FLASH_SHAPES if dtype == "fp32" else [x for x in FLASH_SHAPES if x[0] == FLASH_MAIN]
    cases = {}
    for label, T, kind, valid in shapes:
        qkv, ab32, seg = flash_inputs(np.random.default_rng(19), T, kind, valid, dev)
        qs, k, v = (x.to(torch_dtype) for x in qkv)
        ab = None if ab32 is None else fl.empty_bias(*ab32.shape, torch_dtype, dev).copy_(ab32)
        segs = seg or (None, None)
        do = torch.randn_like(qs)
        out, m, l = fl._launch(qs, k, v, ab, *segs, residuals=True)
        args = fl._bwd_args(qs, k, v, ab, *segs, out, m, l, do)
        if which == "k6b":
            outs = (torch.empty_like(k), torch.empty_like(v))
        else:   # dab where the main path asks for it (the encoder's Shaw ab)
            outs = (torch.empty_like(qs), None if kind != "shaw" else
                    fl.empty_bias(1, H_MAIN, T, T, torch_dtype, dev))
        cases[label] = (args, outs)
    try:
        for name, lib in libs:
            so = ctypes.CDLL(str(lib))
            fn = getattr(so, kernel)
            fn.argtypes, fn.restype = fl._ENTRY[kernel][1], ctypes.c_int
            so.cuda_error_string.argtypes = [ctypes.c_int]
            so.cuda_error_string.restype = ctypes.c_char_p
            fl._functions[kernel] = (fn, so.cuda_error_string)
            us = {label: min(cuda_time_ms(lambda: fl._launch_one(kernel, args, *outs))
                             for _ in range(3)) * 1e3 for label, (args, outs) in cases.items()}
            log(f"{kid} {dtype}, {name}: " + ", ".join(f"{label} {t:.2f} us"
                                                     for label, t in us.items()) + f" [{smi}]")
    finally:
        fl._functions.pop(kernel, None)


# ``--k12-trace``: stage marks and variants of csrc/decode_attention.cuh.
# A mark is (text of the header, where its mark goes: "before" it, "after"
# it or "mid" (after its first line), the mark's index, the condition under
# which a block's thread writes it).
K12_MARKS = (
    ("    hopper::fence_proxy_async_smem();  // the barriers, to the bulk copies\n  }\n",
     "after", 1, "threadIdx.x == 32"),
    ("  const int s = kIndexed ? 0 : __ldg(p.src + b);\n", "after", 2,
     "threadIdx.x == 32 && s >= 0"),
    ("  } else {\n    __syncthreads();  // the barriers are initialised", "before", 3,
     "threadIdx.x == 32"),
    ("  const float lcur = lcur_s;\n", "before", 4, "threadIdx.x == 0"),
    ("    hopper::mbar_wait(&full[i % stages], (i / stages) & 1);\n    store_tile(i, tile, kq_s);\n",
     "mid", 5, "threadIdx.x == 0 && i == 0"),
    ("  // ---- the max over the cluster's rows", "before", 6, "threadIdx.x == 0"),
    ("  m = fmaxf(fmaxf(m, kNeg), lcur);\n", "before", 7, "threadIdx.x == 0"),
    ("  // ---- v tiles", "before", 8, "threadIdx.x == 0"),
    ("    store_tile(i, tile, vq_s);\n", "after", 9, "threadIdx.x == 0 && i == n_half"),
    ("  // ---- merge:", "before", 10, "threadIdx.x == 0"),
    ("  if (rank == 0) {\n    const float pc", "before", 11, "threadIdx.x == 0"),
    ("    if (producer) hopper::bulk_wait_read<0>();  // the stores have read the ring\n",
     "after", 12, "threadIdx.x == 0"),
)
K12_STAGES = ("entry", "barriers", "origin", "copies issued", "current row + scales",
              "first k tile", "k logits", "cluster max", "weights", "first v tile",
              "v sums", "merged", "end")
K12_VARIANTS = {
    "as built": [],
    "without the max exchange (wrong out)": [
        ("    if (tid < c) hopper::st_async(&max_s[rank], tid, m, &max_bar);\n"
         "    hopper::mbar_wait<true>(&max_bar, 0);\n    m = max_s[0];\n"
         "    for (int j = 1; j < c; ++j) m = fmaxf(m, max_s[j]);\n", "")],
    "without the bulk stores (no new caches)": [
        ("        hopper::bulk_store(g, tile, nr * rb);\n", "")],
    "without the scale loads (wrong out)": [
        ("          ks[u] = __ldg(p.k_scale + row_of(t));\n"
         "          vs[u] = __ldg(p.v_scale + row_of(t));\n", "          ks[u] = vs[u] = 1.f;\n")],
    "with two issuing threads": [
        ("  const bool producer = tid == 32;\n  if (producer) {\n"
         "    for (int i = 0; i < stages; ++i) hopper::mbar_init(&full[i], kBulk ? 1 : kThreads);",
         "  const bool producer = tid == 32, second = tid == 64;\n  if (producer || second) {\n"
         "    for (int i = second; i < stages; i += 2) hopper::mbar_init(&full[i], kBulk ? 1 : kThreads);"),
        ("    if (producer)\n      for (int i = 0; i < min(stages, n_tiles); ++i) load_tile(i);",
         "    if (producer || second)\n      for (int i = second; i < min(stages, n_tiles); i += 2) load_tile(i);")],
    "with programmatic dependent launch": [
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
         "  asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n"),
        ("  cudaLaunchAttribute attr[1];", "  cudaLaunchAttribute attr[2];"),
        ("  cfg.numAttrs = 1;",
         "  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
         "  attr[1].val.programmaticStreamSerializationAllowed = 1;\n  cfg.numAttrs = 2;")],
}


# ``--k5-trace``: K5's stage marks, K1's where the stage is the same; the
# rows' slots are loaded by the barrier before the copies, every thread
# issues copies, and no bulk store ends the kernel
K5_MARKS = tuple(m for m in K12_MARKS if m[2] not in (2, 3, 12)) + (
    ("    __syncthreads();  // the barriers are initialised\n", "after", 2, "threadIdx.x == 0"),
    ("    for (int i = 0; i < min(stages, n_tiles); ++i) load_tile(i);\n  }\n", "after", 3,
     "threadIdx.x == 0"),
    ("  if constexpr (kBulk)\n    if (producer) hopper::bulk_wait_read<0>();", "before", 12,
     "threadIdx.x == 0"),
)
K5_STAGES = ("entry", "barriers", "row slots", "copies issued", *K12_STAGES[4:])
# K5's ways of bringing in its rows (text of the header replaced)
K5_VARIANTS = {
    "as built (16-byte cp.async copies)": [],
    "a bulk copy a row": [(
        "      const int cpr = rb / 16;\n"
        "      for (int w = tid; w < nr * cpr; w += kThreads) {\n"
        "        const int r = w / cpr, k = w - r * cpr;\n"
        "        hopper::cp_async_16(dst + r * rb + 16 * k, cache + row_of(t0 + r) * rb + 16 * k);\n"
        "      }\n"
        "      hopper::cp_async_arrive_noinc(bar);\n",
        "      hopper::mbar_arrive_expect_tx(bar, tid < nr ? ((nr - 1 - tid) / kThreads + 1) * rb : 0);\n"
        "      for (int r = tid; r < nr; r += kThreads)\n"
        "        hopper::bulk_load(dst + r * rb, cache + row_of(t0 + r) * rb, rb, bar);\n")],
    "every row from slot 0 (wrong out: the table's indirection left out)": [(
        "cache + row_of(t0 + r) * rb + 16 * k);",
        "cache + ((size_t)h * T_len + r0 + t0 + r) * rb + 16 * k);")],
    "the copy loop unrolled by 4": [(
        "      for (int w = tid; w < nr * cpr; w += kThreads) {\n",
        "#pragma unroll 4\n      for (int w = tid; w < nr * cpr; w += kThreads) {\n")],
    "chunks by shift (Dh = 64 only)": [(
        "        const int r = w / cpr, k = w - r * cpr;\n",
        "        const int r = w >> 2, k = w & 3;\n")],
}


def k12_library(tmp, i: int, edits, k5: bool = False):
    """K1's (``k5``: K5's) source with the header's ``edits`` and every mark
    of ``K12_MARKS`` (``K5_MARKS``: a globaltimer read of thread 0 into
    ``g_trace``, read back by ``read_trace``), built into ``tmp``. Each copy
    has a namespace of its own: two libraries of one process must not share
    a kernel's name."""
    from seamless_communication_torch.ops.kernels import build

    hdr = (build.CSRC_DIR / "decode_attention.cuh").read_text()
    marks = [*(K5_MARKS if k5 else K12_MARKS),
             ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
              "before", 0, "threadIdx.x == 0")]
    for old, new in edits:
        if hdr.count(old) != 1:
            raise AssertionError("--k12-trace: decode_attention.cuh has changed")
        hdr = hdr.replace(old, new)
    for text, where, k, cond in marks:
        if hdr.count(text) != 1:
            raise AssertionError("--k12-trace: decode_attention.cuh has changed")
        mark = f"  if ({cond}) trace_at({k});\n"
        first, _, rest = text.partition("\n")
        hdr = hdr.replace(text, {"before": mark + text, "after": text + mark,
                                 "mid": first + "\n" + mark + rest}[where])
    hdr = hdr.replace("namespace DECODE_STEP_NS {\n", "namespace DECODE_STEP_NS {\n"
                      "__device__ unsigned long long g_trace[8192 * 16];\n"
                      "__device__ __forceinline__ void trace_at(int k) {\n"
                      "  unsigned long long t;\n"
                      "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
                      "  g_trace[(blockIdx.y * gridDim.x + blockIdx.x) * 16 + k] = t;\n}\n")
    tag = f"k{5 if k5 else 12}_{i}"
    ns = f"decode_step_{tag}"
    (tmp / f"trace_{tag}.cuh").write_text(hdr.replace("decode_step", ns))
    # K5's source names its own namespace, decode_step_indexed
    src = (build.CSRC_DIR / ("decode_attention_indexed.cu" if k5 else "decode_attention.cu")
           ).read_text().replace("decode_step", ns).replace(
               '#include "decode_attention.cuh"', f'#include "trace_{tag}.cuh"')
    lib_ns = ns + "_indexed" if k5 else ns
    src += ('extern "C" int read_trace(unsigned long long* host) {\n'
            f"  return (int)cudaMemcpyFromSymbol(host, {lib_ns}::g_trace, "
            f"sizeof({lib_ns}::g_trace));\n}}\n")
    cu, lib = tmp / f"{ns}.cu", tmp / f"{ns}.so"
    cu.write_text(src)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)], check=True,
                   capture_output=True)
    return lib


def k12_trace(smi: str) -> None:
    """``python3 chip_smoke.py --k12-trace``: where K1's time goes at the
    main path's shape (B=5, H=16, T=320, Dh=64, step 200, fp32). Copies of
    the kernel (``k12_library``), as built and with each variant of
    ``K12_VARIANTS``, are held against the plain version and timed by
    CUDA-graph replay at cluster sizes 1, 2 and 4, and after a one-element
    add (the pair's time: a kernel that follows another one); the copy as
    built is also timed with tiles of 4 and 2 KB, and its globaltimer marks
    give each stage's time from the first block's entry (the median over
    the blocks, and the range)."""
    import concurrent.futures
    import ctypes
    import dataclasses
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from seamless_communication_torch.ops.kernels import build
    from seamless_communication_torch.ops.kernels import decode_attention as da

    tmp = Path(tempfile.mkdtemp())
    (tmp / "hopper.cuh").write_text((build.CSRC_DIR / "hopper.cuh").read_text())
    with concurrent.futures.ThreadPoolExecutor(len(K12_VARIANTS)) as pool:
        libs = list(pool.map(lambda a: k12_library(tmp, *a), enumerate(K12_VARIANTS.values())))
    B, H, T, Dh, step = B_MAIN, H_MAIN, T_MAIN, DH_MAIN, STEP_TIMED
    vecs, caches = decode_inputs(np.random.default_rng(0), "decode_attention_int8", B, T, Dh,
                                 torch.float32)
    src = torch.tensor(decode_origins(B)["repeated"], dtype=torch.int32, device="cuda")
    ref = da._reference(*vecs, *caches, step, src)
    outs = [torch.empty_like(x) for x in (vecs[0], *caches)]
    y = torch.zeros(1, device="cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in zip(K12_VARIANTS, libs):
        so = ctypes.CDLL(str(lib))
        fn = so.decode_attention_int8
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                       i, i, i, i, p, p, p, p, p, p]
        so.read_trace.argtypes = [p]
        plans = {f"cluster {c}": da.split_plan(B, H, T, Dh, 8, c) for c in (1, 2, 4)}
        if name == "as built":
            for kb in (4, 2):
                rows = kb * 1024 // Dh
                plans[f"cluster 4, {kb} KB tiles"] = dataclasses.replace(
                    plans["cluster 4"], tile_rows=rows,
                    stages=2 * -(-plans["cluster 4"].slice_rows // rows))
        for label, plan in plans.items():
            def call():
                err = fn(0, *(x.data_ptr() for x in vecs), *(x.data_ptr() for x in caches),
                         src.data_ptr(), B, H, T, Dh, step, math.sqrt(Dh), plan.cluster,
                         plan.slice_rows, plan.tile_rows, plan.stages,
                         *(x.data_ptr() for x in outs),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"--k12-trace {name} {label}: launch failed ({err})")

            def pair():
                y.add_(1.0)
                call()
            for x in outs:
                x.zero_()
            call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(outs[1:], ref[1:])) and bool(
                torch.allclose(outs[0], ref[0], rtol=2e-5, atol=2e-5))
            log(f"K1 --k12-trace {name}, {label}: {cuda_time_ms(call) * 1e3:.2f} us; after "
                f"a one-element add {cuda_time_ms(pair) * 1e3:.2f} us the pair; equal to the "
                f"plain version: {same} [{smi}]")
            if name != "as built" or label not in ("cluster 1", "cluster 4"):
                continue
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (8192 * 16))()
            so.read_trace(ctypes.addressof(buf))
            n = H * plan.cluster * B
            tr = np.array(buf[: n * 16], dtype=np.int64).reshape(n, 16)[:, :13]
            rel = (tr - tr[:, 0].min()) / 1e3
            log(f"K1 --k12-trace {label} stages, us from the first block's entry, median "
                f"[min, max] over the blocks: " + "; ".join(
                    f"{nm} {np.median(rel[:, k]):.2f} [{rel[:, k].min():.2f}, "
                    f"{rel[:, k].max():.2f}]" for k, nm in enumerate(K12_STAGES)))


def read_stages(so, n_blocks: int, names) -> str:
    """The marks of ``so``'s last launch, each stage in µs from the first
    block's entry: the median over the blocks [min, max]."""
    import ctypes

    import numpy as np

    buf = (ctypes.c_ulonglong * (8192 * 16))()
    so.read_trace(ctypes.addressof(buf))
    tr = np.array(buf[: n_blocks * 16], dtype=np.int64).reshape(n_blocks, 16)[:, :len(names)]
    rel = (tr - tr[:, 0].min()) / 1e3
    return "; ".join(f"{nm} {np.median(rel[:, k]):.2f} [{rel[:, k].min():.2f}, "
                     f"{rel[:, k].max():.2f}]" for k, nm in enumerate(names))


def k5_trace(smi: str) -> None:
    """``python3 chip_smoke.py --k5-trace``: where K5's time goes at the main
    path's shape (B=5, H=16, T=320, Dh=64, step 200, fp32, the beam-history
    table). Copies of the kernel with ``K5_MARKS`` (``k12_library``), as built
    and with each variant of ``K5_VARIANTS``, are held against the plain
    version and timed by CUDA-graph replay at cluster sizes 1, 2, 4 and 8,
    beside K1's copy with ``K12_MARKS`` at the same shape, and each copy's
    globaltimer marks give each stage's time from the first block's entry
    (the median over the blocks, and the range)."""
    import concurrent.futures
    import ctypes
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from seamless_communication_torch.ops.kernels import build
    from seamless_communication_torch.ops.kernels import decode_attention as da

    tmp = Path(tempfile.mkdtemp())
    (tmp / "hopper.cuh").write_text((build.CSRC_DIR / "hopper.cuh").read_text())
    jobs = [(0, [], False)] + [(i, edits, True) for i, edits in enumerate(K5_VARIANTS.values())]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        k1_lib, *k5_libs = pool.map(lambda job: k12_library(tmp, *job), jobs)
    B, H, T, Dh, step = B_MAIN, H_MAIN, T_MAIN, DH_MAIN, STEP_TIMED
    vecs, caches = decode_inputs(np.random.default_rng(0), "decode_attention_int8", B, T, Dh,
                                 torch.float32)
    table = indexed_tables(B, T, 5)["beam history"]
    src = torch.tensor(decode_origins(B)["repeated"], dtype=torch.int32, device="cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    ptrs = [x.data_ptr() for x in (*vecs, *caches)]
    stream = lambda: torch.cuda.current_stream().cuda_stream
    k5s = {}
    for name, lib in zip(K5_VARIANTS, k5_libs):
        so = k5s[name] = ctypes.CDLL(str(lib))
        so.decode_attention_indexed.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                                ctypes.c_float, i, i, i, i, p, p]
        so.read_trace.argtypes = [p]
    k1 = ctypes.CDLL(str(k1_lib))
    k1.decode_attention_int8.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                         ctypes.c_float, i, i, i, i, p, p, p, p, p, p]
    k1.read_trace.argtypes = [p]
    out = torch.empty_like(vecs[0])
    news = [torch.empty_like(x) for x in caches]
    ref = da._indexed_reference(*vecs, *caches, table, step)
    for cluster in (1, 2, 4, 8):
        plan = da.split_plan(B, H, T, Dh, 8, cluster, indexed=True)
        k1_plan = da.split_plan(B, H, T, Dh, 8, cluster)

        def call_k5(k5):
            err = k5.decode_attention_indexed(
                0, *ptrs, table.data_ptr(), B, H, T, Dh, step, math.sqrt(Dh), plan.cluster,
                plan.slice_rows, plan.tile_rows, plan.stages, out.data_ptr(), stream())
            if err:
                raise RuntimeError(f"--k5-trace cluster {cluster}: launch failed ({err})")

        def call_k1():
            err = k1.decode_attention_int8(
                0, *ptrs, src.data_ptr(), B, H, T, Dh, step, math.sqrt(Dh), k1_plan.cluster,
                k1_plan.slice_rows, k1_plan.tile_rows, k1_plan.stages, out.data_ptr(),
                *(x.data_ptr() for x in news), stream())
            if err:
                raise RuntimeError(f"--k5-trace K1 cluster {cluster}: launch failed ({err})")

        n = H * plan.cluster * B
        for name, k5 in k5s.items():
            out.zero_()
            call_k5(k5)
            torch.cuda.synchronize()
            same = bool(torch.allclose(out, ref, rtol=2e-5, atol=2e-5))
            for _ in range(5):
                call_k5(k5)
            torch.cuda.synchronize()
            log(f"K5 --k5-trace {name}, cluster {cluster}: "
                f"{cuda_time_ms(lambda: call_k5(k5)) * 1e3:.2f} us; equal to the plain "
                f"version: {same} [{smi}]")
            log(f"K5 --k5-trace {name}, cluster {cluster} stages, us from the first block's "
                f"entry, median [min, max] over the blocks: {read_stages(k5, n, K5_STAGES)}")
        for _ in range(5):
            call_k1()
        torch.cuda.synchronize()
        log(f"K1 --k5-trace cluster {cluster}: {cuda_time_ms(call_k1) * 1e3:.2f} us, stages: "
            f"{read_stages(k1, n, K12_STAGES)}")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def synthetic_spm(num_words: int = 1200) -> bytes:
    """A seeded synthetic SentencePiece model of up to ``num_words`` words
    (no real SentencePiece model ships with the repo), as a file's bytes."""
    import numpy as np

    from seamless_communication_torch.text.spm import (
        TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, build_spm_model,
    )

    rng = np.random.default_rng(0)
    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces = sorted({"\u2581" + "".join(rng.choice(list(letters), rng.integers(2, 9)))
                     for _ in range(num_words)} | {".", ",", "\u2581the", "\u2581a"})
    base = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
            ("</s>", 0.0, TYPE_CONTROL)]
    return build_spm_model(base + [(p, -2.0, TYPE_NORMAL) for p in pieces])


def synthetic_tokenizer(num_words: int = 1200):
    """An NLLB tokenizer over ``synthetic_spm(num_words)``."""
    from seamless_communication_torch.text.nllb import NllbTokenizer
    from seamless_communication_torch.text.spm import SentencePieceModel

    return NllbTokenizer(SentencePieceModel.from_bytes(synthetic_spm(num_words)),
                         langs=["__eng__", "__fra__"])


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


def synthetic_char_spm() -> bytes:
    """A char SentencePiece model over the letters, the word boundary and the
    characters of "<unk>" and of the punctuation pieces, as a file's bytes."""
    from seamless_communication_torch.text.spm import (
        TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, build_spm_model,
    )

    chars = ["\u2581"] + list("abcdefghijklmnopqrstuvwxyz.,<>")
    base = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
            ("</s>", 0.0, TYPE_CONTROL)]
    return build_spm_model(base + [(c, -1.0, TYPE_NORMAL) for c in chars])


def synthetic_char_tokenizer():
    """A char tokenizer over ``synthetic_char_spm()``."""
    from seamless_communication_torch.text.char_tokenizer import CharTokenizer
    from seamless_communication_torch.text.spm import SentencePieceModel

    return CharTokenizer(SentencePieceModel.from_bytes(synthetic_char_spm()))


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
    kw = dict(dtype=torch.bfloat16, device=dev)
    params = quantize_params(unity.unity_init(torch.Generator(device=dev).manual_seed(0),
                                              cfg, **kw))
    vocoder_cfg = CodeHifiGanConfig()
    vocoder = code_hifigan_init(torch.Generator(device=dev).manual_seed(1), vocoder_cfg,
                                **kw)
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
    """base_v2 (v2-large) S2TT through Translator.predict, a 4 s request and
    a batch of 10 s + 7 s, the decodes cut to hard_max_seq_len 128: K1
    launched 24 times per decode step, K2 never."""
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    # two requests of at most 127 decode steps keep the whole script near
    # 200 s of command time; the audio of a dropped 10 s request is still
    # drawn, so that every later request gets the audio it got when this
    # phase served three
    opts = SequenceGeneratorOptions(hard_max_seq_len=128)
    four, _ = noise(4.0), noise(10.0)
    requests = [("4 s", four), ("batch of 2: 10 s + 7 s", [noise(10.0), noise(7.0)])]
    prefix = tok.target_prefix("eng").tolist()
    stats = []
    torch.cuda.synchronize()
    reset_launch_counts()
    for name, wav in requests:
        before = launch_counts["decode_attention_int8"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        texts, _ = translator.predict(wav, "s2tt", "eng", text_generation_opts=opts)
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


def check_waveforms(label: str, speech, hop: int) -> None:
    """Every waveform finite, within [-1, 1], and a whole number of
    ``hop``-sample frames, at least one a unit and at most the vocoder's cap
    of 4 a unit (of the units bucketed to 32)."""
    import numpy as np

    from seamless_communication_torch.inference.generator import _bucket

    for u, w in zip(speech.units, speech.audio_wavs):
        frames = len(w) // hop
        if len(w) % hop or not len(u) <= frames <= 4 * _bucket(len(u), 32):
            raise AssertionError(f"{label}: {len(w)} samples for {len(u)} units are "
                                 f"not whole {hop}-sample frames within the cap")
        if not (np.isfinite(w).all() and np.abs(w).max(initial=0.0) <= 1.0):
            raise AssertionError(f"{label}: waveform not finite or outside [-1, 1]")


def phase_s2st(translator, tok, cfg, noise, smi: str) -> dict:
    """base_v2 (v2-large) S2ST through Translator.predict with
    ``kv_cache_bits=4``, a 4 s and a 10 s request, the decodes cut to
    hard_max_seq_len 128: K2 launched 24 times per decode step and K1 never;
    the waveforms pass ``check_waveforms``."""
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    opts = SequenceGeneratorOptions(kv_cache_bits=4, hard_max_seq_len=128)
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
        check_waveforms(f"S2ST {name}", speech, hop)
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


def synthetic_text(tok, n_tokens: int, seed: int) -> str:
    """A source text of seeded words of the synthetic vocabulary that encodes
    to ``n_tokens`` source tokens (with the language token and EOS)."""
    import numpy as np

    words = [p[1:] for p in tok.spm.pieces if p.startswith("\u2581") and p[1:].isalpha()]
    rng = np.random.default_rng(seed)
    return " ".join(rng.choice(words, n_tokens - 2))


def candidate_beam():
    """``SEAMLESS_CANDIDATE_BEAM=1`` within the block, as it was after."""
    import os
    from unittest import mock

    return mock.patch.dict(os.environ, {"SEAMLESS_CANDIDATE_BEAM": "1"})


def phase_t2t(translator, tok, cfg, smi: str) -> dict:
    """base_v2 (v2-large) T2TT and T2ST through Translator.predict with the
    candidate beam and int8 KV: a T2TT request of 20 source tokens, a T2TT
    batch of 60 + 30 tokens (N = 10 candidate rows), a T2ST request of 40
    tokens. K3b launched twice (its stream and its selection) and K1 24 times
    per decode step, K3a and K2
    never; hypotheses and (T2ST) waveforms checked as in 3a and 3b. Then a
    T2TT request cut to 63 decode steps gives identical tokens with the
    candidate beam and without it."""
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    requests = [("t2tt 20 tokens", "t2tt", synthetic_text(tok, 20, 10)),
                ("t2tt batch of 2: 60 + 30 tokens", "t2tt",
                 [synthetic_text(tok, 60, 11), synthetic_text(tok, 30, 12)]),
                ("t2st 40 tokens", "t2st", synthetic_text(tok, 40, 13))]
    prefix = tok.target_prefix("fra").tolist()
    layers = cfg.nllb.num_decoder_layers
    hop = translator.vocoder_cfg.hifigan.total_upsample
    stats = []
    with candidate_beam():
        # warm-up: the text encoder's shapes, outside the counted run
        translator.predict(requests[0][2], "t2tt", "fra", src_lang="eng",
                           text_generation_opts=SequenceGeneratorOptions(
                               soft_max_seq_len=(0, 8)))
        torch.cuda.synchronize()
        reset_launch_counts()
        for name, task, text in requests:
            before = dict(launch_counts)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            texts, speech = translator.predict(text, task, "fra", src_lang="eng")
            torch.cuda.synchronize()
            wall = time.time() - t0
            res = translator.generator.last_result
            steps, max_len = res.steps, res.tokens.shape[-1]
            got = {k: launch_counts[k] - before[k] for k in launch_counts}
            check_hypotheses(res, prefix, max_len, cfg.nllb.eos_idx)
            # K3b: the stream and the selection, two launches a step
            want = {**{k: 0 for k in launch_counts}, "vocab_topk_v2": 2 * steps,
                    "decode_attention_int8": layers * steps}
            if got != want:
                raise AssertionError(f"{name}: launches {got} in {steps} decode steps, "
                                     f"expected {want}")
            n_src = [len(tok.encode_source(t, "eng"))
                     for t in (text if isinstance(text, list) else [text])]
            units = audio_s = 0
            if speech is not None:
                check_waveforms(name, speech, hop)
                units = sum(len(u) for u in speech.units)
                audio_s = sum(len(w) for w in speech.audio_wavs) / speech.sample_rate
            peak = torch.cuda.max_memory_allocated() / 2**30
            split = {k: v * 1e3 for k, v in translator.last_timings.items()}
            log(f"{name.upper()} (source tokens {n_src}, candidate beam): wall "
                f"{wall * 1e3:.1f} ms = " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
                + f" ms; {steps} decode steps (max_len {max_len}), "
                f"{split['text_decode'] / steps:.2f} ms per step of the text decode, "
                f"K3b launches {got['vocab_topk_v2']}, K1 launches "
                f"{got['decode_attention_int8']}, {units} units, {audio_s:.2f} s of "
                f"audio, peak {peak:.2f} GiB, texts {[t[:40] for t in texts]} [{smi}]")
            stats.append({"request": name, "source_tokens": n_src, "wall_ms": wall * 1e3,
                          "stages_ms": split, "steps": steps, "units": units,
                          "audio_s": audio_s, "peak_gib": peak, "launches": got})
        counts = dict(launch_counts)
        cut = SequenceGeneratorOptions(soft_max_seq_len=(0, 64))
        translator.predict(requests[0][2], "t2tt", "fra", src_lang="eng",
                           text_generation_opts=cut)
        with_cand = translator.generator.last_result
    translator.predict(requests[0][2], "t2tt", "fra", src_lang="eng",
                       text_generation_opts=cut)
    full = translator.generator.last_result
    if not (torch.equal(with_cand.tokens, full.tokens)
            and torch.equal(with_cand.lengths, full.lengths)):
        raise AssertionError("cut T2TT: the candidate beam and the full-vocabulary "
                             "beam gave different tokens")
    log(f"cut T2TT ({full.steps} decode steps): tokens identical with the candidate "
        f"beam (K3b) and the full-vocabulary beam; best scores "
        f"{with_cand.scores[:, 0].tolist()} and {full.scores[:, 0].tolist()}")
    return {"launches": counts, "requests": stats}


def lazy_reorder(on: bool = True):
    """``SEAMLESS_LAZY_REORDER=1`` within the block (or unset), as it was
    after."""
    import os
    from unittest import mock

    env = dict(os.environ)
    env.pop("SEAMLESS_LAZY_REORDER", None)
    if on:
        env["SEAMLESS_LAZY_REORDER"] = "1"
    return mock.patch.dict(os.environ, env, clear=True)


def mintox_tokenizer(num_words: int, seed: int = 7):
    """An NLLB tokenizer (eng, fra, deu) over ``num_words`` seeded lowercase
    words, each as six pieces: the word, its upper-case and its capitalized
    form (the variants of an ETOX word list) after a word boundary, and the
    same three after a "★" (MinTox's mid-word form: "★word" encodes to the
    boundary and that piece, and MinTox drops the first). So every piece
    decodes to a word ETOX can see, and every banned row MinTox builds from
    a word is one token long: the JAX package's banned-sequence processor,
    which the port copies, enforces only the rows of the longest length.
    Returns (tokenizer, words)."""
    import numpy as np

    from seamless_communication_torch.text.nllb import NllbTokenizer
    from seamless_communication_torch.text.spm import (
        TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
    )

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = set()
    while len(words) < num_words:
        for k, row in zip(rng.integers(3, 9, num_words), rng.integers(0, 26, (num_words, 8))):
            words.add("".join(letters[row[:k]]))
    words = sorted(words)[:num_words]
    base = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
            ("</s>", 0.0, TYPE_CONTROL), ("\u2581", -2.0, TYPE_NORMAL)]
    pieces = base + [(b + c, -2.0, TYPE_NORMAL) for w in words
                     for c in (w, w.upper(), w.capitalize()) for b in ("\u2581", "\u2605")]
    return NllbTokenizer(SentencePieceModel.from_bytes(build_spm_model(pieces)),
                         langs=["__eng__", "__fra__", "__deu__"]), words


def text_words(text: str) -> list:
    """The words ETOX matches on: lower case, non-word characters as spaces."""
    import re

    return re.sub(r"[\W+]", " ", text.lower()).split()


def holds_sequence(tokens: list, row: list) -> bool:
    n = len(row)
    return any(tokens[i:i + n] == row for i in range(len(tokens) - n + 1))


def phase_lazy(translator, tok, cfg, noise, smi: str) -> dict:
    """base_v2 (v2-large), int8 KV, beam 5, the candidate beam off, the
    decodes cut to hard_max_seq_len 128 (127 steps):
      a. a T2TT request of 20 source tokens with SEAMLESS_LAZY_REORDER=1 and
         without it: identical tokens, scores within 1e-5; K5 launched 24
         times a decode step and K1 never in the lazy run, the other way
         round in the classic one;
      b. the same request with no_repeat_ngram_size=2, the lazy reorder and
         SEAMLESS_CANDIDATE_BEAM=1: no bigram twice in the best hypothesis,
         K3b never launched (the processor keeps the candidate beam off);
      c. an S2ST request of 4 s noise through a Translator with
         apply_mintox=True and src_lang "eng", the lazy reorder on: the ETOX
         word list names a word that the first pass emits and the ASR of the
         input lacks, so MinTox runs the ASR and re-runs with the word's
         rows banned; the re-run's best hypothesis holds none of them; units
         and audio are produced.
    Launches are counted from 0 at the start; K5's total is its count."""
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )
    from seamless_communication_torch.toxicity.etox import ETOXBadWordChecker
    from seamless_communication_torch.toxicity.mintox import banned_sequences_from_words

    layers = cfg.nllb.num_decoder_layers
    opts = SequenceGeneratorOptions(hard_max_seq_len=128)
    text = synthetic_text(tok, 20, 10)
    prefix = tok.target_prefix("fra").tolist()
    stats = {}

    def run(label, lazy, **kw):
        before = dict(launch_counts)
        torch.cuda.synchronize()
        t0 = time.time()
        with lazy_reorder(lazy):
            texts, _ = translator.predict(text, "t2tt", "fra", src_lang="eng",
                                          text_generation_opts=kw.pop("opts", opts), **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        res = translator.generator.last_result
        got = {k: launch_counts[k] - before[k] for k in launch_counts}
        check_hypotheses(res, prefix, res.tokens.shape[-1], cfg.nllb.eos_idx)
        want_k5, want_k1 = (layers * res.steps, 0) if lazy else (0, layers * res.steps)
        if (got["decode_attention_indexed"], got["decode_attention_int8"]) != (want_k5,
                                                                              want_k1):
            raise AssertionError(f"{label}: K5 {got['decode_attention_indexed']} and K1 "
                                 f"{got['decode_attention_int8']} launches in {res.steps} "
                                 f"steps, expected {want_k5} and {want_k1}")
        td = translator.last_timings["text_decode"] * 1e3
        log(f"3d {label}: wall {wall * 1e3:.1f} ms, text decode {td:.1f} ms, {res.steps} "
            f"steps, {td / res.steps:.2f} ms per step, K5 launches "
            f"{got['decode_attention_indexed']}, K1 launches {got['decode_attention_int8']}, "
            f"texts {[t[:40] for t in texts]} [{smi}]")
        stats[label] = {"wall_ms": wall * 1e3, "text_decode_ms": td, "steps": res.steps,
                        "launches": got}
        return res, got

    torch.cuda.synchronize()
    reset_launch_counts()
    lazy, _ = run("a lazy", True)
    classic, _ = run("a classic", False)
    ds = (lazy.scores - classic.scores).abs()
    if not (torch.equal(lazy.tokens, classic.tokens) and torch.equal(lazy.lengths, classic.lengths)
            and bool((ds <= 1e-5 * (1 + classic.scores.abs())).all())):
        raise AssertionError("3d a: the lazy and the classic reorder gave different "
                             f"tokens or scores (max score difference {float(ds.max()):.3g})")
    log(f"3d a: tokens identical with the lazy and the classic reorder, scores within "
        f"{float(ds.max()):.3g}")

    with candidate_beam():
        res, got = run("b ngram 2", True, opts=SequenceGeneratorOptions(
            hard_max_seq_len=128, no_repeat_ngram_size=2))
    gen = res.tokens[0, 0, 2:int(res.lengths[0, 0]) - 1].tolist()
    bigrams = list(zip(gen, gen[1:]))
    if len(set(bigrams)) != len(bigrams) or got["vocab_topk_v2"]:
        raise AssertionError(f"3d b: a bigram repeats or K3b ran ({got['vocab_topk_v2']})")
    log(f"3d b: {len(bigrams)} bigrams in the best hypothesis, none twice; K3b launches 0")

    # c. MinTox on an S2ST request
    t0 = time.time()
    mtok, words = mintox_tokenizer(42600)      # 255,600 pieces of the 256,102 ids
    word_set = set(words)
    log(f"3d c: MinTox tokenizer of {mtok.vocab_info.size} ids built in "
        f"{time.time() - t0:.1f} s")

    def mintox_translator(**kw):
        return s2st_translator(translator.params, cfg, mtok, translator.vocoder_params,
                               translator.vocoder_cfg, text_opts=opts,
                               device=translator.device, **kw)

    wav = noise(4.0)
    plain = mintox_translator()
    with lazy_reorder(True):
        source = plain.predict(wav, "asr", "eng", src_lang="eng")[0][0]
        for tgt in ("fra", "deu"):
            first = plain.predict(wav, "s2st", tgt, src_lang="eng")[0][0]
            added = [w for w in text_words(first)
                     if w in word_set and w not in text_words(source)]
            if added:
                break
    if not added:
        raise AssertionError(f"3d c: no word of the first passes ({first[:60]!r}) is "
                             f"missing from the ASR source ({source[:60]!r})")
    checker = ETOXBadWordChecker.from_word_lists({"eng": [added[0]], tgt: [added[0]]})
    bad = checker.extract_bad_words(source, first, "eng", tgt)
    rows, lens = banned_sequences_from_words(mtok, sorted(set(bad)))
    banned = [r[-n:].tolist() for r, n in zip(rows, lens)]
    mt = mintox_translator(apply_mintox=True, etox_checker=checker)
    steps = []
    orig = mt.generator.generate_text

    def counted(*a, **k):
        out = orig(*a, **k)
        steps.append(mt.generator.last_result.steps)
        return out

    mt.generator.generate_text = counted
    hop = translator.vocoder_cfg.hifigan.total_upsample
    before = dict(launch_counts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with lazy_reorder(True):
        texts, speech = mt.predict(wav, "s2st", tgt, src_lang="eng")
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = {k: launch_counts[k] - before[k] for k in launch_counts}
    res = mt.generator.last_result                       # the re-run's search
    best = res.tokens[0, 0, :int(res.lengths[0, 0])].tolist()
    if "rerun" not in mt.last_mintox_timings or texts[0] == first:
        raise AssertionError(f"3d c: MinTox did not re-run or its re-run gave the first "
                             f"text again ({mt.last_mintox_timings}, {first[:60]!r}, "
                             f"{texts[0][:60]!r}, banned {banned})")
    if any(holds_sequence(best, row) for row in banned):
        raise AssertionError(f"3d c: the re-run's best hypothesis holds a banned row of "
                             f"{banned}")
    if (got["decode_attention_indexed"], got["decode_attention_int8"]) != (
            layers * sum(steps), 0):
        raise AssertionError(f"3d c: K5 {got['decode_attention_indexed']} and K1 "
                             f"{got['decode_attention_int8']} launches over decodes of "
                             f"{steps} steps")
    check_waveforms("3d c", speech, hop)
    units = sum(len(u) for u in speech.units)
    audio_s = sum(len(w) for w in speech.audio_wavs) / speech.sample_rate
    if not units or not audio_s:
        raise AssertionError("3d c: no units or no audio")
    peak = torch.cuda.max_memory_allocated() / 2**30
    passes = {**{f"first {k}": v * 1e3 for k, v in mt.last_timings.items()},
              **{k: v * 1e3 for k, v in mt.last_mintox_timings.items()}}
    log(f"3d c: S2ST 4 s -> {tgt} with MinTox: flagged {added[0]!r} (first pass "
        f"{first[:40]!r}, ASR source {source[:40]!r}); banned rows {banned}; wall "
        f"{wall * 1e3:.1f} ms = " + ", ".join(f"{k} {v:.1f}" for k, v in passes.items())
        + f" ms; decodes of {steps} steps (first pass, ASR, re-run), K5 launches "
        f"{got['decode_attention_indexed']}, K1 launches {got['decode_attention_int8']}; "
        f"re-run text {texts[0][:40]!r}, none of the banned rows in its best hypothesis; "
        f"{units} units, {audio_s:.2f} s of audio, peak {peak:.2f} GiB [{smi}]")
    stats["c mintox"] = {"wall_ms": wall * 1e3, "passes_ms": passes, "steps": steps,
                         "launches": got, "units": units, "audio_s": audio_s,
                         "peak_gib": peak}
    return {"launches": dict(launch_counts), "requests": stats}


def fused_attention(on: bool = True):
    """``SEAMLESS_FUSED_ATTN=1`` within the block (or unset), as it was
    after."""
    import os
    from unittest import mock

    env = dict(os.environ)
    env.pop("SEAMLESS_FUSED_ATTN", None)
    if on:
        env["SEAMLESS_FUSED_ATTN"] = "1"
    return mock.patch.dict(os.environ, env, clear=True)


def k6_expected(cfg, *, src_len: int, speech: bool, text_len=None,
                max_unit_len=None) -> dict:
    """K6 launches of one request with the fused option on, counted from its
    shapes: a full-sequence attention is eligible when its query and key
    lengths are both at least 128. ``src_len``: the conformer's frames
    (speech input) or the padded source tokens (text input); ``text_len``:
    the re-decode's padded length (speech output); ``max_unit_len``: the NAR
    T2U's unit positions. Returns the launches of each part."""
    ok = lambda *lens: all(n >= 128 for n in lens)
    parts = {}
    if speech:
        sc = cfg.speech
        parts["speech encoder"] = sc.conformer.num_layers * ok(src_len)
        enc_len = src_len
        k, s = sc.adaptor_kernel_size, sc.adaptor_stride
        for _ in range(sc.adaptor_layers):    # its strided conv's output length
            enc_len = (enc_len + 2 * (s // 2) - k) // s + 1
            parts["adaptor"] = parts.get("adaptor", 0) + ok(enc_len)
    else:
        parts["text encoder"] = cfg.nllb.num_encoder_layers * ok(src_len)
        enc_len = src_len
    if text_len is not None:
        L = cfg.nllb.num_decoder_layers
        parts["re-decode"] = L * ok(text_len) + L * ok(text_len, enc_len)
        t2u = cfg.nar_t2u or cfg.ar_t2u
        parts["t2u encoder"] = t2u.num_encoder_layers * ok(text_len)
        if cfg.nar_t2u is not None:
            parts["t2u decoder"] = cfg.nar_t2u.num_decoder_layers * ok(max_unit_len)
    return parts


def phase_fused(translator, tok, cfg, noise, smi: str) -> dict:
    """3e. base_v2 (v2-large) with SEAMLESS_FUSED_ATTN=1, int8 KV, the
    decodes cut to hard_max_seq_len 128: first the speech encoder on a 10 s
    input with the option on and off (outputs within atol 2e-3 + rtol 2e-3:
    24 layers of fp32 attention summed in another order, then a layer
    norm); then an S2ST request of 10 s and a T2ST request of a 140-token
    source. K6 launched as ``k6_expected`` counts from each request's
    shapes, K1 24 times a text decode step. Launches are counted from 0
    just before the two requests."""
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions, _bucket,
    )
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    opts = SequenceGeneratorOptions(hard_max_seq_len=128)
    layers = cfg.nllb.num_decoder_layers
    hop = translator.vocoder_cfg.hifigan.total_upsample
    wav = noise(10.0)
    fbank, flens = translator._audio_to_fbank(wav, 16000)
    fb, fl = (torch.as_tensor(a, device="cuda") for a in (fbank, flens))
    outs = {}
    with torch.inference_mode():
        for on in (True, False):
            with fused_attention(on):
                outs[on] = unity.encode_speech(translator.params, cfg, fb, fl).seqs.float()
    err = (outs[True] - outs[False]).abs()
    if not bool((err <= 2e-3 + 2e-3 * outs[False].abs()).all()):
        raise AssertionError(f"3e: speech encoder output with and without the fused "
                             f"option differs by up to {float(err.max()):.3g}")
    log(f"3e: base_v2 speech encoder on 10 s ({fbank.shape[1] // 2} conformer frames) with "
        f"the fused option (K6) and without: max abs difference {float(err.max()):.3g} "
        f"(atol 2e-3 + rtol 2e-3)")
    requests = [("s2st 10 s", wav, "s2st", "eng", {}),
                ("t2st 140-token source", synthetic_text(tok, 140, 14), "t2st", "fra",
                 {"src_lang": "eng"})]
    stats = []
    torch.cuda.synchronize()
    reset_launch_counts()
    with fused_attention(True):
        for name, inp, task, lang, kw in requests:
            before = dict(launch_counts)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            texts, speech = translator.predict(inp, task, lang, text_generation_opts=opts,
                                               **kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
            res = translator.generator.last_result
            got = {k: launch_counts[k] - before[k] for k in launch_counts}
            check_hypotheses(res, tok.target_prefix(lang).tolist(), res.tokens.shape[-1],
                             cfg.nllb.eos_idx)
            check_waveforms(f"3e {name}", speech, hop)
            if task == "s2st":
                src_len = fbank.shape[1] // 2
            else:
                src_len = _bucket(len(tok.encode_source(inp, "eng")), 16)
            text_len = _bucket(int(res.lengths[:, 0].max()), 16)
            parts = k6_expected(cfg, src_len=src_len, speech=task == "s2st",
                                text_len=text_len, max_unit_len=2048)
            want_k6 = sum(parts.values())
            if (got["flash_attention"], got["decode_attention_int8"]) != (
                    want_k6, layers * res.steps):
                raise AssertionError(f"3e {name}: K6 {got['flash_attention']} launches "
                                     f"(expected {parts}), K1 {got['decode_attention_int8']} "
                                     f"in {res.steps} steps")
            units = sum(len(u) for u in speech.units)
            audio_s = sum(len(w) for w in speech.audio_wavs) / speech.sample_rate
            peak = torch.cuda.max_memory_allocated() / 2**30
            split = {k: v * 1e3 for k, v in translator.last_timings.items()}
            log(f"3e {name.upper()} with the fused option: wall {wall * 1e3:.1f} ms = "
                + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
                + f" ms; source {src_len}, re-decode length {text_len}; K6 launches "
                f"{got['flash_attention']} = {parts}; {res.steps} decode steps, K1 "
                f"launches {got['decode_attention_int8']}; {units} units, {audio_s:.2f} s "
                f"of audio, peak {peak:.2f} GiB, texts {[t[:40] for t in texts]} [{smi}]")
            stats.append({"request": f"fused {name}", "wall_ms": wall * 1e3,
                          "stages_ms": split, "steps": res.steps, "units": units,
                          "audio_s": audio_s, "peak_gib": peak, "k6_parts": parts,
                          "launches": got})
    return {"launches": dict(launch_counts), "requests": stats}


def build_base_v1(vocoder, vocoder_cfg):
    """The port's ``base`` (v1-large) UnitY on the card: the XL conformer
    speech encoder (24 layers, 1024-d), the NLLB dense_1b decoder and text
    encoder and the AR T2U (6 + 6 layers, 1024-d, unit vocabulary 10082),
    random bf16 weights from a seeded generator (seed 2), the tree int8
    weight-only, with the given unit HiFi-GAN. Returns (translator, cfg)."""
    import torch

    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
    from seamless_communication_torch.ops.quantization import quantize_params

    dev = torch.device("cuda")
    cfg = get_arch("base")
    t0 = time.time()
    params = quantize_params(unity.unity_init(torch.Generator(device=dev).manual_seed(2),
                                              cfg, dtype=torch.bfloat16, device=dev))
    torch.cuda.synchronize()
    log(f"base (v1-large) params (bf16, int8 weight-only) built in {time.time() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    unit_tok = UnitTokenizer(vocoder_cfg.num_units, ["eng", "fra"], "base")
    assert unit_tok.vocab_size <= cfg.ar_t2u.unit_vocab_size
    return Translator(params, cfg, synthetic_tokenizer(), unit_tok, vocoder_params=vocoder,
                      vocoder_cfg=vocoder_cfg, lang_spkr_idx_map=LANG_SPKR), cfg


def phase_v1(translator, cfg, noise, smi: str) -> dict:
    """3f. base (v1-large) with SEAMLESS_FUSED_ATTN=1 and int8 KV: an S2TT and
    an S2ST request of 10 s, the text decode cut to hard_max_seq_len 128 and
    the unit decode, with the bigram block, to max_unit_len 128 (127 steps
    each at most): units and audio produced; K1 24
    times a text step and 6 times a unit step, K6 as ``k6_expected`` counts
    (24 in the XL encoder; the re-decode and the AR T2U's encoder where
    their length reaches 128); the waveforms pass ``check_waveforms``.
    Launches are counted from 0 just before the requests."""
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions, _bucket,
    )
    from seamless_communication_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    opts = SequenceGeneratorOptions(hard_max_seq_len=128)
    # random weights make the AR T2U repeat its last token, the language
    # symbol, which is no unit; the bigram block moves it on to units
    unit_opts = SequenceGeneratorOptions(no_repeat_ngram_size=2)
    wav = noise(10.0)
    hop = translator.vocoder_cfg.hifigan.total_upsample
    src_len = translator._audio_to_fbank(wav, 16000)[0].shape[1] // 2
    with fused_attention(True):       # warm-up outside the counted run
        translator.predict(noise(1.0), "s2st", "eng", max_unit_len=8,
                           text_generation_opts=SequenceGeneratorOptions(
                               soft_max_seq_len=(0, 8)))
    stats = []
    torch.cuda.synchronize()
    reset_launch_counts()
    with fused_attention(True):
        for task in ("s2tt", "s2st"):
            before = dict(launch_counts)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            texts, speech = translator.predict(wav, task, "eng", text_generation_opts=opts,
                                               unit_generation_opts=unit_opts,
                                               max_unit_len=128)
            torch.cuda.synchronize()
            wall = time.time() - t0
            got = {k: launch_counts[k] - before[k] for k in launch_counts}
            res = translator.generator.last_result
            check_hypotheses(res, translator.text_tokenizer.target_prefix("eng").tolist(),
                             res.tokens.shape[-1], cfg.nllb.eos_idx)
            text_len = _bucket(int(res.lengths[:, 0].max()), 16) if speech else None
            parts = k6_expected(cfg, src_len=src_len, speech=True, text_len=text_len)
            unit_steps = translator.generator.last_unit_result.steps if speech else 0
            want = (sum(parts.values()), cfg.nllb.num_decoder_layers * res.steps
                    + cfg.ar_t2u.num_decoder_layers * unit_steps)
            if (got["flash_attention"], got["decode_attention_int8"]) != want:
                raise AssertionError(f"3f {task}: K6 {got['flash_attention']} and K1 "
                                     f"{got['decode_attention_int8']} launches, expected "
                                     f"{want} ({parts}, {res.steps} text steps, "
                                     f"{unit_steps} unit steps)")
            units = audio_s = 0
            if speech is not None:
                check_waveforms(f"3f {task}", speech, hop)
                units = sum(len(u) for u in speech.units)
                audio_s = sum(len(w) for w in speech.audio_wavs) / speech.sample_rate
                if not units or not audio_s:
                    raise AssertionError(f"3f {task}: no units or no audio")
            peak = torch.cuda.max_memory_allocated() / 2**30
            split = {k: v * 1e3 for k, v in translator.last_timings.items()}
            log(f"3f v1-large {task.upper()} 10 s with the fused option: wall "
                f"{wall * 1e3:.1f} ms = " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
                + f" ms; {res.steps} text steps, {unit_steps} unit steps; K1 launches "
                f"{got['decode_attention_int8']}, K6 launches {got['flash_attention']} = "
                f"{parts}; {units} units, {audio_s:.2f} s of audio, peak {peak:.2f} GiB, "
                f"texts {[t[:40] for t in texts]} [{smi}]")
            stats.append({"request": f"v1 {task} 10 s", "wall_ms": wall * 1e3,
                          "stages_ms": split, "text_steps": res.steps,
                          "unit_steps": unit_steps, "units": units, "audio_s": audio_s,
                          "peak_gib": peak, "launches": got})
    return {"launches": dict(launch_counts), "requests": stats}


# ---------------------------------------------------------------------------
# phase 3h: the offline entry point from a .pt checkpoint
# ---------------------------------------------------------------------------

OFFLINE_CARD, OFFLINE_VOCODER = "smoke_m4t_v2", "smoke_vocoder_v2"


@contextlib.contextmanager
def offline_dir():
    """A temporary directory on ``SEAMLESS_CARDS_DIR`` for the checkpoints,
    tokenizers and cards of a run through the loaders; removed at the end."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    d = Path(tempfile.mkdtemp(prefix="chip_smoke_offline_"))
    old = os.environ.get("SEAMLESS_CARDS_DIR")
    os.environ["SEAMLESS_CARDS_DIR"] = str(d)
    try:
        yield d
    finally:
        if old is None:
            os.environ.pop("SEAMLESS_CARDS_DIR", None)
        else:
            os.environ["SEAMLESS_CARDS_DIR"] = old
        shutil.rmtree(d, ignore_errors=True)


def write_cards(d, card_extra: str = "", num_words: int = 1200) -> None:
    """The synthetic NLLB and char SentencePiece files and two cards in
    ``d``: ``OFFLINE_CARD``, the packaged ``seamlessM4T_v2_large`` card with
    ``d/unity.pt`` and these tokenizers (and ``card_extra``'s fields), and
    ``OFFLINE_VOCODER``, ``vocoder_v2`` with ``d/vocoder.pt``."""
    (d / "nllb.model").write_bytes(synthetic_spm(num_words))
    (d / "char.model").write_bytes(synthetic_char_spm())
    (d / f"{OFFLINE_CARD}.yaml").write_text(
        f"name: {OFFLINE_CARD}\nbase: seamlessM4T_v2_large\n"
        f"checkpoint: {d / 'unity.pt'}\ntokenizer: {d / 'nllb.model'}\n"
        f"char_tokenizer: {d / 'char.model'}\n{card_extra}")
    (d / f"{OFFLINE_VOCODER}.yaml").write_text(
        f"name: {OFFLINE_VOCODER}\nbase: vocoder_v2\ncheckpoint: {d / 'vocoder.pt'}\n")


def hold_leaves(label: str, want, got, same) -> int:
    """Every leaf pair of ``want`` and ``got`` passes ``same(want_leaf,
    got_leaf)`` (same paths too); returns the number of leaves."""
    if isinstance(want, dict):
        if set(want) != set(got):
            raise AssertionError(f"{label}: keys {sorted(set(want) ^ set(got))[:4]} differ")
        return sum(hold_leaves(f"{label}/{k}", want[k], got[k], same) for k in want)
    if isinstance(want, (list, tuple)):
        if len(want) != len(got):
            raise AssertionError(f"{label}: {len(got)} items, not {len(want)}")
        return sum(hold_leaves(f"{label}/{i}", a, b, same)
                   for i, (a, b) in enumerate(zip(want, got)))
    if not same(want, got):
        raise AssertionError(f"{label}: the loaded leaf differs from the file's value")
    return 1


def phase_offline(smi: str, shared=None) -> dict:
    """3h. The offline entry point at full width. ``base_v2`` UnitY and
    ``CodeHifiGanConfig()`` on seeded bf16 weights are exported by the port's
    exporter as fp16 ``.pt`` files with their cards (``write_cards``, the
    packaged v2-large and vocoder_v2 cards as bases); the loaders read
    them back (``load_unity_model_and_tokenizers(..., quantize=True)``,
    ``load_vocoder``), each leaf held before quantizing to the file's fp16
    value exactly (rounded to the loaded dtype; the vocoder's folded weight
    norms rounded back to fp16); then ``cli.predict.main`` serves a 10 s S2ST
    request on the card, the text decode cut to 127 steps: K1 launched 24
    times a decode step (counted from 0), the WAV 16 kHz, finite, within
    [-1, 1], the text and units those of a Translator built in-process on
    the loaded tree; then an S2TT request with ``--quantize_bits 4`` whose
    hypotheses pass ``check_hypotheses``, and one of its int4 linears held
    to the plain product of its dequantized weight on the card. ``shared``:
    a directory on ``SEAMLESS_CARDS_DIR`` to write into and leave for 3m
    (default: one of its own, removed at the end)."""
    import os

    import numpy as np
    import torch

    from seamless_communication_torch.audio.wav import read_wav, write_wav
    from seamless_communication_torch.checkpoint.fairseq_export import (
        export_unity, export_vocoder,
    )
    from seamless_communication_torch.cli import loading, predict
    from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.vocoder.codehifigan import (
        CodeHifiGanConfig, code_hifigan_init,
    )
    from seamless_communication_torch.ops.kernels import launch_counts, reset_launch_counts
    from seamless_communication_torch.ops.modules import linear
    from seamless_communication_torch.ops.quantization import unpack_int4

    dev = torch.device("cuda")
    cfg = get_arch("base_v2")
    kw = dict(dtype=torch.bfloat16, device=dev)
    params = unity.unity_init(torch.Generator(device=dev).manual_seed(5), cfg, **kw)
    vocoder = code_hifigan_init(torch.Generator(device=dev).manual_seed(6),
                                CodeHifiGanConfig(), **kw)
    n_unity = sum(t.numel() for t in {id(t): t for t in tensor_leaves(params)}.values())
    n_voc = sum(t.numel() for t in tensor_leaves(vocoder))
    max_len = ["--text_generation_max_len_a", "0", "--text_generation_max_len_b", "126"]
    with contextlib.nullcontext(shared) if shared is not None else offline_dir() as d:
        t0 = time.perf_counter()
        torch.save({"model": export_unity(params, dtype=torch.float16)}, d / "unity.pt")
        torch.save({"generator": export_vocoder(vocoder, dtype=torch.float16)},
                   d / "vocoder.pt")
        export_s = time.perf_counter() - t0
        gc.collect()
        write_cards(d)
        sizes = {f: os.path.getsize(d / f) for f in ("unity.pt", "vocoder.pt")}
        log(f"3h exported base_v2 ({n_unity / 1e9:.3f} B parameters) and the unit "
            f"HiFi-GAN ({n_voc / 1e6:.1f} M) as fp16 .pt files in {export_s:.1f} s: "
            f"unity.pt {sizes['unity.pt'] / 2**30:.3f} GiB, vocoder.pt "
            f"{sizes['vocoder.pt'] / 2**20:.1f} MiB [{smi}]")
        stats: dict = {"unity_params": n_unity, "vocoder_params": n_voc,
                       "export_s": export_s, "file_bytes": sizes}

        # the loaders, each leaf held before quantizing
        held = {}
        quantize = loading.quantize_params

        def hold_then_quantize(tree, **qkw):
            held["unity"] = hold_leaves("unity", params, tree, lambda w, g: torch.equal(
                w.to(torch.float16).to(g.dtype), g))
            return quantize(tree, **qkw)

        loading.quantize_params = hold_then_quantize
        unity_timings: dict = {}
        try:
            t0 = time.perf_counter()
            tree, _, text_tok, unit_tok, char_tok = loading.load_unity_model_and_tokenizers(
                OFFLINE_CARD, quantize=True, timings=unity_timings)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        finally:
            loading.quantize_params = quantize
        t0 = time.perf_counter()
        voc_tree, voc_cfg, idx_map = loading.load_vocoder(OFFLINE_VOCODER)
        torch.cuda.synchronize()
        voc_s = time.perf_counter() - t0
        held["vocoder"] = hold_leaves("vocoder", vocoder, voc_tree, lambda w, g: torch.equal(
            w.to(torch.float16), g.to(torch.float16)))
        log(f"3h loaded unity.pt in {load_s:.2f} s = " + ", ".join(
            f"{k} {v:.2f}" for k, v in unity_timings.items())
            + f" s; vocoder.pt in {voc_s:.2f} s; {held['unity']} UnitY leaves and "
            f"{held['vocoder']} vocoder leaves equal the files' fp16 values; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card [{smi}]")
        stats.update(load_s=load_s, load_stages_s=unity_timings,
                     vocoder_load_s=voc_s, held_leaves=held)
        del params, vocoder
        gc.collect()

        # m4t_predict S2ST on the card
        wav = (np.random.default_rng(11).standard_normal(10 * 16000) * 0.1).astype(np.float32)
        write_wav(str(d / "in.wav"), wav, 16000)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = predict.main([str(d / "in.wav"), "s2st", "eng", "--model_name", OFFLINE_CARD,
                            "--vocoder_name", OFFLINE_VOCODER, "--local_pt_path",
                            str(d / "unity.pt"), "--output_path", str(d / "out.wav"),
                            "--quantize", *max_len])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = launch_counts["decode_attention_int8"]
        gen = res.translator.generator.last_result
        layers = cfg.nllb.num_decoder_layers
        if k1 != layers * gen.steps or launch_counts["decode_attention_int4"]:
            raise AssertionError(f"3h S2ST: K1 launched {k1} times in {gen.steps} decode "
                                 f"steps, not {layers} a step (K2 "
                                 f"{launch_counts['decode_attention_int4']})")
        check_hypotheses(gen, text_tok.target_prefix("eng").tolist(), gen.tokens.shape[-1],
                         cfg.nllb.eos_idx)
        out, rate = read_wav(str(d / "out.wav"))
        if rate != 16000 or not len(out) or not np.isfinite(out).all() \
                or np.abs(out).max() > 1.0:
            raise AssertionError(f"3h S2ST: the WAV ({rate} Hz, {len(out)} samples) is "
                                 "empty, not finite or outside [-1, 1]")
        check_waveforms("3h S2ST", res.speech, voc_cfg.hifigan.total_upsample)
        request = dict(res.translator.last_timings)
        load_stages = res.load_timings
        res_speech, res_texts = res.speech, res.texts
        del res
        gc.collect()
        opts = SequenceGeneratorOptions(soft_max_seq_len=(0, 126))
        ref = Translator(tree, cfg, text_tok, unit_tok, char_tok, vocoder_params=voc_tree,
                         vocoder_cfg=voc_cfg, lang_spkr_idx_map=idx_map, text_opts=opts,
                         unit_opts=SequenceGeneratorOptions(soft_max_seq_len=(25, 50)))
        ref_texts, ref_speech = ref.predict(str(d / "in.wav"), "s2st", "eng")
        ref_gen = ref.generator.last_result
        wav_err = float(np.abs(ref_speech.audio_wavs[0] - res_speech.audio_wavs[0]).max())
        same_tokens = torch.equal(ref_gen.tokens[:, 0].cpu(), gen.tokens[:, 0].cpu())
        if (ref_texts != res_texts or not same_tokens or ref_speech.units != res_speech.units
                or wav_err > 1e-4):
            raise AssertionError(f"3h: m4t_predict's text, tokens or units differ from "
                                 f"the in-process Translator's ({res_texts[0][:60]!r} vs "
                                 f"{ref_texts[0][:60]!r}; waveforms {wav_err:.3g})")
        del ref
        gc.collect()
        log(f"3h m4t_predict S2ST 10 s: wall {wall:.2f} s (loading included: "
            + ", ".join(f"{k} {v:.2f}" for k, v in load_stages.items()) + " s); request "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in request.items())
            + f" ms, {request['text_decode'] * 1e3 / gen.steps:.2f} ms a decode step; "
            f"{gen.steps} decode steps, K1 launches {k1}; "
            f"{len(res_speech.units[0])} units, {len(out) / rate:.2f} s of audio; "
            f"text {res_texts[0][:40]!r}, tokens and units identical to the in-process "
            f"Translator's, waveform max abs difference {wav_err:.3g} [{smi}]")
        stats.update(predict_wall_s=wall, predict_load_stages_s=load_stages,
                     request_stages_ms={k: v * 1e3 for k, v in request.items()},
                     steps=gen.steps, k1_launches=k1, units=len(res_speech.units[0]))
        launches = k1
        del tree, voc_tree
        gc.collect()

        # m4t_predict S2TT with int4 weights
        t0 = time.perf_counter()
        before = launch_counts["decode_attention_int8"]
        res = predict.main([str(d / "in.wav"), "s2tt", "eng", "--model_name", OFFLINE_CARD,
                            "--local_pt_path", str(d / "unity.pt"), "--quantize",
                            "--quantize_bits", "4", *max_len])
        torch.cuda.synchronize()
        wall4 = time.perf_counter() - t0
        gen = res.translator.generator.last_result
        check_hypotheses(gen, text_tok.target_prefix("eng").tolist(), gen.tokens.shape[-1],
                         cfg.nllb.eos_idx)
        k1_4 = launch_counts["decode_attention_int8"] - before
        if k1_4 != layers * gen.steps:
            raise AssertionError(f"3h int4 S2TT: K1 launched {k1_4} times in {gen.steps} "
                                 "steps")
        lin = res.translator.params["text_decoder"]["stack"]["layers"][0]["ffn"]["inner_proj"]
        q = unpack_int4(lin["weight_i4"]).float()
        G = lin["scale4"].shape[0]
        x = torch.randn((5, 1, q.shape[0]), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(12))
        w = (q.reshape(G, -1, q.shape[1]) * lin["scale4"][:, None, :]).reshape(q.shape)
        plain = x @ w + lin["bias"].float()
        got = linear(lin, x)
        lin_err = float((got - plain).abs().max())
        if not lin_err <= 1e-4 * float(plain.abs().max()):
            raise AssertionError(f"3h: the int4 linear differs from its dequantized plain "
                                 f"product by {lin_err:.3g}")
        request4 = {k: v * 1e3 for k, v in res.translator.last_timings.items()}
        log(f"3h m4t_predict S2TT 10 s with --quantize_bits 4: wall {wall4:.2f} s "
            f"(loading included: " + ", ".join(
                f"{k} {v:.2f}" for k, v in res.load_timings.items()) + " s); request "
            + ", ".join(f"{k} {v:.1f}" for k, v in request4.items())
            + f" ms, {request4['text_decode'] / gen.steps:.2f} ms a decode step; "
            f"{gen.steps} decode steps, K1 launches {k1_4}, text "
            f"{res.texts[0][:40]!r}; int4 linear {tuple(q.shape)} vs its dequantized plain "
            f"product: max abs error {lin_err:.3g} [{smi}]")
        stats.update(int4_wall_s=wall4, int4_request_stages_ms=request4,
                     int4_steps=gen.steps, int4_linear_err=lin_err)
        del res
        gc.collect()
    return {"launches": launches, "stats": stats}


def tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)
    else:
        yield tree


def phase_tiny_offline() -> None:
    """tiny_v2 through the loaders: a seeded fp32 tiny_v2 UnitY and a
    ``CodeHifiGanConfig()`` unit HiFi-GAN exported as ``.pt`` files, loaded in
    fp32 by ``load_unity_model_and_tokenizers`` and ``load_vocoder`` onto the
    card and onto the CPU, then a 2 s S2ST request with int8 KV, the decode
    cut to 17 steps, on each:
    text, tokens and units identical, K1 launched twice a decode step (two
    decoder layers) on the card and never on the CPU, waveforms within
    1e-4."""
    import numpy as np
    import torch

    from seamless_communication_torch.checkpoint.fairseq_export import (
        export_unity, export_vocoder,
    )
    from seamless_communication_torch.cli import loading
    from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.vocoder.codehifigan import (
        CodeHifiGanConfig, code_hifigan_init,
    )
    from seamless_communication_torch.ops.kernels import launch_counts

    cfg = get_arch("tiny_v2")
    gen = torch.Generator().manual_seed(7)
    params = unity.unity_init(gen, cfg)
    vocoder = code_hifigan_init(gen, CodeHifiGanConfig())
    wav = (np.random.default_rng(8).standard_normal(2 * 16000) * 0.1).astype(np.float32)
    opts = SequenceGeneratorOptions(soft_max_seq_len=(0, 16), kv_cache_int8=True)
    out = {}
    with offline_dir() as d:
        torch.save({"model": export_unity(params)}, d / "unity.pt")
        torch.save({"generator": export_vocoder(vocoder)}, d / "vocoder.pt")
        write_cards(d, "model_arch: tiny_v2\nlangs: [eng, fra]\nnum_units: 100\n"
                       "unit_langs: [eng, fra]\n", num_words=200)
        for device in ("cuda", "cpu"):
            tree, _, text_tok, unit_tok, char_tok = loading.load_unity_model_and_tokenizers(
                OFFLINE_CARD, dtype=torch.float32, device=device)
            voc, voc_cfg, idx_map = loading.load_vocoder(OFFLINE_VOCODER, device=device)
            tr = Translator(tree, cfg, text_tok, unit_tok, char_tok, vocoder_params=voc,
                            vocoder_cfg=voc_cfg, lang_spkr_idx_map=idx_map,
                            text_opts=opts, device=device)
            before = launch_counts["decode_attention_int8"]
            texts, speech = tr.predict(wav, "s2st", "eng")
            res = tr.generator.last_result
            k1 = launch_counts["decode_attention_int8"] - before
            want = cfg.nllb.num_decoder_layers * res.steps if device == "cuda" else 0
            if k1 != want:
                raise AssertionError(f"tiny_v2 loaded on {device}: {k1} K1 launches, "
                                     f"expected {want}")
            out[device] = (texts, res.tokens[:, 0].cpu(), speech)
    (tc, kc, sc), (tp, kp, sp) = out["cuda"], out["cpu"]
    err = max((float(np.abs(a - b).max(initial=0.0))
               for a, b in zip(sc.audio_wavs, sp.audio_wavs)), default=0.0)
    if not (tc == tp and torch.equal(kc, kp) and sc.units == sp.units) or err > 1e-4 \
            or [a.shape for a in sc.audio_wavs] != [b.shape for b in sp.audio_wavs]:
        raise AssertionError(f"tiny_v2 through the loaders: the card and the CPU differ "
                             f"(texts {tc == tp}, units {sc.units == sp.units}, "
                             f"waveforms {err:.3g})")
    log(f"tiny_v2 through the loaders (.pt files, fp32): S2ST text, tokens and "
        f"{len(sc.units[0])} units identical on the card and the CPU, waveform max "
        f"abs difference {err:.3g}")


# ---------------------------------------------------------------------------
# phase 3i: SeamlessStreaming
# ---------------------------------------------------------------------------

STREAM_CARD, MONO_CARD = "smoke_streaming_unity", "smoke_streaming_mono"
STREAM_MODES = (("unfused", False), ("fused", True), ("incremental", "incremental"))
STREAM_SECONDS = 10.0
CHUNK_MS = 320


def streaming_flash_case(smi: str) -> dict:
    """Phase 2's K6 at the streaming re-encode's shape: the fused agent pads
    the fbank of 10 s to 1024 frames, so the conformer attends over T = 512
    stacked frames (499 valid) with the chunk-causal bias of the
    ``streaming`` arch (chunk 8, every chunk to the left) plus the key
    padding and the Shaw relative logits folded into ``ab``. K6 against its
    plain version in fp32 and bf16 (as ``phase_flash_attention`` holds
    them), timed beside the library's SDPA with the same float mask and the
    bound over the logits the mask leaves; under ``ab`` the fp32 kernel
    skips no tile pair (``skippable_tiles_fwd``), which is counted."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from seamless_communication_torch.ops.conformer import chunk_attention_bias
    from seamless_communication_torch.ops.kernels import flash_attention as fl

    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    B, H, T, Dh, valid = 1, H_MAIN, 512, DH_MAIN, 499
    qkv = [torch.as_tensor(rng.standard_normal((B, H, T, Dh)), dtype=torch.float32,
                           device=dev) for _ in range(3)]
    qkv[0] = qkv[0] / Dh ** 0.5
    pad = torch.where(torch.arange(T, device=dev) < valid, 0.0, -1e9)
    chunk = chunk_attention_bias(T, 8, -1, device=dev)
    rel = torch.as_tensor(rng.standard_normal((B, H, T, T)) * 0.5, dtype=torch.float32,
                          device=dev)
    ab32 = fl.padded_bias((rel + pad + chunk).broadcast_to((B, H, T, T)), torch.float32)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        qs, k, v = (x.to(dtype) for x in qkv)
        ab = ab32 if dtype is torch.float32 else fl.padded_bias(ab32, dtype)
        got = fl.flash_attention(qs, k, v, ab)
        ref = fl._reference(qs, k, v, ab)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= tol[dtype] * (1 + ref.float().abs())).all()):
            raise AssertionError(f"K6 streaming re-encode {dtype}: out max err "
                                 f"{float(err.max()):.3g} over tolerance")
        k_ms = cuda_time_ms(lambda: fl.flash_attention(qs, k, v, ab))
        p_ms = cuda_time_ms(lambda: fl._reference(qs, k, v, ab), calls=5, reps=20)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=ab, scale=1.0), calls=5, reps=20)
        pairs = fl.unmasked_pairs(B, H, T, T, ab)
        bound = fl.bound(B, H, T, T, Dh, dtype, True, False, pairs)
        skipped = int(fl.skippable_tiles_fwd(None, None, T, T, ab).sum())
        log(f"K6 streaming re-encode 10 s, T={T} ({valid} valid, chunk-causal bias, "
            f"chunk 8), {str(dtype)[6:]}: out max abs err {float(err.max()):.3g} "
            f"(rtol=atol={tol[dtype]}); device kernel {k_ms * 1e3:.2f} us, plain "
            f"{p_ms * 1e3:.2f} us, library SDPA with the float mask {lib_ms * 1e3:.2f} us, "
            f"bound {bound[0] * 1e3:.2f} us ({bound[1]}; {pairs} unmasked logits of "
            f"{H * T * T}), {skipped} tile pairs skipped, kernel at "
            f"{k_ms / bound[0]:.1f}x its bound [{smi}]")
        out[str(dtype)[6:]] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                               "bound_ms": bound[0], "bound_by": bound[1],
                               "max_abs_err": float(err.max()), "tiles_skipped": skipped,
                               "unmasked_pairs": pairs}
    return out


def write_streaming_cards(d, unity_extra: str = "", num_words: int = 1200) -> None:
    """The synthetic tokenizers and two cards in ``d``: ``STREAM_CARD``, the
    packaged ``seamless_streaming_unity`` card with the ``streaming`` arch,
    ``d/unity.pt`` and these tokenizers (and ``unity_extra``'s fields), and
    ``MONO_CARD``, ``seamless_streaming_monotonic_decoder`` with
    ``d/mono.pt``."""
    (d / "nllb.model").write_bytes(synthetic_spm(num_words))
    (d / "char.model").write_bytes(synthetic_char_spm())
    (d / f"{STREAM_CARD}.yaml").write_text(
        f"name: {STREAM_CARD}\nbase: seamless_streaming_unity\nmodel_arch: streaming\n"
        f"checkpoint: {d / 'unity.pt'}\ntokenizer: {d / 'nllb.model'}\n"
        f"char_tokenizer: {d / 'char.model'}\n{unity_extra}")
    (d / f"{MONO_CARD}.yaml").write_text(
        f"name: {MONO_CARD}\nbase: seamless_streaming_monotonic_decoder\n"
        f"checkpoint: {d / 'mono.pt'}\n")


def stream_timed(pipe, wav, tgt_lang: str = "eng"):
    """``StreamingSession(pipe).run(wav)`` with each ``process`` call timed
    (host wall to a synchronized card) -> (outputs, per-call ms, per-call
    stage ms summed over the agents' ``last_timings``, wall s)."""
    import torch

    from seamless_communication_torch.streaming.pipeline import StreamingSession

    times, stages = [], []
    process = pipe.process
    timed_agents = [a for a in pipe.agents if hasattr(a, "last_timings")]

    def timed(seg):
        for a in timed_agents:
            a.last_timings = {}
        t0 = time.perf_counter()
        out = process(seg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        split: dict = {}
        for a in timed_agents:
            for k, v in a.last_timings.items():
                split[k] = split.get(k, 0.0) + v * 1e3
        stages.append(split)
        return out

    pipe.process = timed
    session = StreamingSession(pipe, segment_size_ms=CHUNK_MS, tgt_lang=tgt_lang)
    t0 = time.perf_counter()
    outs = list(session.run(wav))
    torch.cuda.synchronize()
    return outs, times, stages, time.perf_counter() - t0


def text_decoder_agent(pipe):
    return next(a for a in pipe.agents if hasattr(a, "policy_counts"))


def stream_waveform(seed: int = 24):
    """STREAM_SECONDS of seeded noise at 16 kHz (3i's waveform at seed 24)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(STREAM_SECONDS * 16000)) * 0.1).astype(np.float32)


@contextlib.contextmanager
def recording_bursts(record: list):
    """Within the block, each write burst of a fused streaming agent records
    its top-2 logit gaps and appends its decisions to ``record`` as
    (statistic, top-2 logit gap, token written or None), the form of
    ``BatchedStreamingPool.session_decisions``."""
    from seamless_communication_torch.streaming import fused

    orig = fused.monotonic_write_burst

    def rec(*a, **kw):
        burst = orig(*a, **dict(kw, with_gaps=True))
        record.extend((st, gap, burst.tokens[i] if i < len(burst.tokens) else None)
                      for i, (st, gap) in enumerate(zip(burst.stats, burst.gaps)))
        return burst

    fused.monotonic_write_burst = rec
    try:
        yield
    finally:
        fused.monotonic_write_burst = orig


def phase_streaming(smi: str, out_dir: str = "chiprun_out", record: bool = True) -> dict:
    """3i. SeamlessStreaming at full width: the ``streaming`` UnitY (the
    24-layer Shaw conformer with chunk-causal attention, chunk 8, no text
    encoder, the NAR T2U 6 + 6) and the dense_1b EMMA decoder
    (``MonotonicDecoderConfig()``) on seeded bf16 weights, written as fp16
    ``.pt`` files by the port's exporters (the UnitY without a text decoder,
    as the released checkpoint) with cards inheriting the packaged ones, read
    back by ``load_unity_model_and_tokenizers`` and ``load_monotonic_decoder``
    (every leaf equal to the file's fp16 value), with ``CodeHifiGanConfig()``
    (fp32, seeded). The speech encoder on 10 s with the fused option and
    without: within 2e-3. Then, with ``SEAMLESS_FUSED_ATTN=1``, 10 s of seeded
    audio streamed in 320 ms chunks through ``build_s2t_pipeline`` and
    ``build_s2st_pipeline`` + ``StreamingSession`` in each mode (unfused
    encoder and decoder agents, the fused re-encode, the incremental
    encoder), the EMMA decoder int8 by the builders' auto, the default policy
    (threshold 0.5, ``max_len_b`` 200, 50 writes a call). Each run: tokens
    written > 0, S2ST units > 0 with finite waveforms within [-1, 1] and
    whole unit frames, a finished last segment; K6 launched in the fused
    mode. Launches are counted from 0 just before each run. The statistic
    at every decision of every run goes to
    ``<out_dir>/streaming_decisions.json``. The incremental S2TT run's
    tokens, its row and (``record``: with a top-2 logit gap a decision,
    ``recording_bursts``) its decisions are returned as ``single``, for 3l."""
    import os

    import numpy as np
    import torch

    from seamless_communication_torch.assets import load_card
    from seamless_communication_torch.checkpoint.fairseq_export import (
        export_monotonic, export_unity,
    )
    from seamless_communication_torch.cli import loading
    from seamless_communication_torch.models.monotonic.model import (
        MonotonicDecoderConfig, monotonic_decoder_init,
    )
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
    from seamless_communication_torch.models.vocoder.codehifigan import (
        CodeHifiGanConfig, code_hifigan_init,
    )
    from seamless_communication_torch.ops.kernels import launch_counts, reset_launch_counts
    from seamless_communication_torch.streaming.pipeline import (
        build_s2st_pipeline, build_s2t_pipeline,
    )

    dev = torch.device("cuda")
    cfg = get_arch("streaming")
    kw = dict(dtype=torch.bfloat16, device=dev)
    params = unity.unity_init(torch.Generator(device=dev).manual_seed(21), cfg, **kw)
    del params["text_decoder"]          # the streaming UnitY has none
    mono = monotonic_decoder_init(torch.Generator(device=dev).manual_seed(22),
                                  MonotonicDecoderConfig(), **kw)
    n_unity = sum(t.numel() for t in tensor_leaves(params))
    n_mono = sum(t.numel() for t in tensor_leaves(mono))
    stats: dict = {"unity_params": n_unity, "mono_params": n_mono}
    with offline_dir() as d:
        t0 = time.perf_counter()
        torch.save({"model": export_unity(params, dtype=torch.float16)}, d / "unity.pt")
        torch.save({"model": export_monotonic(mono, dtype=torch.float16)}, d / "mono.pt")
        export_s = time.perf_counter() - t0
        gc.collect()
        write_streaming_cards(d)
        sizes = {f: os.path.getsize(d / f) for f in ("unity.pt", "mono.pt")}
        timings: dict = {"unity": {}, "mono": {}}
        t0 = time.perf_counter()
        tree, _, text_tok, _, char_tok = loading.load_unity_model_and_tokenizers(
            STREAM_CARD, timings=timings["unity"])
        mono_tree, mono_cfg = loading.load_monotonic_decoder(MONO_CARD,
                                                             timings=timings["mono"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = lambda w, g: torch.equal(w.to(torch.float16).to(g.dtype), g)  # noqa: E731
        held = (hold_leaves("unity", params, tree, same)
                + hold_leaves("mono", mono, mono_tree, same))
    log(f"3i exported the streaming UnitY ({n_unity / 1e9:.3f} B parameters, no text "
        f"decoder) and the dense_1b EMMA decoder ({n_mono / 1e9:.3f} B) as fp16 .pt "
        f"files in {export_s:.1f} s (unity.pt {sizes['unity.pt'] / 2**30:.3f} GiB, mono.pt "
        f"{sizes['mono.pt'] / 2**30:.3f} GiB); loaded in {load_s:.2f} s ("
        + "; ".join(f"{k}: " + ", ".join(f"{s} {v:.2f}" for s, v in t.items())
                    for k, t in timings.items())
        + f" s); {held} leaves equal the files' fp16 values [{smi}]")
    stats.update(export_s=export_s, file_bytes=sizes, load_s=load_s, load_stages_s=timings)
    del params, mono
    gc.collect()

    vocoder_cfg = CodeHifiGanConfig()
    vocoder = code_hifigan_init(torch.Generator(device=dev).manual_seed(23), vocoder_cfg,
                                dtype=torch.float32, device=dev)
    idx_map = load_card("vocoder_v2")["model_config"]["lang_spkr_idx_map"]
    unit_tok = UnitTokenizer(vocoder_cfg.num_units, ["eng", "fra"], "base_v2")
    wav = stream_waveform()

    # the re-encode's conformer with the fused option and without
    from seamless_communication_torch.audio.fbank import fbank_numpy
    fb = fbank_numpy(wav)
    T = -(-fb.shape[0] // 128) * 128
    fbp = np.zeros((1, T, 80), np.float32)
    fbp[0, :fb.shape[0]] = fb
    with torch.inference_mode():
        encs = {}
        for on in (True, False):
            with fused_attention(on):
                encs[on] = unity.encode_speech(
                    tree, cfg, torch.as_tensor(fbp, device=dev),
                    torch.tensor([fb.shape[0]], device=dev)).seqs.float()
    err = (encs[True] - encs[False]).abs()
    if not bool((err <= 2e-3 + 2e-3 * encs[False].abs()).all()):
        raise AssertionError(f"3i: the streaming encoder with and without the fused "
                             f"option differs by up to {float(err.max()):.3g}")
    log(f"3i: the streaming speech encoder on 10 s ({T // 2} conformer frames, chunk-"
        f"causal) with the fused option (K6) and without: max abs difference "
        f"{float(err.max()):.3g} (atol 2e-3 + rtol 2e-3)")
    del encs

    runs, k6, tokens, decisions, single = [], 0, {}, {}, None
    hop = vocoder_cfg.hifigan.total_upsample
    n_source = -(-len(wav) // int(CHUNK_MS * 16))
    with fused_attention(True):
        for task in ("s2tt", "s2st"):
            for mode, fused in STREAM_MODES:
                if task == "s2tt":
                    pipe = build_s2t_pipeline(tree, cfg, mono_tree, mono_cfg, text_tok,
                                              tgt_lang="eng", fused=fused)
                else:
                    pipe = build_s2st_pipeline(tree, cfg, mono_tree, mono_cfg, text_tok,
                                               unit_tok, char_tok, vocoder, vocoder_cfg,
                                               idx_map, tgt_lang="eng", fused=fused)
                dec = text_decoder_agent(pipe)
                if "weight_i8" not in dec.params["layers"][0]["ffn"]["inner_proj"]:
                    raise AssertionError("3i: the EMMA decoder is not int8 on the card")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                bursts: list = []
                with (recording_bursts(bursts) if record and (task, mode) == (
                        "s2tt", "incremental") else contextlib.nullcontext()):
                    outs, times, stages, wall = stream_timed(pipe, wav)
                launches = dict(launch_counts)
                peak = torch.cuda.max_memory_allocated() / 2**30
                label = f"3i {task.upper()} {mode}"
                counts = dict(dec.policy_counts)
                stat = np.asarray(dec.decision_stats, np.float64)
                margin = float(np.abs(stat - dec.decision_threshold).min()) \
                    if stat.size else None
                if counts["tokens"] <= 0:
                    raise AssertionError(f"{label}: no token written")
                if not outs or not outs[-1][1].finished:
                    raise AssertionError(f"{label}: the stream did not finish")
                # the source chunks that ran the model: each stage's median;
                # the drain calls: each stage's total
                working = [st for st in stages[:n_source] if st]
                split = {k: statistics.median(st.get(k, 0.0) for st in working)
                         for k in sorted({k for st in working for k in st})}
                drain = {k: sum(st.get(k, 0.0) for st in stages[n_source:])
                         for k in sorted({k for st in stages[n_source:] for k in st})}
                work_ms = [t for t, st in zip(times[:n_source], stages) if st]
                row = {"task": task, "mode": mode, "calls": len(times),
                       "source_chunks": n_source, "chunk_ms": times[:n_source],
                       "working_chunks": len(work_ms),
                       "working_median_ms": statistics.median(work_ms),
                       "stage_median_ms": split, "drain_ms": times[n_source:],
                       "drain_stage_ms": drain, "wall_s": wall,
                       "xrt": wall / STREAM_SECONDS, "policy": counts,
                       "decisions": int(stat.size), "min_margin": margin,
                       "margins_under_0.05": int((np.abs(stat - dec.decision_threshold)
                                                  < 0.05).sum()),
                       "stat_range": [float(stat.min()), float(stat.max())]
                       if stat.size else None,
                       "k6_launches": launches["flash_attention"], "peak_gib": peak}
                extra = ""
                if task == "s2st":
                    wavs = [np.asarray(s.content) for _, s in outs
                            if type(s).__name__ == "SpeechSegment" and not s.is_empty]
                    samples = sum(w.size for w in wavs)
                    if samples == 0 or samples % hop:
                        raise AssertionError(f"{label}: {samples} samples, not a "
                                             f"positive multiple of {hop}")
                    for w in wavs:
                        if not np.isfinite(w).all() or np.abs(w).max() > 1.0:
                            raise AssertionError(f"{label}: a waveform chunk is not "
                                                 "finite or outside [-1, 1]")
                    row.update(units=samples // hop, audio_s=samples / 16000,
                               speech_segments=len(wavs))
                    extra = (f"; {samples // hop} units, {samples / 16000:.2f} s of audio "
                             f"in {len(wavs)} segments")
                if mode == "fused" and launches["flash_attention"] <= 0:
                    raise AssertionError(f"{label}: K6 never launched with the fused "
                                         "option on")
                k6 += launches["flash_attention"]
                tokens[task, mode] = list(dec.states.target_indices)
                src = times[:n_source]
                log(f"{label}: {len(times)} process calls ({n_source} source chunks of "
                    f"{CHUNK_MS} ms, {len(times) - n_source} drain calls); ms a source "
                    f"chunk median {statistics.median(src):.1f}, max {max(src):.1f} "
                    f"(budget {CHUNK_MS}); the {len(work_ms)} that ran the model: median "
                    f"{statistics.median(work_ms):.1f} = " + ", ".join(
                        f"{k} {v:.1f}" for k, v in split.items())
                    + f"; drain {sum(times[n_source:]):.1f} ms = " + ", ".join(
                        f"{k} {v:.1f}" for k, v in drain.items()) + f"; wall "
                    f"{wall:.2f} s, xRT {wall / STREAM_SECONDS:.3f}; {counts['tokens']} "
                    f"tokens in {counts['write']} WRITE and {counts['read']} READ "
                    f"actions, {stat.size} decisions, statistic "
                    f"{row['stat_range']}, smallest margin to the threshold "
                    f"{dec.decision_threshold}: {margin} ({row['margins_under_0.05']} "
                    f"within 0.05){extra}; K6 launches "
                    f"{launches['flash_attention']}; peak {peak:.2f} GiB [{smi}]")
                runs.append(row)
                decisions[f"{task} {mode}"] = [float(x) for x in stat]
                if (task, mode) == ("s2tt", "incremental"):
                    single = {"tokens": tokens[task, mode], "decisions": bursts, "row": row,
                              "threshold": dec.decision_threshold}
                threshold = dec.decision_threshold
                del pipe, dec
                gc.collect()
    same = {f"{task} {mode}": tokens[task, mode] == tokens["s2tt", "unfused"]
            for task, mode in tokens}
    log(f"3i: the final target tokens equal the unfused S2TT run's: {same} (the "
        f"incremental encoder keeps bf16 keys and values, the re-encode fp32 ones)")
    # the statistic at every decision of every run, too long for the output
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "streaming_decisions.json"), "w") as f:
        json.dump({"threshold": threshold, "card": smi, "statistic": decisions}, f)
    stats.update(runs=runs, same_tokens_as_unfused_s2tt=same)
    return {"launches": k6, "stats": stats, "single": single,
            "models": {"unity": tree, "cfg": cfg, "mono": mono_tree, "mono_cfg": mono_cfg,
                       "text": text_tok, "char": char_tok}}


def tiny_streaming_models(gen):
    """The tiny models of tests/test_torch_streaming.py from ``gen``: the
    tiny_v2 UnitY, the same with the chunk-causal encoder of the JAX
    incremental test, the monotonic decoder (dim 64, 2 layers, 4 heads,
    vocab 256), the tiny vocoder, and the toy tokenizers."""
    import dataclasses

    from seamless_communication_torch.models.monotonic.model import (
        MonotonicDecoderConfig, monotonic_decoder_init,
    )
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
    from seamless_communication_torch.models.vocoder.codehifigan import (
        CodeHifiGanConfig, code_hifigan_init,
    )
    from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig
    from seamless_communication_torch.models.wav2vec2.encoder import SpeechEncoderConfig
    from seamless_communication_torch.ops.conformer import ConformerConfig
    from seamless_communication_torch.text.char_tokenizer import CharTokenizer
    from seamless_communication_torch.text.nllb import NllbTokenizer
    from seamless_communication_torch.text.spm import (
        TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
    )

    base = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
            ("</s>", 0.0, TYPE_CONTROL)]
    chars = ["▁"] + list("abc.,")
    words = ["▁aa", "▁bb", "▁cc", ",", "."]
    text = NllbTokenizer(SentencePieceModel.from_bytes(build_spm_model(
        base + [(w, -2.0, TYPE_NORMAL) for w in words]
        + [(c, -10.0, TYPE_NORMAL) for c in chars])), ["__eng__", "__fra__"])
    char = CharTokenizer(SentencePieceModel.from_bytes(build_spm_model(
        base + [(c, -1.0, TYPE_NORMAL) for c in chars])))
    cfg = get_arch("tiny_v2")
    chunk_cfg = dataclasses.replace(cfg, speech=SpeechEncoderConfig(
        model_dim=64, feature_dim=160, ffn_inner_dim=128, num_adaptor_heads=4,
        chunk_size=4, left_chunk_num=-1,
        conformer=ConformerConfig(dim=64, ffn_inner_dim=128, num_heads=4, num_layers=2,
                                  depthwise_kernel_size=7, pos_type="shaw",
                                  shaw_max_left=8, shaw_max_right=3)))
    mono_cfg = MonotonicDecoderConfig(model_dim=64, num_layers=2, num_heads=4,
                                      ffn_inner_dim=128, vocab_size=256,
                                      num_monotonic_energy_layers=2)
    voc_cfg = CodeHifiGanConfig(**TINY_VOCODER, hifigan=HifiGanConfig(**TINY_HIFIGAN))
    return dict(cfg=cfg, unity=unity.unity_init(gen, cfg), chunk_cfg=chunk_cfg,
                chunk_unity=unity.unity_init(gen, chunk_cfg), mono_cfg=mono_cfg,
                mono=monotonic_decoder_init(gen, mono_cfg), voc_cfg=voc_cfg,
                voc=code_hifigan_init(gen, voc_cfg), text=text, char=char,
                units=UnitTokenizer(100, ["eng", "fra"], "base_v2"))


def phase_tiny_streaming() -> None:
    """The tiny streaming models of the CPU tests on the card and on the CPU,
    fp32, a 2 s tone in 320 ms chunks, decision threshold 0.001: S2TT
    unfused and fused on tiny_v2 and incremental on the chunk-causal encoder,
    S2ST linear (unfused, fused) and tree (fused) must write the same tokens
    and emit the same segments in the same order with the same ``finished``
    flags, the same texts and units, and waveforms within 1e-4."""
    import numpy as np
    import torch

    from seamless_communication_torch.streaming.pipeline import (
        build_s2st_pipeline, build_s2st_tree_pipeline, build_s2t_pipeline,
    )

    m = tiny_streaming_models(torch.Generator().manual_seed(31))
    wav = (0.1 * np.sin(2 * np.pi * 300 * np.arange(32000) / 16000)).astype(np.float32)
    kw = dict(tgt_lang="eng", min_starting_wait_w2vbert=16, decision_threshold=0.001,
              max_len_b=12, max_consecutive_writes=6)
    s2st_args = lambda: (m["text"], m["units"], m["char"], m["voc"], m["voc_cfg"],  # noqa: E731
                         {"multilingual": {"eng": 0}, "multispkr": {"eng": [0]}})
    cases = [("S2TT unfused", lambda dv: build_s2t_pipeline(
                  m["unity"], m["cfg"], m["mono"], m["mono_cfg"], m["text"], fused=False,
                  device=dv, **kw)),
             ("S2TT fused", lambda dv: build_s2t_pipeline(
                  m["unity"], m["cfg"], m["mono"], m["mono_cfg"], m["text"], fused=True,
                  device=dv, **kw)),
             ("S2TT incremental", lambda dv: build_s2t_pipeline(
                  m["chunk_unity"], m["chunk_cfg"], m["mono"], m["mono_cfg"], m["text"],
                  fused="incremental", device=dv, **kw))]
    for name, build, fused in (("S2ST unfused", build_s2st_pipeline, False),
                               ("S2ST fused", build_s2st_pipeline, True),
                               ("S2ST tree fused", build_s2st_tree_pipeline, True)):
        cases.append((name, lambda dv, b=build, f=fused: b(
            m["unity"], m["cfg"], m["mono"], m["mono_cfg"], *s2st_args(), fused=f,
            device=dv, min_unit_chunk_size=5, text_bucket=32, **kw)))
    for name, build in cases:
        got = {}
        for device in ("cuda", "cpu"):
            pipe = build(device)
            outs = stream_timed(pipe, wav)[0]
            segs = [(i, type(s).__name__, s.content, bool(s.finished)) for i, s in outs]
            got[device] = (list(text_decoder_agent(pipe).states.target_indices), segs)
        (tc, sc), (tp, sp) = got["cuda"], got["cpu"]
        if tc != tp or [(i, k, f) for i, k, _, f in sc] != [(i, k, f) for i, k, _, f in sp]:
            raise AssertionError(f"tiny {name}: tokens or segments differ between the "
                                 f"card ({tc}) and the CPU ({tp})")
        err = 0.0
        for (_, kind, a, _), (_, _, b, _) in zip(sc, sp):
            if kind == "SpeechSegment":
                a, b = np.asarray(a), np.asarray(b)
                if a.shape != b.shape:
                    raise AssertionError(f"tiny {name}: waveform shapes {a.shape}, "
                                         f"{b.shape}")
                err = max(err, float(np.abs(a - b).max(initial=0.0)))
            elif not (a is None and b is None) and str(a) != str(b):
                raise AssertionError(f"tiny {name}: segment {a!r} on the card, {b!r} on "
                                     "the CPU")
        if err > 1e-4 or not tc:
            raise AssertionError(f"tiny {name}: waveforms differ by {err:.3g} or no "
                                 "token was written")
        log(f"tiny {name}: {len(tc)} tokens and {len(sc)} segments identical on the card "
            f"and the CPU, waveform max abs difference {err:.3g}")


# ---------------------------------------------------------------------------
# phases 2, 3k, 3l and 4: serving
# ---------------------------------------------------------------------------

SERVE_SECONDS = tuple(4.0 + 6.0 * i / 7 for i in range(8))   # 3k: 8 requests, 4-10 s
POOL_SLOTS = 4
POOL_SEEDS = (24, 61, 62, 63)           # 3l's sessions; seed 24 is 3i's waveform
ADAPTOR_T, ADAPTOR_VALID = 257, (63, 61, 59, 1)   # the pool's adaptor: 2048 / 8 + 1 rows
MARGIN = 1e-3                           # 3l: decisions nearer than this may flip


def decode_batch_case(smi: str, floor_ms: float) -> dict:
    """Phase 2's K1 at 3k's batched decode shape: a group of 8 requests at
    beam 5 is B = 40 rows, H=16, T=320 (a cut decode's cache), Dh=64. Held
    against its plain version (caches bit-equal, out within 2e-5 in fp32 and
    1.6e-2 in bf16) for each origin pattern at steps 0, 137, 200 and 319 and
    the first row of each slice of ``split_plan``; timed L2-warm and
    HBM-cold at step 200 beside its bound, the plain version and the launch
    floor; the cluster size ``split_plan`` picks is printed."""
    import numpy as np
    import torch

    from seamless_communication_torch.ops.kernels import decode_attention as da

    name = "decode_attention_int8"
    B, T, Dh = B_SERVE, T_MAIN, DH_MAIN
    plan = da.split_plan(B, H_MAIN, T, Dh, 8)
    starts = [r.start for r in plan.slices(T) if 0 < r.start < T]
    steps = sorted({0, 137, STEP_TIMED, T - 1, *starts})
    rng = np.random.default_rng(16)
    dev = torch.device("cuda")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        vecs, caches = decode_inputs(rng, name, B, T, Dh, dtype)
        errs[dtype] = 0.0
        for pattern, origins in decode_origins(B).items():
            src = torch.tensor(origins, dtype=torch.int32, device=dev)
            for step in steps:
                errs[dtype] = max(errs[dtype], hold_decode_case(
                    name, f"B={B} {str(dtype)[6:]} {pattern} step {step}",
                    (*vecs, *caches, step, src)))
    vecs, caches = decode_inputs(rng, name, B, T, Dh, torch.float32)
    src = torch.tensor(decode_origins(B)["repeated"], dtype=torch.int32, device=dev)
    args = (*vecs, *caches, STEP_TIMED, src)
    ms = cuda_time_ms(lambda: da.fused_decode_self_attention_int8(*args))
    plain_ms = cuda_time_ms(lambda: da._reference(*args))
    ms_hbm = cold_time_ms(name, rng, B, T, Dh, STEP_TIMED, torch.float32)
    bound, by = decode_bound_ms(name, B, T, Dh, STEP_TIMED, src.tolist(), torch.float32)
    log(f"K1 batched B={B} H={H_MAIN} T={T} Dh={Dh}: split_plan cluster {plan.cluster}, "
        f"slices of {plan.slice_rows} rows, tiles of {plan.tile_rows}; {len(steps)} steps x "
        f"3 origin patterns, caches exact, out max abs err {errs[torch.float32]:.3g} (fp32, "
        f"tol 2e-5), {errs[torch.bfloat16]:.3g} (bf16, tol 1.6e-2); step {STEP_TIMED}: "
        f"L2-warm {ms * 1e3:.2f} us, HBM-cold {ms_hbm * 1e3:.2f} us, bound "
        f"{bound * 1e3:.2f} us ({by}), plain {plain_ms * 1e3:.2f} us, launch floor "
        f"{floor_ms * 1e3:.2f} us [{smi}]")
    return {"B": B, "cluster": plan.cluster, "max_abs_err": errs[torch.float32],
            "max_abs_err_bf16": errs[torch.bfloat16], "ms": ms, "ms_hbm": ms_hbm,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "floor_ms": floor_ms}


def adaptor_flash_case(smi: str) -> dict:
    """Phase 2's K6 at the streaming pool's adaptor: B = 4 slots, H=16,
    Dh=64, T = 257 rows (2048 stacked frames through the stride-8 adaptor),
    each slot with its own valid length (``ADAPTOR_VALID``: three sessions
    and an idle slot) as key segment ids, as ``try_flash`` turns the
    adaptor's key padding into them. K6 against its plain version in fp32
    (the adaptor's dtype) and bf16 within rtol = atol = 1e-5 and 1.6e-2,
    timed beside the library's SDPA with the segment mask as a float mask
    and the bound over the unmasked logits; the fp32 kernel's skipped key
    tiles counted."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from seamless_communication_torch.ops.kernels import flash_attention as fl

    dev = torch.device("cuda")
    rng = np.random.default_rng(43)
    B, H, T, Dh = POOL_SLOTS, H_MAIN, ADAPTOR_T, DH_MAIN
    qkv = [torch.as_tensor(rng.standard_normal((B, H, T, Dh)), dtype=torch.float32,
                           device=dev) for _ in range(3)]
    qkv[0] = qkv[0] / Dh ** 0.5
    q_seg = torch.ones((B, T), dtype=torch.int32, device=dev)
    valid = torch.tensor(ADAPTOR_VALID, device=dev)
    kv_seg = (torch.arange(T, device=dev)[None] < valid[:, None]).to(torch.int32)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        qs, k, v = (x.to(dtype) for x in qkv)
        args = (qs, k, v, None, q_seg, kv_seg)
        got = fl.flash_attention(*args)
        ref = fl._reference(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= tol[dtype] * (1 + ref.float().abs())).all()):
            raise AssertionError(f"K6 pool adaptor {dtype}: out max err "
                                 f"{float(err.max()):.3g} over tolerance")
        mask = torch.where(q_seg[:, None, :, None] == kv_seg[:, None, None, :], 0.0,
                           fl.MASK_VALUE).to(dtype)
        k_ms = cuda_time_ms(lambda: fl.flash_attention(*args))
        p_ms = cuda_time_ms(lambda: fl._reference(*args), calls=5, reps=20)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, scale=1.0), calls=5, reps=20)
        pairs = fl.unmasked_pairs(B, H, T, T, None, q_seg, kv_seg)
        bound = fl.bound(B, H, T, T, Dh, dtype, False, True, pairs)
        skipped = int(fl.skippable_tiles_fwd(q_seg, kv_seg, T, T, None).sum())
        log(f"K6 pool adaptor, B={B} H={H} Dh={Dh} T={T} (valid keys {ADAPTOR_VALID}, key "
            f"segment ids), {str(dtype)[6:]}: out max abs err {float(err.max()):.3g} "
            f"(rtol=atol={tol[dtype]}); device kernel {k_ms * 1e3:.2f} us, plain "
            f"{p_ms * 1e3:.2f} us, library SDPA with the float mask {lib_ms * 1e3:.2f} us, "
            f"bound {bound[0] * 1e3:.2f} us ({bound[1]}; {pairs} unmasked logits of "
            f"{B * H * T * T}), {skipped} tile pairs skipped, kernel at "
            f"{k_ms / bound[0]:.1f}x its bound [{smi}]")
        out[str(dtype)[6:]] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                               "bound_ms": bound[0], "bound_by": bound[1],
                               "max_abs_err": float(err.max()), "tiles_skipped": skipped,
                               "unmasked_pairs": pairs}
    return out


def http_json(port: int, path: str, obj=None, timeout: float = 600.0):
    """POST ``obj`` as JSON to ``path`` on the local server (GET where None)
    -> (status, decoded body)."""
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    req = (urllib.request.Request(url) if obj is None else urllib.request.Request(
        url, data=json.dumps(obj).encode(), headers={"Content-Type": "application/json"}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def recording_predict(translator, calls: list):
    """Make ``translator.predict`` (on the batcher's worker thread) append
    each call's group, wall, stage walls, decode steps and K1 launches to
    ``calls``, its hypotheses checked; ``del translator.predict`` undoes it."""
    import torch

    from seamless_communication_torch.ops.kernels import launch_counts

    predict = translator.predict

    def rec(inputs, task, tgt_lang, **kw):
        before = launch_counts["decode_attention_int8"]
        t0 = time.perf_counter()
        out = predict(inputs, task, tgt_lang, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = translator.generator.last_result
        check_hypotheses(res, translator.text_tokenizer.target_prefix(tgt_lang).tolist(),
                         res.tokens.shape[-1], translator.cfg.nllb.eos_idx)
        calls.append({"task": task, "n": len(inputs), "inputs": list(inputs), "wall_s": wall,
                      "stages_s": dict(translator.last_timings), "steps": res.steps,
                      "k1": launch_counts["decode_attention_int8"] - before,
                      "tokens": res.tokens[:, 0].cpu(), "lengths": res.lengths[:, 0].cpu()})
        return out

    translator.predict = rec


def phase_serving(translator, tok, cfg, smi: str) -> dict:
    """3k. The dynamic batcher over HTTP on base_v2: ``serve(translator,
    port=0, max_batch=8)`` on a Translator over 3a's int8 tree, the decode
    cut to 127 steps (``hard_max_seq_len`` 128). Eight S2TT requests of
    seeded noise, 4-10 s (``SERVE_SECONDS``), posted at once as base64 WAV
    must come back 200 from one group of 8 (one ``predict``, B = 40 rows in
    K1, 24 launches a step); then the same eight one at a time through a
    server with ``max_batch=1``; then one
    S2ST request, whose ``audio_b64`` must decode to a finite waveform within
    [-1, 1]. Each ``predict``'s hypotheses are checked. Prints the batch's
    wall and each request's latency, requests per card-second batched and
    alone, ms a decode step, K1 launches from 0 and the peak memory."""
    import base64
    import threading

    import numpy as np
    import torch

    from seamless_communication_torch.inference import serving
    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.ops.kernels import launch_counts, reset_launch_counts

    t = s2st_translator(translator.params, cfg, tok, translator.vocoder_params,
                        translator.vocoder_cfg,
                        text_opts=SequenceGeneratorOptions(hard_max_seq_len=128))
    calls: list = []
    recording_predict(t, calls)
    rng = np.random.default_rng(71)      # 3k's own draws: later phases keep their audio

    def noise(seconds):
        return (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)

    wavs = [noise(s) for s in SERVE_SECONDS]
    bodies = [{"task": "s2tt", "tgt_lang": "eng",
               "audio_b64": base64.b64encode(serving._wav_bytes(w, 16000)).decode()}
              for w in wavs]
    srv = serving.serve(t, port=0, max_batch=len(bodies), max_wait_ms=2000)
    port = srv.server_address[1]
    n = len(bodies)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        results, lat = [None] * n, [0.0] * n

        def work(i):
            t0 = time.perf_counter()
            results[i] = http_json(port, "/v1/translate", bodies[i])
            lat[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        batch_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        bad = [r for r in results if r is None or r[0] != 200]
        if bad or len(calls) != 1 or calls[0]["n"] != n:
            raise AssertionError(f"3k: the {n} concurrent requests were not one group "
                                 f"answered 200: groups {[c['n'] for c in calls]}, {bad}")
        group = calls[0]
        if group["k1"] != cfg.nllb.num_decoder_layers * group["steps"] or group["k1"] <= 0:
            raise AssertionError(f"3k: K1 launched {group['k1']} times in "
                                 f"{group['steps']} steps of the group")
        # alone: a server that batches nothing (max_batch 1 waits for no one)
        alone_lat = []
        srv1 = serving.serve(t, port=0, max_batch=1)
        try:
            for body in bodies:
                t0 = time.perf_counter()
                code, out = http_json(srv1.server_address[1], "/v1/translate", body)
                alone_lat.append(time.perf_counter() - t0)
                if code != 200:
                    raise AssertionError(f"3k: a request alone got {code}: {out}")
        finally:
            srv1.shutdown()
            srv1.batcher.close()
        singles = calls[1:]
        # each request's tokens alone against its row of the group
        same = sum(bool(torch.equal(group["tokens"][next(
            r for r, x in enumerate(group["inputs"]) if np.array_equal(x, c["inputs"][0]))],
            c["tokens"][0])) for c in singles)
        code, out = http_json(port, "/v1/translate", {
            "task": "s2st", "tgt_lang": "eng",
            "audio_b64": base64.b64encode(serving._wav_bytes(noise(6.0), 16000)).decode()})
        if code != 200:
            raise AssertionError(f"3k: the S2ST request got {code}: {out}")
        audio = serving._decode_wav_b64(out["audio_b64"])
        if not (audio.size and np.isfinite(audio).all() and np.abs(audio).max() <= 1.0
                and out["sample_rate"] == 16000):
            raise AssertionError("3k: the S2ST waveform is empty, not finite or outside "
                                 "[-1, 1]")
    finally:
        srv.shutdown()
        srv.batcher.close()
        del t.predict
    launches = launch_counts["decode_attention_int8"]
    step_ms = group["stages_s"]["text_decode"] * 1e3 / group["steps"]
    alone_step_ms = [c["stages_s"]["text_decode"] * 1e3 / c["steps"] for c in singles]
    card_s_alone = sum(c["wall_s"] for c in singles)
    stats = {"requests": n, "seconds": list(SERVE_SECONDS), "batch_wall_s": batch_wall,
             "latency_s": lat, "latency_median_s": statistics.median(lat),
             "latency_max_s": max(lat), "group_predict_s": group["wall_s"],
             "group_stages_s": group["stages_s"], "steps": group["steps"],
             "ms_per_step": step_ms, "alone_latency_s": alone_lat,
             "alone_predict_s": [c["wall_s"] for c in singles],
             "alone_ms_per_step": alone_step_ms,
             "req_per_card_s_batched": n / group["wall_s"],
             "req_per_card_s_alone": n / card_s_alone,
             "req_per_s_http_batched": n / batch_wall,
             "req_per_s_http_alone": n / sum(alone_lat), "same_tokens_as_alone": same,
             "s2st_wall_s": calls[-1]["wall_s"], "s2st_audio_s": audio.size / 16000,
             "k1_launches": launches, "k1_launches_group": group["k1"], "peak_gib": peak}
    log(f"3k: {n} concurrent S2TT requests ({SERVE_SECONDS[0]:.1f}-{SERVE_SECONDS[-1]:.1f} s) "
        f"in one group: batch wall {batch_wall * 1e3:.1f} ms (predict {group['wall_s'] * 1e3:.1f}"
        f" ms = " + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in group["stages_s"].items())
        + f"), latency median {stats['latency_median_s'] * 1e3:.1f} ms, max "
        f"{max(lat) * 1e3:.1f} ms; {group['steps']} decode steps, {step_ms:.2f} ms a step "
        f"(B*beam = {n * 5} rows); alone: latency median "
        f"{statistics.median(alone_lat) * 1e3:.1f} ms, {statistics.median(alone_step_ms):.2f} "
        f"ms a step; requests per card-second batched {n / group['wall_s']:.3f}, alone "
        f"{n / card_s_alone:.3f} ({card_s_alone / group['wall_s']:.2f}x); {same} of {n} "
        f"requests with the same tokens batched and alone; S2ST 6 s: "
        f"{calls[-1]['wall_s'] * 1e3:.1f} ms, {audio.size / 16000:.2f} s of audio; K1 "
        f"launches {launches} ({group['k1']} in the group); peak {peak:.2f} GiB [{smi}]")
    return {"launches": launches, "stats": stats}


def compare_decisions(got: list, want: list, threshold: float) -> dict:
    """Two runs' decisions, (statistic, top-2 logit gap, token or None) each,
    in order: the first decision where either run's margin (the statistic's
    distance to ``threshold``, or the gap) is under ``MARGIN``, and the first
    where their outcomes (the token written, or none) differ. The runs agree
    if they never differ, or differ only from such a decision on."""
    def margin(d):
        return min(abs(d[0] - threshold), d[1])

    low = next((i for i, (a, b) in enumerate(zip(got, want))
                if min(margin(a), margin(b)) < MARGIN), None)
    diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a[2] != b[2]), None)
    if diff is None and len(got) != len(want):
        diff = min(len(got), len(want))
    at = low if low is not None else diff
    return {"decisions": [len(got), len(want)], "first_low_margin": low,
            "first_difference": diff, "agree": diff is None or (low is not None
                                                                and low <= diff),
            "at": at, "margins_at": None if at is None or at >= min(len(got), len(want))
            else [margin(got[at]), margin(want[at])],
            "min_margin": [min(map(margin, got), default=None),
                           min(map(margin, want), default=None)]}


def phase_pool(smi: str, models: dict, single: dict) -> dict:
    """3l. The batched streaming pool at full width on 3i's loaded
    ``streaming`` UnitY and dense_1b EMMA decoder (int8 weight-only), with
    ``SEAMLESS_FUSED_ATTN=1``: ``BatchedStreamingPool(n_slots=4)`` and the
    policy of 3i's incremental stream; four 10 s sessions of seeded noise
    (session 0 on 3i's waveform) open one tick apart and push one 320 ms
    chunk a tick, the pool stepping once a tick until all four finish. Each
    pool step timed to a synchronized card (and split by the pool's
    ``last_timings``; the pool records its decisions, a top-k over the
    vocabulary a decision, as 3i's compared run does); each session's xRT from its open to its finish; K6
    launches (the adaptor, once a decoded chunk) counted from 0, more than
    0; the peak memory; beside them 3i's single incremental S2TT stream
    (``single``). Session 0's decisions must agree with that stream's up to
    the first decision where either run's margin is under ``MARGIN``
    (``compare_decisions``). Then one more session through the HTTP routes
    (/v1/stream/open, push, poll, close) on a pool of its own with
    ``max_len_b`` 20: every status 200, the session finished."""
    import torch

    from seamless_communication_torch.inference import serving
    from seamless_communication_torch.ops.kernels import launch_counts, reset_launch_counts
    from seamless_communication_torch.ops.quantization import quantize_params
    from seamless_communication_torch.streaming.multi import BatchedStreamingPool

    seg = int(CHUNK_MS * 16)
    m = models
    mono_q = quantize_params(m["mono"])
    wavs = [stream_waveform(seed) for seed in POOL_SEEDS]
    n_chunks = -(-len(wavs[0]) // seg)
    with fused_attention(True):
        pool = BatchedStreamingPool(m["unity"], m["cfg"], mono_q, m["mono_cfg"], m["text"],
                                    n_slots=POOL_SLOTS, mono_quantize_int8=False,
                                    record_decisions=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        sids, opened, done, step_ms, stages = {}, {}, {}, [], []
        tokens = {}
        t_start = time.perf_counter()
        for tick in range(400):
            for i, w in enumerate(wavs):
                if tick == i:
                    sids[i] = pool.open_session(tgt_lang="eng")
                    opened[i] = time.perf_counter()
                j = tick - i
                if i in sids and 0 <= j < n_chunks:
                    pool.push(sids[i], w[j * seg:(j + 1) * seg], finished=j == n_chunks - 1)
            t0 = time.perf_counter()
            pool.step()
            torch.cuda.synchronize()
            now = time.perf_counter()
            step_ms.append((now - t0) * 1e3)
            stages.append({k: v * 1e3 for k, v in pool.last_timings.items()})
            for i, sid in sids.items():
                tokens.setdefault(i, [])
                tokens[i] += [t for g in pool.pop(sid) for t in g.token_indices]
                if pool.session_finished(sid) and i not in done:
                    done[i] = now
            if len(done) == len(wavs):
                break
        else:
            raise AssertionError("3l: the pooled sessions did not finish in 400 steps")
        wall = time.perf_counter() - t_start
        launches = dict(launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2**30
        decisions0 = pool.session_decisions(sids[0])
        for sid in sids.values():
            pool.close_session(sid)
    if launches["flash_attention"] <= 0:
        raise AssertionError("3l: K6 never launched in the pool's adaptor")
    if not all(tokens.values()):
        raise AssertionError(f"3l: a session wrote no token: {[len(t) for t in tokens.values()]}")
    cmp = compare_decisions(decisions0, single["decisions"], single["threshold"])
    if not cmp["agree"]:
        raise AssertionError(f"3l: session 0 departs from 3i's incremental S2TT stream at "
                             f"decision {cmp['first_difference']} with margins "
                             f"{cmp['margins_at']} (none under {MARGIN} before it): {cmp}")
    source = POOL_SLOTS - 1 + n_chunks         # the steps while audio still arrives
    xrt = {i: (done[i] - opened[i]) / STREAM_SECONDS for i in done}
    srow = single["row"]
    work = [st for st in stages[:source] if "burst" in st]
    split = {k: statistics.median(st.get(k, 0.0) for st in work)
             for k in sorted({k for st in work for k in st})}
    stats = {"slots": POOL_SLOTS, "steps": len(step_ms), "source_steps": source,
             "step_ms": step_ms, "step_median_ms": statistics.median(step_ms[:source]),
             "step_max_ms": max(step_ms[:source]), "drain_ms": step_ms[source:],
             "stage_median_ms": split, "wall_s": wall, "xrt": xrt,
             "tokens": {i: len(t) for i, t in tokens.items()},
             "k6_launches": launches["flash_attention"], "peak_gib": peak,
             "session0_vs_single": cmp,
             "single": {"chunk_median_ms": statistics.median(srow["chunk_ms"]),
                        "chunk_max_ms": max(srow["chunk_ms"]),
                        "working_median_ms": srow["working_median_ms"],
                        "xrt": srow["xrt"], "k6_launches": srow["k6_launches"],
                        "peak_gib": srow["peak_gib"], "tokens": len(single["tokens"])}}
    log(f"3l: {POOL_SLOTS} pooled 10 s sessions one tick apart: {len(step_ms)} pool steps "
        f"({source} while audio arrives), ms a step median {stats['step_median_ms']:.1f}, "
        f"max {stats['step_max_ms']:.1f} (budget {CHUNK_MS}) = " + ", ".join(
            f"{k} {v:.1f}" for k, v in split.items())
        + f"; drain {sum(step_ms[source:]):.1f} ms in {len(step_ms) - source} steps; wall "
        f"{wall:.2f} s; xRT " + ", ".join(f"{xrt[i]:.3f}" for i in sorted(xrt))
        + f"; tokens {[len(tokens[i]) for i in sorted(tokens)]}; K6 launches "
        f"{launches['flash_attention']}; peak {peak:.2f} GiB. 3i's single incremental S2TT "
        f"stream in this run: ms a chunk median {stats['single']['chunk_median_ms']:.1f}, max "
        f"{stats['single']['chunk_max_ms']:.1f} (working median "
        f"{srow['working_median_ms']:.1f}), xRT {srow['xrt']:.3f}, {len(single['tokens'])} "
        f"tokens, K6 {srow['k6_launches']}, peak {srow['peak_gib']:.2f} GiB. Session 0 "
        f"against it: {cmp['decisions']} decisions, first margin under {MARGIN} at "
        f"{cmp['first_low_margin']}, first different outcome at {cmp['first_difference']}"
        f" (margins there {cmp['margins_at']}; smallest margins {cmp['min_margin']}); "
        f"tokens equal: {tokens[0] == single['tokens']} [{smi}]")

    # one more session through the HTTP routes
    http_pool = BatchedStreamingPool(m["unity"], m["cfg"], mono_q, m["mono_cfg"], m["text"],
                                     n_slots=POOL_SLOTS, mono_quantize_int8=False,
                                     max_len_b=20)
    wav = stream_waveform(64)[:2 * 16000]
    with fused_attention(True):
        srv = serving.serve(stream_pool=http_pool, port=0, stream_tick_ms=10)
        port = srv.server_address[1]
        try:
            t0 = time.perf_counter()
            code, out = http_json(port, "/v1/stream/open", {"tgt_lang": "eng"})
            codes, toks, polls = [code], [], 0
            sid = out["session_id"]
            n = -(-len(wav) // seg)
            for j in range(n):
                code, out = http_json(port, "/v1/stream/push", {
                    "session_id": sid, "samples": wav[j * seg:(j + 1) * seg].tolist(),
                    "finished": j == n - 1})
                codes.append(code)
                toks += [t for g in out["segments"] for t in g["tokens"]]
            while not out["finished"] and polls < 300:
                code, out = http_json(port, "/v1/stream/poll", {"session_id": sid})
                codes.append(code)
                polls += 1
                toks += [t for g in out["segments"] for t in g["tokens"]]
            code, closed = http_json(port, "/v1/stream/close", {"session_id": sid})
            codes.append(code)
            http_s = time.perf_counter() - t0
        finally:
            srv.shutdown()
            srv.stream_service.stop()
    if set(codes) != {200} or not out["finished"] or closed != {"status": "closed"}:
        raise AssertionError(f"3l: the HTTP session got {codes}, finished "
                             f"{out['finished']}, close {closed}")
    log(f"3l: one 2 s session over /v1/stream (open, {n} pushes, {polls} polls, close): "
        f"{len(codes)} responses 200, {len(toks)} tokens, finished, {http_s:.2f} s [{smi}]")
    stats.update(http={"responses": len(codes), "polls": polls, "tokens": len(toks),
                       "wall_s": http_s})
    return {"launches": launches["flash_attention"], "stats": stats}


def serving_tokenizer():
    """An NLLB tokenizer of 225 two-letter words, for the tiny serving case."""
    from seamless_communication_torch.text.nllb import NllbTokenizer
    from seamless_communication_torch.text.spm import (
        TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
    )

    base = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
            ("</s>", 0.0, TYPE_CONTROL)]
    words = ["▁" + a + b for a in "abcdefghijklmno" for b in "abcdefghijklmno"]
    return NllbTokenizer(SentencePieceModel.from_bytes(build_spm_model(
        base + [(w, -2.0, TYPE_NORMAL) for w in words])), ["__eng__", "__fra__"])


def phase_tiny_serving() -> None:
    """The tiny serving case, card against CPU, fp32. The pool on the JAX
    test's chunk-causal tiny card (``tiny_streaming_models``, its policy:
    threshold 0.001, ``max_len_b`` 12, 6 writes a call) with three sessions
    of 2, 1.5 and 1 s opening at ticks 0, 2 and 3 in four slots must write
    the CPU pool's segments, token for token. The batcher on tiny_v2 (its
    final layer-norm scale drawn at random, so that the random decoder writes
    words; int8 KV: K1 on the card) must answer three S2TT and two T2TT
    requests posted at once in two groups, with the tokens and texts of the
    CPU ``Translator.predict`` on the same groups."""
    import base64
    import threading

    import numpy as np
    import torch

    from seamless_communication_torch.inference import serving
    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.streaming.multi import BatchedStreamingPool

    m = tiny_streaming_models(torch.Generator().manual_seed(31))
    seg = int(CHUNK_MS * 16)
    tone = lambda hz, s: (0.1 * np.sin(2 * np.pi * hz * np.arange(int(s * 16000))  # noqa: E731
                                       / 16000)).astype(np.float32)
    schedule = [(0, tone(300, 2.0)), (2, tone(440, 1.5)), (3, tone(520, 1.0))]
    n_chunks = [-(-len(w) // seg) for _, w in schedule]
    got = {}
    for device in ("cuda", "cpu"):
        pool = BatchedStreamingPool(
            m["chunk_unity"], m["chunk_cfg"], m["mono"], m["mono_cfg"], m["text"],
            n_slots=POOL_SLOTS, min_starting_wait=16, decision_threshold=0.001,
            max_len_b=12, max_consecutive_writes=6, mono_quantize_int8=False, device=device)
        sids, segs = {}, {}
        for tick in range(128):
            for i, (start, w) in enumerate(schedule):
                if tick == start:
                    sids[i] = pool.open_session(tgt_lang="eng")
                j = tick - start
                if 0 <= j < n_chunks[i]:
                    pool.push(sids[i], w[j * seg:(j + 1) * seg], finished=j == n_chunks[i] - 1)
            pool.step()
            for i, sid in sids.items():
                segs.setdefault(i, [])
                segs[i] += [(g.token_indices, g.text, g.finished) for g in pool.pop(sid)]
            if len(sids) == len(schedule) and all(map(pool.session_finished, sids.values())):
                break
        else:
            raise AssertionError(f"tiny pool on {device}: the sessions did not finish")
        got[device] = segs
    if got["cuda"] != got["cpu"] or not all(got["cpu"].values()):
        raise AssertionError(f"tiny pool: the card's segments {got['cuda']} differ from the "
                             f"CPU's {got['cpu']}")
    log(f"tiny pool: {len(schedule)} staggered sessions, "
        f"{[sum(len(t) for t, _, _ in s) for s in got['cpu'].values()]} tokens, the same "
        "segments on the card and the CPU")

    cfg = get_arch("tiny_v2")
    params = unity.unity_init(torch.Generator().manual_seed(0), cfg)
    ln = params["text_decoder"]["stack"]["layer_norm"]
    ln["scale"] = torch.randn(ln["scale"].shape, generator=torch.Generator().manual_seed(5))
    tok = serving_tokenizer()
    opts = SequenceGeneratorOptions(beam_size=2, soft_max_seq_len=(0, 10),
                                    kv_cache_int8=True)
    tr = Translator(params, cfg, tok, text_opts=opts, device="cuda")
    cpu = Translator(params, cfg, tok, text_opts=opts, device="cpu")
    calls: list = []
    recording_predict(tr, calls)
    rng = np.random.default_rng(5)
    bodies = ([{"task": "s2tt", "tgt_lang": "eng", "audio_b64": base64.b64encode(
                serving._wav_bytes(rng.standard_normal(int(s * 16000)) * 0.1, 16000)).decode()}
               for s in (1.0, 2.5, 1.7)]
              + [{"task": "t2tt", "tgt_lang": "fra", "src_lang": "eng", "text": t}
                 for t in ("aa bb", "cc aa bb cc aa")])
    srv = serving.serve(tr, port=0, max_batch=len(bodies), max_wait_ms=3000)
    results = [None] * len(bodies)
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, http_json(srv.server_address[1], "/v1/translate", bodies[i])))
            for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        srv.shutdown()
        srv.batcher.close()
        del tr.predict
    if any(r is None or r[0] != 200 for r in results) or sorted(
            (c["task"], c["n"]) for c in calls) != [("s2tt", 3), ("t2tt", 2)]:
        raise AssertionError(f"tiny batcher: responses {results}, groups "
                             f"{[(c['task'], c['n']) for c in calls]}")
    # the CPU on each group in the order the batcher formed it: a response's
    # text locates its row
    for c in calls:
        rows = [r for r, b in zip(results, bodies) if b["task"] == c["task"]]
        inputs = [serving._decode_wav_b64(b["audio_b64"]) if "audio_b64" in b else b["text"]
                  for b in bodies if b["task"] == c["task"]]
        texts, _ = cpu.predict(inputs, c["task"], "eng" if c["task"] == "s2tt" else "fra",
                               src_lang=None if c["task"] == "s2tt" else "eng")
        res = cpu.generator.last_result
        for r in rows:
            if r[1]["text"] not in texts:
                raise AssertionError(f"tiny batcher: the card's {r[1]['text']!r} is not "
                                     f"among the CPU's texts {texts}")
        if not all(texts) or sorted(map(tuple, res.tokens[:, 0].tolist())) != sorted(
                map(tuple, c["tokens"].tolist())):
            raise AssertionError(f"tiny batcher {c['task']}: tokens differ between the "
                                 "card and the CPU, or a text is empty")
    log(f"tiny batcher: 5 requests in 2 groups ({[(c['task'], c['n'], c['k1']) for c in calls]}"
        " task, size, K1 launches), the CPU's tokens and texts on the card")


# ---------------------------------------------------------------------------
# phase 3j: SeamlessExpressive
# ---------------------------------------------------------------------------

EXPR_CARD, PRETSSEL_CARD = "smoke_expressivity", "smoke_pretssel"
EXPR_SECONDS = 10.0
PRETSSEL_T, PRETSSEL_VALID = 1280, 1242     # phase 2's K6 at PRETSSEL's decoder


def pretssel_flash_case(smi: str) -> dict:
    """Phase 2's K6 at PRETSSEL's FFT decoder shape: B=1, H=2, Dh=128 (the
    model's 256 over 2 heads), T = 1280 mel frames (1242 valid) under a pure
    key-padding mask, which ``try_flash`` turns into key segment ids. K6
    against its plain version in fp32 (the loaded vocoder's dtype) and
    bf16, within rtol = atol = 1e-5 and 1.6e-2; timed beside the library's
    SDPA with the segment mask as a float mask and the bound over the
    unmasked logits; the fp32 kernel's skipped key tiles counted."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from seamless_communication_torch.ops.kernels import flash_attention as fl

    dev = torch.device("cuda")
    rng = np.random.default_rng(41)
    B, H, T, Dh, valid = 1, 2, PRETSSEL_T, 128, PRETSSEL_VALID
    qkv = [torch.as_tensor(rng.standard_normal((B, H, T, Dh)), dtype=torch.float32,
                           device=dev) for _ in range(3)]
    qkv[0] = qkv[0] / Dh ** 0.5
    q_seg = torch.ones((B, T), dtype=torch.int32, device=dev)
    kv_seg = (torch.arange(T, device=dev) < valid).to(torch.int32)[None].contiguous()
    tol = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        qs, k, v = (x.to(dtype) for x in qkv)
        args = (qs, k, v, None, q_seg, kv_seg)
        got = fl.flash_attention(*args)
        ref = fl._reference(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= tol[dtype] * (1 + ref.float().abs())).all()):
            raise AssertionError(f"K6 PRETSSEL decoder {dtype}: out max err "
                                 f"{float(err.max()):.3g} over tolerance")
        mask = torch.where(q_seg[:, None, :, None] == kv_seg[:, None, None, :], 0.0,
                           fl.MASK_VALUE).to(dtype)
        k_ms = cuda_time_ms(lambda: fl.flash_attention(*args))
        p_ms = cuda_time_ms(lambda: fl._reference(*args), calls=5, reps=20)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, scale=1.0), calls=5, reps=20)
        pairs = fl.unmasked_pairs(B, H, T, T, None, q_seg, kv_seg)
        bound = fl.bound(B, H, T, T, Dh, dtype, False, True, pairs)
        skipped = int(fl.skippable_tiles_fwd(q_seg, kv_seg, T, T, None).sum())
        log(f"K6 PRETSSEL FFT decoder, B={B} H={H} Dh={Dh} T={T} ({valid} valid keys, "
            f"key segment ids), {str(dtype)[6:]}: out max abs err {float(err.max()):.3g} "
            f"(rtol=atol={tol[dtype]}); device kernel {k_ms * 1e3:.2f} us, plain "
            f"{p_ms * 1e3:.2f} us, library SDPA with the float mask {lib_ms * 1e3:.2f} us, "
            f"bound {bound[0] * 1e3:.2f} us ({bound[1]}; {pairs} unmasked logits of "
            f"{H * T * T}), {skipped} tile pairs skipped, kernel at "
            f"{k_ms / bound[0]:.1f}x its bound [{smi}]")
        out[str(dtype)[6:]] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                               "bound_ms": bound[0], "bound_by": bound[1],
                               "max_abs_err": float(err.max()), "tiles_skipped": skipped,
                               "unmasked_pairs": pairs}
    return out


def write_expressive_cards(d, unity_extra: str = "", voc_extra: str = "",
                           num_words: int = 1200) -> None:
    """The synthetic tokenizers and two cards in ``d``: ``EXPR_CARD``, the
    packaged ``seamless_expressivity`` card with ``d/unity.pt`` and these
    tokenizers (and ``unity_extra``'s fields), and ``PRETSSEL_CARD``,
    ``vocoder_pretssel`` (24 kHz) with ``d/pretssel.pt`` (and
    ``voc_extra``'s)."""
    (d / "nllb.model").write_bytes(synthetic_spm(num_words))
    (d / "char.model").write_bytes(synthetic_char_spm())
    (d / f"{EXPR_CARD}.yaml").write_text(
        f"name: {EXPR_CARD}\nbase: seamless_expressivity\ncheckpoint: {d / 'unity.pt'}\n"
        f"tokenizer: {d / 'nllb.model'}\nchar_tokenizer: {d / 'char.model'}\n"
        f"{unity_extra}")
    (d / f"{PRETSSEL_CARD}.yaml").write_text(
        f"name: {PRETSSEL_CARD}\nbase: vocoder_pretssel\ncheckpoint: {d / 'pretssel.pt'}\n"
        f"{voc_extra}")


@contextlib.contextmanager
def pretssel_launches(record: list):
    """While open, each ``PretsselGenerator.predict`` appends to ``record``
    the launches its call made (the counts' difference) and the K6 launches
    its shapes make eligible: 4 encoder layers where the units (bucketed)
    reach 128, 4 decoder layers where the mel frames do."""
    from unittest import mock

    from seamless_communication_torch.inference import pretssel_generator as pg
    from seamless_communication_torch.ops.kernels import launch_counts

    predict = pg.PretsselGenerator.predict

    def counted(self, units_batch, *a, **kw):
        before = dict(launch_counts)
        out = predict(self, units_batch, *a, **kw)
        expected = 0
        for units in units_batch:
            if units:
                u_arr, _, _, M = pg.unit_batch(units)
                expected += (self.cfg.num_encoder_layers * (u_arr.shape[1] >= 128)
                             + self.cfg.num_decoder_layers * (M >= 128))
        record.append(({k: launch_counts[k] - before[k] for k in launch_counts}, expected))
        return out

    with mock.patch.object(pg.PretsselGenerator, "predict", counted):
        yield


STREAM_EXPR_MAX_LEN = 127      # 3j's stream: its text decode cut to 127 tokens


def phase_expressive(smi: str, stream_models: Optional[dict] = None) -> dict:
    """3j. SeamlessExpressive at full width: ``expressivity_v2`` (base_v2's
    speech encoder, the tanh-GELU dense_1b decoder, the FiLM NAR T2U 4 + 4,
    the ECAPA-TDNN prosody encoder) and the 24 kHz PRETSSEL on seeded bf16
    weights, written as fp16 ``.pt`` files by the port's exporters with
    cards inheriting the packaged ones; ``cli.expressivity_predict.main``
    in-process on 10 s of seeded noise with ``SEAMLESS_FUSED_ATTN=1`` and
    int8 weights, the text decode cut to 127 steps, its loads holding every
    leaf to the file's fp16 value (the UnitY's before quantizing; PRETSSEL's
    folded weight norms rounded back to fp16). K1 launched 24 times a
    decode step, K6 inside PRETSSEL as often as its shapes make eligible,
    each counted from 0; the WAV 24 kHz, finite, within [-1, 1], 240
    samples a mel frame. PRETSSEL again with the option off: the waveform
    within 1e-3 (K6 against the plain attention through 8 FFT layers and
    the HiFi-GAN). Then one expressive streaming session in the fused mode
    (``build_expressive_s2st_pipeline``: the ``streaming`` UnitY and the
    dense_1b EMMA decoder, the loaded PRETSSEL): 10 s in 320 ms chunks, the
    text decode cut to ``STREAM_EXPR_MAX_LEN`` tokens, ms a chunk and xRT;
    and the same pipeline with ``use_vad=True`` (the VAD agent first) on 6 s
    with a 1 s silence: finished, finite segments, ms a chunk. The streaming
    models are ``stream_models``, 3i's loaded ones (``phase_streaming``'s
    ``models``), or else ``seeded_streaming_models(45)``."""
    import os

    import numpy as np
    import torch

    from seamless_communication_torch.assets import load_card
    from seamless_communication_torch.audio.wav import read_wav, write_wav
    from seamless_communication_torch.checkpoint.fairseq_export import (
        export_pretssel, export_unity,
    )
    from seamless_communication_torch.cli import expressivity_predict, loading
    from seamless_communication_torch.models.pretssel.vocoder import (
        pretssel_24khz_config, pretssel_init,
    )
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
    from seamless_communication_torch.ops.kernels import launch_counts, reset_launch_counts
    from seamless_communication_torch.streaming.pipeline import (
        build_expressive_s2st_pipeline,
    )

    dev = torch.device("cuda")
    cfg = get_arch("expressivity_v2")
    pcfg = pretssel_24khz_config()
    kw = dict(dtype=torch.bfloat16, device=dev)
    params = unity.unity_init(torch.Generator(device=dev).manual_seed(42), cfg, **kw)
    voc = pretssel_init(torch.Generator(device=dev).manual_seed(43), pcfg, **kw)
    n_unity = sum(t.numel() for t in {id(t): t for t in tensor_leaves(params)}.values())
    n_voc = sum(t.numel() for t in tensor_leaves(voc))
    # 3i's streaming models stay on the card for the stream: left out of the
    # request's peak
    resident = sum(t.numel() * t.element_size() for t in {
        id(t): t for k in ("unity", "mono")
        for t in tensor_leaves((stream_models or {}).get(k, {}))
        if isinstance(t, torch.Tensor) and t.is_cuda}.values())
    hop = pcfg.hifigan.total_upsample
    stats: dict = {"unity_params": n_unity, "pretssel_params": n_voc}
    with offline_dir() as d:
        t0 = time.perf_counter()
        torch.save({"model": export_unity(params, dtype=torch.float16)}, d / "unity.pt")
        torch.save({"model": export_pretssel(voc, pcfg, dtype=torch.float16)},
                   d / "pretssel.pt")
        export_s = time.perf_counter() - t0
        gc.collect()
        write_expressive_cards(d)
        sizes = {f: os.path.getsize(d / f) for f in ("unity.pt", "pretssel.pt")}
        log(f"3j exported expressivity_v2 ({n_unity / 1e9:.3f} B parameters) and the 24 kHz "
            f"PRETSSEL ({n_voc / 1e6:.1f} M) as fp16 .pt files in {export_s:.1f} s: "
            f"unity.pt {sizes['unity.pt'] / 2**30:.3f} GiB, pretssel.pt "
            f"{sizes['pretssel.pt'] / 2**20:.1f} MiB [{smi}]")
        stats.update(export_s=export_s, file_bytes=sizes)

        # the CLI's own loads, each leaf held as it loads; the seeded trees
        # are released after their check, and the peak is the request's
        held, seeded = {}, {"unity": params, "pretssel": voc}
        del params, voc
        quantize, load_voc = loading.quantize_params, loading.load_pretssel_vocoder

        def hold_then_quantize(tree, **qkw):
            held["unity"] = hold_leaves("unity", seeded.pop("unity"), tree,
                                        lambda w, g: torch.equal(
                                            w.to(torch.float16).to(g.dtype), g))
            return quantize(tree, **qkw)

        def hold_vocoder(*a, **vkw):
            out = load_voc(*a, **vkw)
            voc = seeded.pop("pretssel")
            want = dict(voc, gcmvn_mean=voc["gcmvn_mean"] * 0,
                        gcmvn_std=voc["gcmvn_std"] * 0 + 1)
            held["pretssel"] = hold_leaves("pretssel", want, out[0], lambda w, g: torch.equal(
                w.to(torch.float16), g.to(torch.float16)))
            del voc, want
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            return out

        wav = (np.random.default_rng(44).standard_normal(int(EXPR_SECONDS * 16000))
               * 0.1).astype(np.float32)
        write_wav(str(d / "in.wav"), wav, 16000)
        record: list = []
        loading.quantize_params, loading.load_pretssel_vocoder = hold_then_quantize, hold_vocoder
        try:
            with fused_attention(True), pretssel_launches(record):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                t0 = time.perf_counter()
                res = expressivity_predict.main([
                    str(d / "in.wav"), "--tgt_lang", "fra", "--model_name", EXPR_CARD,
                    "--vocoder_name", PRETSSEL_CARD, "--local_pt_path", str(d / "unity.pt"),
                    "--output_path", str(d / "out.wav"), "--quantize",
                    "--text_generation_max_len_a", "0", "--text_generation_max_len_b", "126"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(launch_counts)
                peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        finally:
            loading.quantize_params, loading.load_pretssel_vocoder = quantize, load_voc
        (pre_launches, pre_expected), = record
        gen = res.translator.generator.last_result
        layers = cfg.nllb.num_decoder_layers
        k1 = launches["decode_attention_int8"]
        if k1 != layers * gen.steps or launches["decode_attention_int4"]:
            raise AssertionError(f"3j: K1 launched {k1} times in {gen.steps} decode steps, "
                                 f"not {layers} a step")
        k6_pre = pre_launches["flash_attention"]
        if k6_pre != pre_expected or k6_pre <= 0:
            raise AssertionError(f"3j: K6 launched {k6_pre} times inside PRETSSEL, its "
                                 f"shapes make {pre_expected} attentions eligible")
        out, rate = read_wav(str(d / "out.wav"))
        frames = res.generator.last_mel_frames[0]
        if (rate != 24000 or not len(out) or len(res.waveform) != frames * hop
                or not np.isfinite(res.waveform).all() or np.abs(res.waveform).max() > 1.0):
            raise AssertionError(f"3j: the WAV ({rate} Hz, {len(out)} samples, {frames} mel "
                                 "frames) is empty, not finite, outside [-1, 1] or not "
                                 f"{hop} samples a frame")
        check_hypotheses(gen, res.translator.text_tokenizer.target_prefix("fra").tolist(),
                         gen.tokens.shape[-1], cfg.nllb.eos_idx)
        request = {k: v * 1e3 for k, v in res.translator.last_timings.items()}
        request.update({k: v * 1e3 for k, v in res.generator.last_timings.items()})
        mc = load_card(PRETSSEL_CARD)["model_config"]
        stats_g = mc["gcmvn_stats"]
        from seamless_communication_torch.audio.fbank import fbank_numpy
        fbank = fbank_numpy(wav)
        gcmvn = ((fbank - np.asarray(stats_g["mean"])[None])
                 / np.asarray(stats_g["std"])[None]).astype(np.float32)
        with fused_attention(False):
            plain = res.generator.predict(res.units, "fra", gcmvn[None],
                                          np.array([gcmvn.shape[0]]))[0]
        wav_err = float(np.abs(plain - res.waveform).max())
        if plain.shape != res.waveform.shape or wav_err > 1e-3:
            raise AssertionError(f"3j: PRETSSEL with the fused option and without differs "
                                 f"by {wav_err:.3g}")
        log(f"3j expressivity_predict S2ST 10 s, fused, int8: wall {wall:.2f} s (loading "
            f"included: " + ", ".join(f"{k} {v:.2f}" for k, v in res.load_timings.items())
            + " s); request " + ", ".join(f"{k} {v:.1f}" for k, v in request.items())
            + f" ms, {request['text_decode'] / gen.steps:.2f} ms a decode step; {gen.steps} "
            f"decode steps, K1 launches {k1}, K6 launches {launches['flash_attention']} "
            f"({k6_pre} inside PRETSSEL); {len(res.units[0])} units, {frames} mel frames, "
            f"{len(res.waveform) / 24000:.2f} s of 24 kHz audio; peak from the loaded "
            f"trees on {peak:.2f} GiB (3i's streaming models, {resident / 2**30:.2f} GiB, "
            f"left out); "
            f"{held['unity']} UnitY and {held['pretssel']} PRETSSEL leaves equal the "
            f"files' fp16 values; PRETSSEL with the option off: waveform max abs "
            f"difference {wav_err:.3g}; text {res.texts[0][:40]!r} [{smi}]")
        stats.update(predict_wall_s=wall, load_stages_s=res.load_timings,
                     request_stages_ms=request, steps=gen.steps, k1_launches=k1,
                     k6_launches=launches["flash_attention"], k6_pretssel=k6_pre,
                     units=len(res.units[0]), mel_frames=frames,
                     audio_s=len(res.waveform) / 24000, peak_gib=peak, held_leaves=held,
                     fused_vs_plain_wav_err=wav_err)
        pretssel_tree = res.generator.params
        gcmvn_mean, gcmvn_std = stats_g["mean"], stats_g["std"]
        langs = {lang: i for i, lang in enumerate(mc["langs"])}
        del res
        gc.collect()

    # one expressive streaming session, fused
    stream_unity, scfg, mono, mono_cfg, text_tok, char_tok = (
        (stream_models or seeded_streaming_models(45))[k]
        for k in ("unity", "cfg", "mono", "mono_cfg", "text", "char"))
    unit_tok = UnitTokenizer(10000, ["eng", "fra"], "streaming")
    swav = (np.random.default_rng(47).standard_normal(int(STREAM_SECONDS * 16000))
            * 0.1).astype(np.float32)
    with fused_attention(True):
        pipe = build_expressive_s2st_pipeline(
            stream_unity, scfg, mono, mono_cfg, text_tok, unit_tok, char_tok,
            pretssel_tree, pcfg, langs, gcmvn_mean, gcmvn_std, sample_rate=24000,
            tgt_lang="fra", fused=True)
        text_decoder_agent(pipe).max_len_a = 0
        text_decoder_agent(pipe).max_len_b = STREAM_EXPR_MAX_LEN
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        outs, times, stages, swall = stream_timed(pipe, swav, tgt_lang="fra")
        slaunches = dict(launch_counts)
    speak = torch.cuda.max_memory_allocated() / 2**30
    n_source = -(-len(swav) // int(CHUNK_MS * 16))
    wavs = [np.asarray(s.content) for _, s in outs
            if type(s).__name__ == "SpeechSegment" and not s.is_empty]
    samples = sum(w.size for w in wavs)
    if not outs or not outs[-1][1].finished or samples == 0 or samples % hop:
        raise AssertionError(f"3j streaming: the stream did not finish or gave {samples} "
                             f"samples, not a positive multiple of {hop}")
    for w in wavs:
        if not np.isfinite(w).all() or np.abs(w).max() > 1.0:
            raise AssertionError("3j streaming: a waveform chunk is not finite or outside "
                                 "[-1, 1]")
    if slaunches["flash_attention"] <= 0:
        raise AssertionError("3j streaming: K6 never launched with the fused option on")
    src = times[:n_source]
    pretssel_ms = sum(st.get("vocoder", 0.0) for st in stages)
    dec = text_decoder_agent(pipe)
    log(f"3j expressive streaming S2ST fused, 10 s: {len(times)} process calls "
        f"({n_source} source chunks, {len(times) - n_source} drain calls); ms a 320 ms "
        f"chunk median {statistics.median(src):.1f}, max {max(src):.1f}; drain "
        f"{sum(times[n_source:]):.1f} ms; PRETSSEL {pretssel_ms:.1f} ms in {len(wavs)} "
        f"segments; wall {swall:.2f} s, xRT {swall / STREAM_SECONDS:.3f}; "
        f"{dec.policy_counts['tokens']} tokens, {samples // hop} mel frames, "
        f"{samples / 24000:.2f} s of 24 kHz audio; K6 launches "
        f"{slaunches['flash_attention']}; peak {speak:.2f} GiB [{smi}]")
    stats["streaming"] = {"calls": len(times), "source_chunks": n_source,
                          "chunk_ms": src, "median_ms": statistics.median(src),
                          "max_ms": max(src), "drain_ms": times[n_source:],
                          "pretssel_ms": pretssel_ms, "segments": len(wavs),
                          "wall_s": swall, "xrt": swall / STREAM_SECONDS,
                          "tokens": dec.policy_counts["tokens"], "mel_frames": samples // hop,
                          "audio_s": samples / 24000,
                          "k6_launches": slaunches["flash_attention"], "peak_gib": speak}
    del pipe, dec
    gc.collect()

    # the same models behind the VAD agent: 6 s with a 1 s silence
    vwav = (np.random.default_rng(48).standard_normal(6 * 16000) * 0.1).astype(np.float32)
    vwav[3 * 16000:4 * 16000] = 0.0
    with fused_attention(True):
        pipe = build_expressive_s2st_pipeline(
            stream_unity, scfg, mono, mono_cfg, text_tok, unit_tok, char_tok,
            pretssel_tree, pcfg, langs, gcmvn_mean, gcmvn_std, sample_rate=24000,
            tgt_lang="fra", fused=True, use_vad=True)
        text_decoder_agent(pipe).max_len_a = 0
        text_decoder_agent(pipe).max_len_b = STREAM_EXPR_MAX_LEN
        if type(pipe.agents[0]).__name__ != "VADAgent":
            raise AssertionError("3j VAD: the pipeline does not start with the VAD agent")
        torch.cuda.synchronize()
        reset_launch_counts()
        vouts, vtimes, _, vwall = stream_timed(pipe, vwav, tgt_lang="fra")
        vlaunches = dict(launch_counts)
    vwavs = [np.asarray(s.content) for _, s in vouts
             if type(s).__name__ == "SpeechSegment" and not s.is_empty]
    vsamples = sum(w.size for w in vwavs)
    if not vouts or not vouts[-1][1].finished or vsamples % hop or not all(
            np.isfinite(w).all() and np.abs(w).max() <= 1.0 for w in vwavs):
        raise AssertionError(f"3j VAD: the stream did not finish, or gave {vsamples} "
                             f"samples (not a multiple of {hop}) or a chunk not finite or "
                             "outside [-1, 1]")
    n_vsource = -(-len(vwav) // int(CHUNK_MS * 16))
    vdec = text_decoder_agent(pipe)
    log(f"3j expressive streaming S2ST fused with use_vad=True, 6 s with a 1 s silence: "
        f"{len(vtimes)} process calls; ms a 320 ms chunk median "
        f"{statistics.median(vtimes[:n_vsource]):.1f}, max {max(vtimes[:n_vsource]):.1f}; "
        f"wall {vwall:.2f} s, xRT {vwall / 6:.3f}; {vdec.policy_counts['tokens']} tokens, "
        f"{len(vwavs)} speech segments, {vsamples / 24000:.2f} s of 24 kHz audio; K6 "
        f"launches {vlaunches['flash_attention']} [{smi}]")
    stats["streaming_vad"] = {"calls": len(vtimes), "chunk_ms": vtimes[:n_vsource],
                              "wall_s": vwall, "xrt": vwall / 6,
                              "tokens": vdec.policy_counts["tokens"],
                              "segments": len(vwavs), "audio_s": vsamples / 24000,
                              "k6_launches": vlaunches["flash_attention"]}
    del pipe, vdec, stream_unity, mono, pretssel_tree
    gc.collect()
    return {"launches": {"decode_attention_int8": k1,
                         "flash_attention": launches["flash_attention"]
                         + slaunches["flash_attention"] + vlaunches["flash_attention"]},
            "stats": stats}


def seeded_streaming_models(seed: int) -> dict:
    """The ``streaming`` UnitY (no text decoder) and the dense_1b EMMA
    decoder drawn in bf16 on the card from ``seed`` and ``seed + 1``, with the
    synthetic tokenizers: ``phase_streaming``'s ``models`` without the
    ``.pt`` files."""
    import torch

    from seamless_communication_torch.models.monotonic.model import (
        MonotonicDecoderConfig, monotonic_decoder_init,
    )
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch

    dev = torch.device("cuda")
    kw = dict(dtype=torch.bfloat16, device=dev)
    cfg = get_arch("streaming")
    params = unity.unity_init(torch.Generator(device=dev).manual_seed(seed), cfg, **kw)
    del params["text_decoder"]
    mono_cfg = MonotonicDecoderConfig()
    mono = monotonic_decoder_init(torch.Generator(device=dev).manual_seed(seed + 1),
                                  mono_cfg, **kw)
    return {"unity": params, "cfg": cfg, "mono": mono, "mono_cfg": mono_cfg,
            "text": synthetic_tokenizer(), "char": synthetic_char_tokenizer()}


# the tiny PRETSSEL of tests/test_torch_pretssel.py
TINY_PRETSSEL = dict(num_units=112, model_dim=32, num_heads=2, ffn_inner_dim=64,
                     conv_kernel_size=5, num_encoder_layers=2, num_decoder_layers=2,
                     num_langs=4, lang_embed_dim=8, prosody_dim=16, pn_conv_dim=16,
                     pn_layers=2, pn_kernel_size=5, var_pred_hidden=16)


def tiny_pretssel(gen):
    from seamless_communication_torch.models.pretssel.ecapa_tdnn import EcapaConfig
    from seamless_communication_torch.models.pretssel.streamable import SeanetConfig
    from seamless_communication_torch.models.pretssel.vocoder import (
        PretsselConfig, pretssel_init,
    )
    from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig

    cfg = PretsselConfig(
        **TINY_PRETSSEL,
        hifigan=HifiGanConfig(model_in_dim=80, upsample_initial_channel=32,
                              upsample_rates=(5, 3), upsample_kernel_sizes=(10, 6),
                              resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
                              add_ups_out_pad=True, final_tanh=False),
        seanet=SeanetConfig(dimension=16, n_filters=4, ratios=(5, 2), lstm=2),
        ecapa=EcapaConfig(channels=(16, 16, 16, 16, 32), attention_channels=8,
                          res2net_scale=4, se_channels=8, embed_dim=16))
    return pretssel_init(gen, cfg), cfg


def phase_tiny_expressive() -> None:
    """``tiny_expressive`` and the tiny PRETSSEL, fp32, on the card and on the
    CPU with ``SEAMLESS_FUSED_ATTN=1``: a 3 s S2ST through the Translator
    with the prosody input (int8 KV, the decode cut to 17 steps) and
    ``PretsselGenerator``, then the expressive streaming pipeline (the tiny
    streaming models, fused) on a 2 s tone. The same tokens, units and
    segments; waveforms within 1e-4; on the card K1 and K6 launched (K6 in
    PRETSSEL's attentions of 128 or more positions)."""
    import numpy as np
    import torch

    from seamless_communication_torch.audio.fbank import fbank_numpy
    from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
    from seamless_communication_torch.inference.pretssel_generator import PretsselGenerator
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
    from seamless_communication_torch.ops.kernels import launch_counts, reset_launch_counts
    from seamless_communication_torch.streaming.pipeline import (
        build_expressive_s2st_pipeline,
    )

    gen = torch.Generator().manual_seed(51)
    cfg = get_arch("tiny_expressive")
    params = unity.unity_init(gen, cfg)
    voc, vcfg = tiny_pretssel(gen)
    m = tiny_streaming_models(gen)
    rng = np.random.default_rng(52)
    wav = (rng.standard_normal(3 * 16000) * 0.1).astype(np.float32)
    fb = fbank_numpy(wav)
    gcmvn = ((fb - fb.mean(0)) / (fb.std(0) + 1e-5)).astype(np.float32)
    mean, std = np.full(80, 8.0, np.float32), np.full(80, 4.0, np.float32)
    opts = SequenceGeneratorOptions(soft_max_seq_len=(0, 16), kv_cache_int8=True)
    tone = (0.1 * np.sin(2 * np.pi * 300 * np.arange(32000) / 16000)).astype(np.float32)
    got = {}
    with fused_attention(True):
        for device in ("cuda", "cpu"):
            reset_launch_counts()
            tr = Translator(params, cfg, m["text"], UnitTokenizer(100, ["eng", "fra"],
                                                                  "tiny_expressive"),
                            m["char"], text_opts=opts, device=device)
            texts, speech = tr.predict(wav, "s2st", "eng", prosody_encoder_input=gcmvn)
            pg = PretsselGenerator(voc, vcfg, lang_to_index={"eng": 0}, device=device)
            wavs = pg.predict(speech.units, "eng", gcmvn[None], np.array([len(gcmvn)]))
            offline = dict(launch_counts)
            pipe = build_expressive_s2st_pipeline(
                m["unity"], m["cfg"], m["mono"], m["mono_cfg"], m["text"], m["units"],
                m["char"], voc, vcfg, {"eng": 0}, mean, std, tgt_lang="eng",
                min_starting_wait_w2vbert=16, decision_threshold=0.001,
                min_unit_chunk_size=5, fused=True, device=device)
            text_decoder_agent(pipe).max_len_b = 10
            text_decoder_agent(pipe).max_consecutive_writes = 5
            outs = stream_timed(pipe, tone)[0]
            segs = [(i, type(s).__name__, s.content, bool(s.finished)) for i, s in outs]
            got[device] = (texts, tr.generator.last_result.tokens[:, 0].cpu(), speech.units,
                           wavs, list(text_decoder_agent(pipe).states.target_indices), segs,
                           offline)
    (tc, kc, uc, wc, sc_tok, sc, lc), (tp, kp, up, wp, sp_tok, sp, _) = got["cuda"], got["cpu"]
    if tc != tp or not torch.equal(kc, kp) or uc != up or not uc[0]:
        raise AssertionError(f"tiny expressive S2ST: the card and the CPU differ (texts "
                             f"{tc == tp}, units {uc == up})")
    err = max(float(np.abs(a - b).max(initial=0.0)) for a, b in zip(wc, wp))
    if [a.shape for a in wc] != [b.shape for b in wp] or err > 1e-4:
        raise AssertionError(f"tiny expressive PRETSSEL: waveforms differ by {err:.3g}")
    if lc["decode_attention_int8"] <= 0 or lc["flash_attention"] <= 0:
        raise AssertionError(f"tiny expressive on the card: K1 {lc['decode_attention_int8']}"
                             f", K6 {lc['flash_attention']} launches")
    if sc_tok != sp_tok or [(i, k, f) for i, k, _, f in sc] != [(i, k, f) for i, k, _, f in sp]:
        raise AssertionError("tiny expressive streaming: tokens or segments differ between "
                             "the card and the CPU")
    serr = 0.0
    for (_, kind, a, _), (_, _, b, _) in zip(sc, sp):
        if kind == "SpeechSegment":
            a, b = np.asarray(a), np.asarray(b)
            if a.shape != b.shape:
                raise AssertionError(f"tiny expressive streaming: waveform shapes {a.shape}, "
                                     f"{b.shape}")
            serr = max(serr, float(np.abs(a - b).max(initial=0.0)))
        elif not (a is None and b is None) and str(a) != str(b):
            raise AssertionError(f"tiny expressive streaming: segment {a!r} on the card, "
                                 f"{b!r} on the CPU")
    if serr > 1e-4:
        raise AssertionError(f"tiny expressive streaming: waveforms differ by {serr:.3g}")
    log(f"tiny_expressive + tiny PRETSSEL, fused: S2ST text, tokens and {len(uc[0])} units "
        f"identical on the card and the CPU, waveform max abs difference {err:.3g} (K1 "
        f"{lc['decode_attention_int8']}, K6 {lc['flash_attention']} launches on the card); "
        f"expressive streaming: {len(sc_tok)} tokens and {len(sc)} segments identical, "
        f"waveform max abs difference {serr:.3g}")


# ---------------------------------------------------------------------------
# phase 3g: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "base_v2"
TRAIN_DEVICE = "cuda"
TRAIN_FRAMES = (1000, 700)       # 10 s and 7 s of fbank frames: 500 conformer frames
TRAIN_TOKENS = (160, 120)        # target lengths; the batch is padded to 160


def train_batch(cfg, seed: int, *, frames=None, tokens=None, s2s: bool = False) -> dict:
    """A synthetic S2T batch of numpy arrays: seeded fbank of ``frames``
    frames, target tokens of ``tokens`` lengths (padded with the pad id), the
    previous tokens the language-token-shifted targets. ``s2s`` adds the NAR
    T2U's inputs: 2-5 chars a token, ground-truth durations of 1-3 units a
    char, random target units padded to the longest total."""
    import numpy as np

    frames, tokens = frames or TRAIN_FRAMES, tokens or TRAIN_TOKENS
    rng = np.random.default_rng(seed)
    B, T, L = len(frames), max(frames), max(tokens)
    V = cfg.nllb.vocab_size
    fbank = rng.standard_normal((B, T, 80)).astype(np.float32)
    target = rng.integers(4, V, (B, L)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), cfg.nllb.eos_idx, np.int32), target[:, :-1]], 1)
    for b, n in enumerate(tokens):
        target[b, n:] = cfg.nllb.pad_idx
        prev[b, n:] = cfg.nllb.pad_idx
    batch = {"fbank": fbank, "fbank_lens": np.array(frames, np.int32),
             "prev_tokens": prev, "target_tokens": target,
             "target_lens": np.array(tokens, np.int32)}
    if s2s:
        tc = cfg.nar_t2u
        counts = np.zeros((B, L), np.int32)
        for b, n in enumerate(tokens):
            counts[b, :n] = rng.integers(2, 6, n)
        C = int(counts.sum(1).max())
        durs = np.zeros((B, C), np.int32)
        for b in range(B):
            durs[b, :counts[b].sum()] = rng.integers(1, 4, counts[b].sum())
        U = int(durs.sum(1).max())
        units = rng.integers(4, tc.unit_vocab_size, (B, U)).astype(np.int32)
        for b in range(B):
            units[b, durs[b].sum():] = tc.pad_idx
        batch.update(char_ids=rng.integers(4, tc.char_vocab_size, (B, C)).astype(np.int32),
                     char_counts=counts, target_durations=durs, target_units=units)
    return batch


def k6_train_expected(cfg, batch: dict, s2s: bool) -> dict:
    """K6 launches of one train step's forward with the fused option on
    (K6b and K6c launch as often in its backward), counted from the batch's
    shapes: eligible where both lengths are at least 128. The adaptor's
    attention and the decoder's cross-attention see the adaptor's ~T/8
    keys."""
    ok = lambda *lens: int(all(n >= 128 for n in lens))
    frames = batch["fbank"].shape[1] // cfg.speech.fbank_stride
    k, s = cfg.speech.adaptor_kernel_size, cfg.speech.adaptor_stride
    enc_len = frames
    adaptor = 0
    for _ in range(cfg.speech.adaptor_layers):
        enc_len = (enc_len + 2 * (s // 2) - k) // s + 1
        adaptor += ok(enc_len)
    L = batch["prev_tokens"].shape[1]
    n_dec = cfg.nllb.num_decoder_layers
    parts = {"conformer": cfg.speech.conformer.num_layers * ok(frames),
             "adaptor": adaptor,
             "decoder": n_dec * ok(L) + n_dec * ok(L, enc_len)}
    if s2s:
        tc = cfg.nar_t2u
        parts["t2u encoder"] = tc.num_encoder_layers * ok(L)
        parts["t2u fft"] = tc.num_decoder_layers * ok(batch["target_units"].shape[1])
    return parts


def train_steps(trainer, batch: dict, n: int, label: str, smi: str, *,
                expect: dict, first: int = 1) -> list:
    """``n`` steps of ``trainer`` on ``batch``, numbered from ``first``: each
    step's wall (ending in a
    synchronize), its loss, the target tokens a second and the peak device
    memory of the step; the launches of K6, K6b and K6c in each step must
    equal ``expect``."""
    import torch

    from seamless_communication_torch.ops.kernels import launch_counts

    names = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    rows = []
    for i in range(first, first + n):
        before = dict(launch_counts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = trainer.step(batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: launch_counts[k] - before[k] for k in names}
        if got != expect:
            raise AssertionError(f"{label} step {i}: launches {got}, expected {expect}")
        if not math.isfinite(loss):
            raise AssertionError(f"{label} step {i}: loss {loss}")
        tokens = float(m["n_tokens"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"{label} step {i}: loss {loss:.5f}, grad norm {m['grad_norm']:.4g}, wall "
            f"{wall * 1e3:.1f} ms, {tokens:.0f} loss tokens, {tokens / wall:.1f} tokens/s, "
            f"peak {peak:.2f} GiB; K6 {got['flash_attention']}, K6b "
            f"{got['flash_attention_bwd_dkv']}, K6c {got['flash_attention_bwd_dq']} "
            f"[{smi}]")
        rows.append({"step": i, "loss": loss, "wall_ms": wall * 1e3,
                     "tokens": tokens, "tokens_per_s": tokens / wall, "peak_gib": peak,
                     "launches": got})
    return rows


def profile_train_step(trainer, batch: dict, smi: str) -> dict:
    """One more train step under ``torch.profiler``: the kernels' busy time
    and share of the step's wall, the device time of K6, K6b and K6c (the
    ``flash_attention*`` kernels) within it, and the kernels that take most
    of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a user annotation's range (AdamW's step) spans kernels
    # that are counted on their own
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    # each kernel by its name: the SIMT kernel (fp32; K6c) or the
    # tensor-core one (bf16 K6, K6b)
    flash = {name: sum(e.self_device_time_total for e in events
                       if f"{name}_kernel" in e.key or f"{name}_tc_kernel" in e.key) / 1e3
             for name in ("flash_attention", "flash_attention_bwd_dkv",
                          "flash_attention_bwd_dq")}
    flash_ms = sum(flash.values())
    log(f"3g profile of one S2T step [{smi}]: wall {wall_ms:.1f} ms under the profiler, "
        f"kernels busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f} % of the wall, "
        f"{sum(e.count for e in events)} kernel launches; K6 {flash['flash_attention']:.2f}"
        f" ms, K6b {flash['flash_attention_bwd_dkv']:.2f} ms, K6c "
        f"{flash['flash_attention_bwd_dq']:.2f} ms, together {flash_ms:.2f} ms = "
        f"{100 * flash_ms / busy_ms:.1f} % of the kernels' time; top kernels:")
    top = []
    for e in events[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d} x  {e.key[:90]}")
        top.append((e.key[:90], e.self_device_time_total / 1e3, e.count))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "flash_ms": flash, "top": top}


def fwd_bwd_peak(params: dict, cfg, batch: dict, dev, policy) -> float:
    """GiB allocated above the parameters at the peak of one S2T loss and
    its backward (no optimizer step) on a fresh copy of ``params``, under
    ``remat_layers(policy)`` or without remat (None): what remat trades."""
    import contextlib

    import torch

    from seamless_communication_torch.ops.remat import remat_layers
    from seamless_communication_torch.train.trainer import (
        batch_to, s2t_loss, trainable_copy,
    )

    p = trainable_copy(params, dev)
    b = batch_to(batch, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with remat_layers(policy) if policy else contextlib.nullcontext():
        loss, n = s2t_loss(p, cfg, b)
        (loss / n).backward()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    del p, loss
    return peak


@contextlib.contextmanager
def flash_versions(forward: str, backward: str, record: Optional[list] = None):
    """Within the block, CUDA tensors take K6 (``forward="kernel"``) or its
    plain version ``_reference_fwd`` (``"plain"``; ``"plain, out +-1 ulp"``:
    its ``out`` then scaled by 1 + 2^-23 * u, u uniform in [-1, 1] from a
    seeded generator, a rounding of about one ulp), and K6b + K6c
    (``backward="kernel"``) or their plain version ``_reference_bwd``: the
    library's contract in PyTorch. With ``record``, every backward call's
    inputs and (dq, dk, dv) are appended to it."""
    import torch

    from seamless_communication_torch.ops.kernels import flash_attention as fl

    saved = fl._forward, fl.flash_attention_bwd
    gen = None

    def fwd(qs, k, v, ab, q_seg, kv_seg, residuals):
        nonlocal gen
        out, m, l = fl._reference_fwd(qs, k, v, ab, q_seg, kv_seg)
        if forward == "plain, out +-1 ulp":
            if gen is None:
                gen = torch.Generator(device=out.device).manual_seed(11)
            u = torch.rand(out.shape, generator=gen, device=out.device) * 2 - 1
            out = out * (1 + 2.0 ** -23 * u)
        return (out, m, l) if residuals else (out, None, None)

    def plain_bwd(qs, k, v, ab, q_seg, kv_seg, o, m, l, do, need_dab=True):
        dq, dk, dv, dab = fl._reference_bwd(qs, k, v, ab, q_seg, kv_seg, o, m, l, do)
        return dq, dk, dv, dab if need_dab else None

    inner = saved[1] if backward == "kernel" else plain_bwd

    def bwd(*args, need_dab=True):
        grads = inner(*args, need_dab=need_dab)
        if record is not None:
            record.append(([None if x is None else x.detach().clone() for x in args],
                           [g.detach().clone() for g in grads[:3]]))
        return grads

    if forward != "kernel":
        fl._forward = fwd
    fl.flash_attention_bwd = bwd
    try:
        yield
    finally:
        fl._forward, fl.flash_attention_bwd = saved


def attention_grads(qs, k, v, ab, q_seg, kv_seg, do, dtype) -> tuple:
    """dq, dk, dv of ``softmax(qs k^T + ab + segmask) v`` for ``do``, by
    autograd of the plain attention in ``dtype``."""
    import torch

    from seamless_communication_torch.ops.kernels import flash_attention as fl

    qs, k, v = (x.detach().to(dtype).requires_grad_() for x in (qs, k, v))
    s = qs @ k.transpose(-1, -2)
    if ab is not None:
        s = s + ab.to(dtype)
    if q_seg is not None:
        s = torch.where(q_seg[:, None, :, None] == kv_seg[:, None, None, :], s,
                        torch.tensor(fl.MASK_VALUE, dtype=dtype, device=s.device))
    return torch.autograd.grad(torch.softmax(s, -1) @ v, (qs, k, v), do.to(dtype))


def grad_parity(cfg, dev, smi: str, s2s: bool = False) -> dict:
    """Gradient parity at full width, depth cut to 4 conformer and 4 decoder
    layers (no text encoder, which no loss reaches), fp32, TF32 off. S2T:
    ``s2t_loss``, no T2U. ``s2s``: the v2 ``s2st_loss`` with the whole NAR
    T2U (6 encoder layers at L = 160, 6 FFT layers on the segment-id path at
    U >= 1000), so the unit NLL and the duration MSE are held too.

    One loss and backward in five ways, the fused option on unless said:
    "kernels" (K6, K6b, K6c, launched as ``k6_train_expected`` counts); "K6,
    plain backward" (K6, then ``_reference_bwd``); "plain versions"
    (``_reference_fwd``, ``_reference_bwd``: the library's contract in
    PyTorch); "plain, out +-1 ulp" (the same with each attention's output
    rounded otherwise by about one ulp, ``flash_versions``); "off" (the
    plain attention). The losses within 1e-5 relative. Every gradient leaf
    (``||dg|| / ||g||``) within 1e-4 between "kernels" and "K6, plain
    backward" (K6b and K6c on the same residuals) and between "plain
    versions" and "off" (the contract against the plain attention), and
    between "kernels" and "off" (the fused path) except where the gradient
    is that sensitive to rounding: there K6's residuals ("K6, plain
    backward" against "plain versions") may move the leaf at most 10 times
    as far as the one-ulp rounding of the attention's output does ("plain,
    out +-1 ulp" against "plain versions"): K6's ``out`` differs from its
    plain version's by rounding (phase 2), so a leaf that K6 moves past 1e-4
    must be as sensitive to the plain attention's own rounding. Such leaves
    are counted and the worst shown. Each attention's ``k_proj`` bias, whose
    exact gradient is 0 (a bias on the keys adds the same logit to a whole softmax
    row), is held to 1e-4 of the norm of the same projection's weight
    gradient. Each attention's dq, dk and dv from the kernels, on K6's
    residuals, must be within 1e-5 of the norm of the fp64 autograd of the
    plain attention on the same inputs; the fp32 plain attention's own error
    is shown beside."""
    import dataclasses

    import torch

    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.ops.kernels import launch_counts
    from seamless_communication_torch.train.trainer import (
        batch_to, named_leaves, s2st_loss, s2t_loss, trainable_copy,
    )

    label = "S2S (v2, NAR T2U)" if s2s else "S2T"
    conf = cfg.speech.conformer._replace(num_layers=4)
    cut = dataclasses.replace(cfg, speech=cfg.speech._replace(conformer=conf),
                              nllb=cfg.nllb._replace(num_decoder_layers=4),
                              nar_t2u=cfg.nar_t2u if s2s else None,
                              use_text_encoder=False)
    params = unity.unity_init(torch.Generator(device=dev).manual_seed(5), cut,
                              dtype=torch.float32, device=dev)
    np_batch = train_batch(cut, 32 if s2s else 31, s2s=s2s)
    batch = batch_to(np_batch, dev)
    loss_fn = s2st_loss if s2s else s2t_loss
    names = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    want = sum(k6_train_expected(cut, np_batch, s2s=s2s).values())
    calls: list = []
    ulp = "plain, out +-1 ulp"
    ways = {"kernels": (True, flash_versions("kernel", "kernel", calls), (want,) * 3),
            "K6, plain backward": (True, flash_versions("kernel", "plain"), (want, 0, 0)),
            "plain versions": (True, flash_versions("plain", "plain"), (0, 0, 0)),
            ulp: (True, flash_versions(ulp, "plain"), (0, 0, 0)),
            "off": (False, contextlib.nullcontext(), (0, 0, 0))}
    grads, losses = {}, {}
    for way, (on, ctx, launches) in ways.items():
        p = trainable_copy(params, dev)
        before = dict(launch_counts)
        with fused_attention(on), ctx:
            loss, n = loss_fn(p, cut, batch)
            loss = loss / n
            leaves = list(named_leaves(p))
            gs = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True)
        got = tuple(launch_counts[k] - before[k] for k in names)
        if got != launches:
            raise AssertionError(f"3g {label} parity, {way}: launches of K6, K6b, K6c "
                                 f"{got}, expected {launches}")
        losses[way] = float(loss.detach())
        grads[way] = {path: torch.zeros_like(t) if g is None else g
                      for (path, t), g in zip(leaves, gs)}
        del p
    rel = max(abs(losses[w] - losses["off"]) / abs(losses["off"]) for w in ways)
    if rel > 1e-5:
        raise AssertionError(f"3g {label} parity: losses {losses} differ by {rel:.3g} "
                             f"relative")

    def off_by(way: str, ref_way: str, path) -> float:
        ref = grads[ref_way][path]
        if path[-2:] == ("k_proj", "bias"):
            ref = grads[ref_way][path[:-1] + ("weight",)]
        d = grads[way][path] - grads[ref_way][path]
        return float(d.norm()) / max(float(ref.norm()), 1e-30)

    pairs = {"K6b, K6c": ("kernels", "K6, plain backward"),
             "contract": ("plain versions", "off"),
             "K6 residuals": ("K6, plain backward", "plain versions"),
             "rounding": (ulp, "plain versions"),
             "fused": ("kernels", "off")}
    worst = dict.fromkeys(pairs, (-1.0, ""))
    departs, ratio = [], (0.0, "")
    for path in grads["off"]:
        name = "/".join(path)
        d = {what: off_by(*ways_, path) for what, ways_ in pairs.items()}
        for what in ("K6b, K6c", "contract"):
            if d[what] > 1e-4:
                raise AssertionError(f"3g {label} parity: gradient {name} off by "
                                     f"{d[what]:.3g} of its norm between "
                                     f"{' and '.join(pairs[what])}")
        if d["fused"] > 1e-4:
            if not d["K6 residuals"] <= 10 * d["rounding"]:
                raise AssertionError(f"3g {label} parity: gradient {name} off by "
                                     f"{d['fused']:.3g} of its norm with the option on; "
                                     f"K6's residuals move it {d['K6 residuals']:.3g}, "
                                     f"one ulp of the attention's output {d['rounding']:.3g}")
            departs.append((d["fused"], name, d["K6 residuals"], d["rounding"]))
            ratio = max(ratio, (d["K6 residuals"] / d["rounding"], name))
        for what in pairs:
            worst[what] = max(worst[what], (d[what], name))
    errs = {"kernels": 0.0, "plain fp32": 0.0}
    for args, kern in calls:
        qs, k, v, ab, q_seg, kv_seg, o, m, l, do = args
        truth = attention_grads(qs, k, v, ab, q_seg, kv_seg, do, torch.float64)
        plain = attention_grads(qs, k, v, ab, q_seg, kv_seg, do, torch.float32)
        for got, fp32, t in zip(kern, plain, truth):
            e = float((got.double() - t).norm() / t.norm())
            if e > 1e-5:
                raise AssertionError(f"3g {label} parity: an attention's gradient from the "
                                     f"kernels off by {e:.3g} of the fp64 truth's norm")
            errs["kernels"] = max(errs["kernels"], e)
            errs["plain fp32"] = max(errs["plain fp32"], float((fp32.double() - t).norm()
                                                                / t.norm()))
    del calls
    log(f"3g {label} gradient parity (4 conformer + 4 decoder layers at full width"
        f"{', the whole T2U' if s2s else ''}, fp32, TF32 off; {want} launches each of K6, "
        f"K6b, K6c): losses " + ", ".join(f"{w} {x:.7f}" for w, x in losses.items())
        + f" ({rel:.2g} relative); {len(grads['off'])} gradient leaves, largest "
        f"||dg|| / ||g||: " + ", ".join(f"{what} ({' against '.join(pairs[what])}) "
                                        f"{worst[what][0]:.3g} ({worst[what][1]})"
                                        for what in pairs)
        + f"; the fused path over 1e-4 on {len(departs)} leaves, K6's residuals at most "
        f"{ratio[0]:.3g} times the one-ulp rounding's ({ratio[1]}); the worst: "
        + ", ".join(f"{n} {f:.3g} (K6's residuals {k:.3g}, one ulp {r:.3g})"
                    for f, n, k, r in sorted(departs, reverse=True)[:4])
        + f"; each attention's dq, dk, dv against the "
        f"fp64 plain attention: kernels within {errs['kernels']:.3g}, the fp32 plain "
        f"attention {errs['plain fp32']:.3g} of the norm [{smi}]")
    return {"losses": losses, "loss_rel": rel, "worst": worst, "departs": len(departs),
            "ratio": ratio, "fp64": errs, "launches": want}


def s2s_loss_parts(params: dict, cfg, batch: dict, dev) -> dict:
    """The v2 S2S loss of ``params`` on ``batch`` (no gradient) in its two
    parts: the text NLL per target token, and the T2U's (the unit NLL plus
    the duration MSE) per unit and char."""
    import torch

    from seamless_communication_torch.train.trainer import batch_to, s2st_loss, s2t_loss

    b = batch_to(batch, dev)
    with torch.no_grad():
        text, n_text = s2t_loss(params, cfg, b)
        total, n_all = s2st_loss(params, cfg, b)
    return {"text": float(text / n_text),
            "t2u": float((total - text) / (n_all - n_text))}


def phase_train(smi: str) -> dict:
    """3g. The finetune trainer at v2-large: ``base_v2`` at full width and
    depth, bf16 params from a seeded generator (seed 3), not quantized, the
    text encoder frozen, ``SEAMLESS_FUSED_ATTN=1``, learning rate 1e-4 after
    a warm-up of 1 step. S2T: 3 ``UnitYFinetune`` steps on one batch (10 s
    and 7 s, 160 and 120 target tokens), each launching K6, K6b and K6c as
    ``k6_train_expected`` counts (48 each), the losses finite and the third
    below the first, then one step under the profiler. One S2T step with
    ``remat="full"`` from the same params: the first step's loss within 2e-2
    (bf16), twice the K6 forwards, and a lower peak of the loss and
    backward (``fwd_bwd_peak``). v2 S2S: 2 steps with the NAR T2U on
    ground-truth durations, the loss's two parts (``s2s_loss_parts``) before
    and after each, then the same 2 steps with the option off (the first
    step's loss within 1e-3 relative of the option's). Then ``grad_parity``
    of S2T and of S2S."""
    import torch

    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.ops.kernels import launch_counts, reset_launch_counts
    from seamless_communication_torch.train.trainer import (
        FinetuneMode, FinetuneParams, UnitYFinetune, named_leaves,
    )

    dev = torch.device(TRAIN_DEVICE)
    cfg = get_arch(TRAIN_ARCH)
    t0 = time.time()
    params = unity.unity_init(torch.Generator(device=dev).manual_seed(3), cfg,
                              dtype=torch.bfloat16, device=dev)
    n_params = sum(t.numel() for _, t in named_leaves(params))
    log(f"3g {TRAIN_ARCH} params (bf16, {n_params / 1e9:.3f} B) built in {time.time() - t0:.1f} "
        f"s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    ft = dict(learning_rate=1e-4, warmup_steps=1, freeze_text_encoder=True)
    s2t = train_batch(cfg, 21)
    s2s = train_batch(cfg, 22, s2s=True)
    out = {}
    reset_launch_counts()
    with fused_attention(True):
        parts = k6_train_expected(cfg, s2t, s2s=False)
        k6 = sum(parts.values())
        expect = dict.fromkeys(("flash_attention", "flash_attention_bwd_dkv",
                                "flash_attention_bwd_dq"), k6)
        log(f"3g S2T: K6, K6b, K6c expected {k6} a step = {parts}")
        trainer = UnitYFinetune(params, cfg, FinetuneParams(**ft), device=dev)
        rows = train_steps(trainer, s2t, 3, "3g S2T", smi, expect=expect)
        if not rows[2]["loss"] < rows[0]["loss"]:
            raise AssertionError(f"3g S2T: loss did not fall: {[r['loss'] for r in rows]}")
        out["s2t"] = rows
        out["profile"] = profile_train_step(trainer, s2t, smi)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        remat = UnitYFinetune(params, cfg, FinetuneParams(**ft, remat="full"), device=dev)
        (row,) = train_steps(remat, s2t, 1, "3g S2T remat=full", smi,
                             expect={**expect, "flash_attention": 2 * k6})
        del remat
        gc.collect()
        torch.cuda.empty_cache()
        # the step's peak is AdamW's (its moments and temporaries), after
        # the activations are gone; remat's saving shows in the loss and
        # backward alone
        peaks = {policy: fwd_bwd_peak(params, cfg, s2t, dev, policy)
                 for policy in (None, "full")}
        if abs(row["loss"] - rows[0]["loss"]) > 2e-2 or not peaks["full"] < peaks[None]:
            raise AssertionError(f"3g remat: loss {row['loss']} against {rows[0]['loss']}, "
                                 f"loss + backward peak {peaks}")
        log(f"3g remat=full: loss {row['loss']:.5f} against {rows[0]['loss']:.5f} without; "
            f"the loss and backward alone peak {peaks['full']:.2f} GiB above the params "
            f"against {peaks[None]:.2f} without remat; the whole step {row['peak_gib']:.2f} "
            f"against {rows[0]['peak_gib']:.2f} GiB (AdamW's first step sets both) [{smi}]")
        out["remat"] = dict(row, fwd_bwd_peak_gib=peaks["full"],
                            fwd_bwd_peak_gib_no_remat=peaks[None])
        gc.collect()
        torch.cuda.empty_cache()

        parts = k6_train_expected(cfg, s2s, s2s=True)
        k6 = sum(parts.values())
        log(f"3g S2S (v2, NAR T2U; {s2s['char_ids'].shape[1]} chars, "
            f"{s2s['target_units'].shape[1]} units): K6, K6b, K6c expected {k6} a step "
            f"= {parts}")
        s2s_ft = FinetuneParams(**ft, finetune_mode=FinetuneMode.SPEECH_TO_SPEECH)
        trainer = UnitYFinetune(params, cfg, s2s_ft, device=dev)
        parts = [s2s_loss_parts(trainer.params, cfg, s2s, dev)]
        out["s2s"] = []
        for i in range(2):
            out["s2s"] += train_steps(trainer, s2s, 1, "3g S2S", smi,
                                      expect=dict.fromkeys(expect, k6), first=i + 1)
            parts.append(s2s_loss_parts(trainer.params, cfg, s2s, dev))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    # the same steps with the option off: the plain attention
    trainer = UnitYFinetune(params, cfg, s2s_ft, device=dev)
    with fused_attention(False):
        off = train_steps(trainer, s2s, 2, "3g S2S, option off", smi,
                          expect=dict.fromkeys(expect, 0))
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()
    floor = math.log(cfg.nar_t2u.unit_vocab_size)
    log("3g S2S loss parts before and after each step (text NLL per token; T2U unit NLL "
        "+ duration MSE per unit and char): "
        + "; ".join(f"{i}: text {p['text']:.5f}, T2U {p['t2u']:.5f}"
                    for i, p in enumerate(parts))
        + f". The target units are random: no model that has not learnt them scores "
        f"below ln({cfg.nar_t2u.unit_vocab_size}) = {floor:.4f} a unit on average. "
        f"Option off, the same steps: losses {off[0]['loss']:.5f}, {off[1]['loss']:.5f} "
        f"against {out['s2s'][0]['loss']:.5f}, {out['s2s'][1]['loss']:.5f} with it [{smi}]")
    # the bf16 kernels against the plain bf16 attention: the first step's
    # loss (before any update) within 1e-3 relative
    rel = abs(off[0]["loss"] - out["s2s"][0]["loss"]) / abs(off[0]["loss"])
    log(f"3g first losses with the option: S2T {out['s2t'][0]['loss']:.5f}, S2S "
        f"{out['s2s'][0]['loss']:.5f} against {off[0]['loss']:.5f} off ({rel:.3g} relative, "
        f"limit 1e-3) [{smi}]")
    if rel > 1e-3:
        raise AssertionError(f"3g S2S: first loss {out['s2s'][0]['loss']} with the option, "
                             f"{off[0]['loss']} without")
    out["s2s_parts"] = parts
    out["s2s_off"] = off
    bf16_launches = dict(launch_counts)         # the bf16 steps; then fp32 parity
    out["parity"] = grad_parity(cfg, dev, smi)
    out["parity_s2s"] = grad_parity(cfg, dev, smi, s2s=True)
    out["launches"] = dict(launch_counts)
    out["launches_fp32"] = {k: v - bf16_launches[k] for k, v in launch_counts.items()}
    return out


def phase_tiny_train() -> None:
    """tiny_v2 S2T with inputs long enough for the fused path (300 fbank
    frames, 150 conformer frames; 130 target tokens), fp32, the option on:
    two ``UnitYFinetune`` steps on the card (K6, K6b, K6c) and on the CPU
    (the plain versions) from the same params: the losses within 1e-5 and
    every parameter within 1e-4."""
    import torch

    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.ops.kernels import launch_counts
    from seamless_communication_torch.train.trainer import (
        FinetuneParams, UnitYFinetune, named_leaves,
    )

    cfg = get_arch("tiny_v2")
    params = unity.unity_init(torch.Generator().manual_seed(0), cfg)
    batches = [train_batch(cfg, 40 + i, frames=(300, 260), tokens=(130, 100))
               for i in range(2)]
    ft = FinetuneParams(learning_rate=1e-3, warmup_steps=2, weight_decay=0.01,
                        float_dtype=torch.float32)
    runs = {}
    with fused_attention(True):
        for where, device in (("card", TRAIN_DEVICE), ("cpu", "cpu")):
            before = dict(launch_counts)
            tr = UnitYFinetune(params, cfg, ft, device=device)
            losses = [float(tr.step(b)["loss"]) for b in batches]
            runs[where] = (losses, tr.params,
                           {k: launch_counts[k] - before[k] for k in launch_counts})
    k6 = {k: runs["card"][2][k] for k in ("flash_attention", "flash_attention_bwd_dkv",
                                          "flash_attention_bwd_dq")}
    want = 2 * sum(k6_train_expected(cfg, batches[0], s2s=False).values())
    if set(k6.values()) != {want} or any(runs["cpu"][2].values()):
        raise AssertionError(f"tiny train: launches {k6} (expected {want} each), CPU "
                             f"{runs['cpu'][2]}")
    dl = max(abs(a - b) for a, b in zip(runs["card"][0], runs["cpu"][0]))
    dp = max(float((a.detach().cpu() - b.detach()).abs().max())
             for (_, a), (_, b) in zip(named_leaves(runs["card"][1]),
                                       named_leaves(runs["cpu"][1])))
    if dl > 1e-5 or dp > 1e-4:
        raise AssertionError(f"tiny train: card and CPU differ: loss {dl:.3g}, params {dp:.3g}")
    log(f"tiny_v2 train, 2 steps with the fused option: losses {runs['card'][0]} on the "
        f"card, {runs['cpu'][0]} on the CPU (max diff {dl:.3g}); params within {dp:.3g}; "
        f"K6, K6b, K6c {want} launches each on the card, none on the CPU")


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


def phase_tiny_t2t() -> None:
    """tiny_v2 T2TT and T2ST in fp32 with the tree int8 (``quantize_params(
    min_size=1)``, so the tied embedding is int8), int8 KV and the candidate
    beam, on the card (K3b and K1) and on the CPU (the plain versions): text
    tokens and units identical, waveforms within 1e-4 absolute."""
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
    from seamless_communication_torch.ops.quantization import quantize_params

    cfg = get_arch("tiny_v2")
    gen = torch.Generator().manual_seed(0)
    params = quantize_params(unity.unity_init(gen, cfg), min_size=1)
    vocoder_cfg = CodeHifiGanConfig(**TINY_VOCODER, hifigan=HifiGanConfig(**TINY_HIFIGAN))
    vocoder = code_hifigan_init(gen, vocoder_cfg)
    tok = synthetic_tokenizer(200)                  # fits tiny_v2's 256 ids
    texts = [synthetic_text(tok, 14, 20), synthetic_text(tok, 9, 21)]
    opts = SequenceGeneratorOptions(soft_max_seq_len=(1, 40), kv_cache_int8=True)
    with candidate_beam():
        for task in ("t2tt", "t2st"):
            out = {}
            for device in ("cuda", "cpu"):
                tr = s2st_translator(params, cfg, tok, vocoder, vocoder_cfg,
                                     text_opts=opts, device=device)
                before = dict(launch_counts)
                _, speech = tr.predict(texts, task, "fra", src_lang="eng")
                res = tr.generator.last_result
                k3b = launch_counts["vocab_topk_v2"] - before["vocab_topk_v2"]
                k1 = (launch_counts["decode_attention_int8"]
                      - before["decode_attention_int8"])
                out[device] = (res.tokens[:, 0].cpu(), res.lengths[:, 0].cpu(), speech)
                log(f"tiny_v2 {task} on {device}: {res.steps} steps, K3b launches {k3b}, "
                    f"K1 launches {k1}, best lengths {out[device][1].tolist()}")
                on_card = device == "cuda"
                if (k3b, k1) != ((2 * res.steps, cfg.nllb.num_decoder_layers * res.steps)
                                 if on_card else (0, 0)):
                    raise AssertionError(f"tiny_v2 {task} on {device}: K3b {k3b} and "
                                         f"K1 {k1} launches in {res.steps} steps")
            (tc, lc, sc), (tp, lp, sp) = out["cuda"], out["cpu"]
            if not (torch.equal(tc, tp) and torch.equal(lc, lp)):
                raise AssertionError(f"tiny_v2 {task}: tokens differ between the card "
                                     f"and the CPU: {tc.tolist()} vs {tp.tolist()}")
            err = 0.0
            if task == "t2st":
                if sc.units != sp.units:
                    raise AssertionError("tiny_v2 t2st: units differ between the card "
                                         "and the CPU")
                for a, b in zip(sc.audio_wavs, sp.audio_wavs):
                    if a.shape != b.shape:
                        raise AssertionError(f"tiny_v2 t2st: waveform shapes {a.shape} "
                                             f"and {b.shape}")
                    err = max(err, float(np.abs(a - b).max(initial=0.0)))
                if err > 1e-4:
                    raise AssertionError(f"tiny_v2 t2st: waveforms differ by {err:.3g} "
                                         "> 1e-4")
            log(f"tiny_v2 {task} (int8 tree, candidate beam): tokens"
                + (" and units" if task == "t2st" else "") + " identical on the card "
                f"(K3b, K1) and the CPU (plain versions), waveform max abs difference "
                f"{err:.3g}")


def phase_tiny_options() -> None:
    """tiny_v2 in fp32 with int8 KV and the tiny vocoder, on the card and on
    the CPU, over the six-form word vocabulary of ``mintox_tokenizer`` (40
    words): S2TT with the lazy reorder (K5 on the card), T2TT with
    no_repeat_ngram_size=2, T2TT with banned sequences, T2TT through a
    MinTox Translator, and S2TT of FbankInput raw log-mels (a 0-length item
    included) under both normalizations must give the same texts and tokens
    on both."""
    import numpy as np
    import torch

    from seamless_communication_torch.audio.fbank import fbank_numpy
    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.inference.translator import FbankInput
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.vocoder.codehifigan import (
        CodeHifiGanConfig, code_hifigan_init,
    )
    from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig
    from seamless_communication_torch.ops.kernels import launch_counts
    from seamless_communication_torch.toxicity.etox import ETOXBadWordChecker
    from seamless_communication_torch.toxicity.mintox import banned_sequences_from_words

    cfg = get_arch("tiny_v2")
    gen = torch.Generator().manual_seed(0)
    params = unity.unity_init(gen, cfg)
    vocoder_cfg = CodeHifiGanConfig(**TINY_VOCODER, hifigan=HifiGanConfig(**TINY_HIFIGAN))
    vocoder = code_hifigan_init(gen, vocoder_cfg)
    tok, words = mintox_tokenizer(40)
    assert tok.vocab_info.size <= cfg.nllb.vocab_size
    opts = SequenceGeneratorOptions(soft_max_seq_len=(1, 40), kv_cache_int8=True)
    rng = np.random.default_rng(8)
    wav = (rng.standard_normal(3 * 16000) * 0.1).astype(np.float32)
    text = " ".join(words[:8])
    banned = banned_sequences_from_words(tok, words[10:14])
    feats = [fbank_numpy(wav), fbank_numpy(wav[:20000])]
    fb = np.zeros((3, feats[0].shape[0], 80), np.float32)
    for i, f in enumerate(feats):
        fb[i, :f.shape[0]] = f
    lens = np.array([len(feats[0]), len(feats[1]), 0], np.int32)
    checker = {"eng": words[20:], "fra": words[20:]}
    out = {}
    for device in ("cuda", "cpu"):
        tr = s2st_translator(params, cfg, tok, vocoder, vocoder_cfg, text_opts=opts,
                             device=device)
        mt = s2st_translator(params, cfg, tok, vocoder, vocoder_cfg, text_opts=opts,
                             device=device, apply_mintox=True,
                             etox_checker=ETOXBadWordChecker.from_word_lists(checker))
        got = {}

        def best(t):
            r = t.generator.last_result
            return r.tokens[:, 0].cpu().tolist(), r.lengths[:, 0].cpu().tolist()

        before = dict(launch_counts)
        with lazy_reorder(True):
            got["lazy s2tt"] = (tr.predict([wav, wav[:32000]], "s2tt", "eng")[0], best(tr))
        steps = tr.generator.last_result.steps
        k5 = launch_counts["decode_attention_indexed"] - before["decode_attention_indexed"]
        k1 = launch_counts["decode_attention_int8"] - before["decode_attention_int8"]
        expected = (cfg.nllb.num_decoder_layers * steps, 0) if device == "cuda" else (0, 0)
        if (k5, k1) != expected:
            raise AssertionError(f"tiny_v2 lazy S2TT on {device}: K5 {k5}, K1 {k1} "
                                 f"launches in {steps} steps")
        got["ngram t2tt"] = (tr.predict(text, "t2tt", "fra", src_lang="eng",
                                        text_generation_opts=SequenceGeneratorOptions(
                                            soft_max_seq_len=(1, 40), kv_cache_int8=True,
                                            no_repeat_ngram_size=2))[0], best(tr))
        got["banned t2tt"] = (tr.predict(text, "t2tt", "fra", src_lang="eng",
                                         banned_sequences=banned)[0], best(tr))
        got["mintox t2tt"] = (mt.predict(text, "t2tt", "fra", src_lang="eng")[0],
                              sorted(mt.last_mintox_timings))
        for mode in ("utterance", "per_mel_bin"):
            tr.normalize_fbank = mode
            got[f"fbank {mode}"] = (tr.predict(FbankInput(fb, lens), "s2tt", "eng")[0],
                                    best(tr))
        out[device] = got
        log(f"tiny_v2 options on {device}: lazy S2TT {steps} steps (K5 {k5}, K1 {k1}); "
            f"MinTox passes {got['mintox t2tt'][1]}; texts "
            + "; ".join(f"{k} {[t[:24] for t in v[0]]}" for k, v in got.items()))
    for name in out["cuda"]:
        if out["cuda"][name] != out["cpu"][name]:
            raise AssertionError(f"tiny_v2 {name}: the card and the CPU differ: "
                                 f"{out['cuda'][name]} vs {out['cpu'][name]}")
    log("tiny_v2 lazy reorder (K5), n-gram block, banned sequences, MinTox and "
        "FbankInput: texts and tokens identical on the card and the CPU")


def tiny_speech_parity(label: str, cfg, params, vocoder, vocoder_cfg, unit_tok, runs,
                       expect) -> None:
    """Each ``(task, input, kwargs)`` of ``runs`` through a Translator on the
    card and on the CPU (int8 KV, the fused option on): texts, best text
    tokens and units identical, waveforms within 1e-4 absolute (fp32
    convolutions of cuDNN and of the CPU summed in other orders, then a
    tanh). ``expect(task, translator, input, kwargs)`` gives the (K1, K6)
    launches the card's run must make; the CPU's make none."""
    import numpy as np
    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.ops.kernels import launch_counts

    opts = SequenceGeneratorOptions(soft_max_seq_len=(1, 40), kv_cache_int8=True)
    for task, inp, kw in runs:
        out = {}
        for device in ("cuda", "cpu"):
            tr = Translator(params, cfg, synthetic_tokenizer(200), unit_tok,
                            synthetic_char_tokenizer(), vocoder_params=vocoder,
                            vocoder_cfg=vocoder_cfg, lang_spkr_idx_map=LANG_SPKR,
                            text_opts=opts, unit_opts=opts, device=device)
            before = dict(launch_counts)
            with fused_attention(True):
                texts, speech = tr.predict(inp, task, "fra", **kw)
            got = (launch_counts["decode_attention_int8"] - before["decode_attention_int8"],
                   launch_counts["flash_attention"] - before["flash_attention"])
            res = tr.generator.last_result
            want = expect(task, tr, inp, kw) if device == "cuda" else (0, 0)
            log(f"{label} {task} on {device}: {res.steps} text steps, (K1, K6) launches "
                f"{got}, units {[len(u) for u in speech.units]}")
            if got != want:
                raise AssertionError(f"{label} {task} on {device}: (K1, K6) launches {got}, "
                                     f"expected {want}")
            out[device] = (texts, res.tokens[:, 0].cpu(), res.lengths[:, 0].cpu(), speech)
        (xc, tc, lc, sc), (xp, tp, lp, sp) = out["cuda"], out["cpu"]
        if not (xc == xp and torch.equal(tc, tp) and torch.equal(lc, lp)
                and sc.units == sp.units):
            raise AssertionError(f"{label} {task}: texts, tokens or units differ between "
                                 f"the card and the CPU")
        err = max((float(np.abs(a - b).max(initial=0.0))
                   for a, b in zip(sc.audio_wavs, sp.audio_wavs)), default=0.0)
        if err > 1e-4 or [a.shape for a in sc.audio_wavs] != [b.shape for b in sp.audio_wavs]:
            raise AssertionError(f"{label} {task}: waveforms differ by {err:.3g} > 1e-4")
        log(f"{label} {task}: texts, tokens and units identical on the card and the CPU, "
            f"waveform max abs difference {err:.3g}")


def phase_tiny_v1_and_fused() -> None:
    """tiny_v1 (XL conformer, AR T2U) S2ST of 3 s and T2ST, and tiny_v2 S2ST
    of 3 s, in fp32 with the fused option on and int8 KV, with the tiny
    vocoder: the card (K1 for the text and the unit decodes, K6 where a
    sequence reaches 128) and the CPU (the plain versions) agree as
    ``tiny_speech_parity`` holds them."""
    import numpy as np
    import torch

    from seamless_communication_torch.inference.generator import _bucket
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
    from seamless_communication_torch.models.vocoder.codehifigan import (
        CodeHifiGanConfig, code_hifigan_init,
    )
    from seamless_communication_torch.models.vocoder.hifigan import HifiGanConfig

    vocoder_cfg = CodeHifiGanConfig(**TINY_VOCODER, hifigan=HifiGanConfig(**TINY_HIFIGAN))
    wav = (np.random.default_rng(10).standard_normal(3 * 16000) * 0.1).astype(np.float32)
    frames = 192        # 3 s: 300 fbank frames padded to 384, stacked by 2

    for arch in ("tiny_v1", "tiny_v2"):
        cfg = get_arch(arch)
        gen = torch.Generator().manual_seed(0)
        params = unity.unity_init(gen, cfg)
        vocoder = code_hifigan_init(gen, vocoder_cfg)
        unit_tok = UnitTokenizer(100, ["eng", "fra"], "base" if arch == "tiny_v1" else arch)

        def expect(task, tr, inp, kw, cfg=cfg):
            res = tr.generator.last_result
            k1 = cfg.nllb.num_decoder_layers * res.steps
            if cfg.ar_t2u is not None:
                k1 += cfg.ar_t2u.num_decoder_layers * tr.generator.last_unit_result.steps
            src = (frames if task == "s2st"
                   else _bucket(len(tr.text_tokenizer.encode_source(inp, "eng")), 16))
            parts = k6_expected(cfg, src_len=src, speech=task == "s2st",
                                text_len=_bucket(int(res.lengths[:, 0].max()), 16),
                                max_unit_len=kw.get("max_unit_len", 2048))
            return k1, sum(parts.values())

        # the AR unit decodes cut to 63 steps; the NAR T2U at its default 2048
        cut = {"max_unit_len": 64} if arch == "tiny_v1" else {}
        runs = [("s2st", wav, cut)]
        if arch == "tiny_v1":
            runs.append(("t2st", synthetic_text(synthetic_tokenizer(200), 9, 22),
                         {"src_lang": "eng", **cut}))
        tiny_speech_parity(arch, cfg, params, vocoder, vocoder_cfg, unit_tok, runs, expect)


def profile_main_path(smi: str, out_dir: str = "chiprun_out") -> None:
    """Where the main path's time goes, under ``torch.profiler``: one 10 s
    base_v2 S2TT request, then one T2TT request of 20 source tokens with the
    candidate beam and without it, each cut to 63 decode steps (the
    profiler's own cost grows with the events it keeps). Also times the
    speech encoder alone. Tables land in ``<out_dir>/profile_*.txt``."""
    import os

    import torch

    from seamless_communication_torch.inference.generator import (
        SequenceGeneratorOptions,
    )
    from seamless_communication_torch.models.unity import model as unity

    translator, tok, cfg, noise = build_base_v2()
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
    log(f"speech encoder alone on the 10 s request: {statistics.median(enc_ms):.1f} ms "
        f"(median of 3, no profiler) [{smi}]")
    opts = SequenceGeneratorOptions(soft_max_seq_len=(0, 64))

    def request(*args, **kw):
        def run():
            translator.predict(*args, text_generation_opts=opts, **kw)
            return translator.generator.last_result.steps
        return run

    s2tt = profile_call("S2TT 10 s request", request(wav, "s2tt", "eng"),
                        os.path.join(out_dir, "profile_s2tt.txt"), smi)
    log(f"K1 in the S2TT request: {s2tt['kernel_ms']['Int8Rows'] / s2tt['steps']:.4f} ms "
        f"of device time per decode step [{smi}]")
    text = synthetic_text(tok, 20, 10)
    with candidate_beam():
        translator.predict(text, "t2tt", "fra", src_lang="eng",
                           text_generation_opts=SequenceGeneratorOptions(
                               soft_max_seq_len=(0, 8)))         # warm-up
        cand = profile_call("T2TT 20 tokens, candidate beam",
                            request(text, "t2tt", "fra", src_lang="eng"),
                            os.path.join(out_dir, "profile_t2tt_candidate.txt"), smi)
    full = profile_call("T2TT 20 tokens, full-vocabulary beam",
                        request(text, "t2tt", "fra", src_lang="eng"),
                        os.path.join(out_dir, "profile_t2tt_full_vocab.txt"), smi)
    log(f"candidate beam against the full-vocabulary beam: kernels busy "
        f"{cand['busy_ms'] / cand['steps']:.3f} against "
        f"{full['busy_ms'] / full['steps']:.3f} ms per decode step, "
        f"{cand['launches'] / cand['steps']:.0f} against "
        f"{full['launches'] / full['steps']:.0f} launches per step [{smi}]")


def profile_call(label: str, run, path: str, smi: str) -> dict:
    """``run()`` (one request, ending in a synchronize) under
    ``torch.profiler``: prints the wall, the kernels' busy time and share,
    the launches per decode step and the top kernels by device time, and
    writes the full table to ``path``. Returns the busy ms, the launches and
    the device ms of the kernels whose names hold ``Int8Rows`` (K1) or
    ``Int4Rows`` (K2)."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the aten ops that launched them carry the same device time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    log(f"profile {label} [{smi}]: wall {wall_ms:.1f} ms under the profiler, {steps} "
        f"decode steps; kernels busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f} % "
        f"of the wall, {busy_ms / steps:.3f} ms per decode step; {launches} kernel "
        f"launches = {launches / steps:.0f} per decode step")
    for e in events[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:7d} x  {e.key[:90]}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    kernel_ms = {key: sum(e.self_device_time_total for e in events if key in e.key) / 1e3
                 for key in ("Int8Rows", "Int4Rows")}
    return {"busy_ms": busy_ms, "launches": launches, "steps": steps,
            "kernel_ms": kernel_ms}


# ---------------------------------------------------------------------------
# phase 3m: m4t_finetune, checkpoint directories, remat, meshes on one card
# ---------------------------------------------------------------------------

H_RANK = 8                      # heads a rank computes under model=2 (16 / 2)
FT_SECONDS = (4.0, 9.5, 6.0, 10.0, 5.0, 8.0, 7.0, 4.5)   # the manifest's WAVs
FT_EVAL_SECONDS = (6.5, 9.0)
MESH_CASES_3M = (("data 2", dict(data=2, model=1), {}),
                 ("model 2", dict(data=1, model=2), {}),
                 ("pipe 2, n_micro 2, remat full", dict(data=1, model=1, pipe=2),
                  dict(pp_microbatches=2, remat="full")))


def rank_flash_case(smi: str) -> dict:
    """Phase 2's K6, K6b and K6c at the heads one rank computes under
    ``model=2``: the 10 s Shaw shape (B=1, T=512, 499 valid keys, Dh=64,
    ``ab``) with H=8, in fp32 and bf16. K6 against ``_reference`` (rtol =
    atol = 1e-5 fp32, 1.6e-2 bf16), K6b and K6c against ``_reference_bwd``
    (``bwd_error``); device times by CUDA-graph replay beside the plain
    versions, the bounds and the library's SDPA (its backward: forward +
    backward less forward)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from seamless_communication_torch.ops.kernels import flash_attention as fl

    dev = torch.device("cuda")
    rng = np.random.default_rng(47)
    B, H, T, Dh, valid = 1, H_RANK, 512, DH_MAIN, 499
    qkv = [torch.as_tensor(rng.standard_normal((B, H, T, Dh)), dtype=torch.float32,
                           device=dev) for _ in range(3)]
    qkv[0] = qkv[0] / Dh ** 0.5
    pad = torch.where(torch.arange(T, device=dev) < valid, 0.0, -1e9)
    ab32 = torch.as_tensor(rng.standard_normal((B, H, T, T)) * 0.5, dtype=torch.float32,
                           device=dev) + pad
    do32 = torch.as_tensor(rng.standard_normal((B, H, T, Dh)), dtype=torch.float32,
                           device=dev)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        qs, k, v = (x.to(dtype) for x in qkv)
        ab, do = ab32.to(dtype), do32.to(dtype)
        args = (qs, k, v, ab, None, None)
        got = fl.flash_attention(*args)
        ref = fl._reference(*args)
        err = (got.float() - ref.float()).abs()
        if not bool((err <= tol[dtype] * (1 + ref.float().abs())).all()):
            raise AssertionError(f"K6 H={H} {dtype}: out max err {float(err.max()):.3g}")
        o, m, l = fl._launch(*args, residuals=True)
        grads = fl.flash_attention_bwd(*args, o, m, l, do, need_dab=True)
        refs = fl._reference_bwd(*args, o, m, l, do)
        errs = {n: bwd_error(f"H={H} {n}", g, r, dtype)
                for n, g, r in zip(("dq", "dk", "dv", "dab"), grads, refs)}
        bargs = fl._bwd_args(*args, o, m, l, do)
        dq, dk, dv = (torch.empty_like(x) for x in grads[:3])
        dab = fl.empty_bias(B, H, T, T, dtype, dev)
        k6_ms = cuda_time_ms(lambda: fl.flash_attention(*args))
        dkv_ms = cuda_time_ms(lambda: fl._launch_one(fl.KERNEL_DKV, bargs, dk, dv))
        dq_ms = cuda_time_ms(lambda: fl._launch_one(fl.KERNEL_DQ, bargs, dq, dab))
        plain = {"k6": cuda_time_ms(lambda: fl._reference(*args), calls=5, reps=20)}
        for part in ("dkv", "dq"):
            plain[part] = cuda_time_ms(lambda: fl._reference_bwd(
                *args, o, m, l, do, part=part), calls=5, reps=20)
        leaves = [x.detach().clone().requires_grad_() for x in (qs, k, v)]
        lmask = ab.detach().clone().requires_grad_()

        def lib_fwd():
            return F.scaled_dot_product_attention(*leaves, attn_mask=lmask, scale=1.0)

        lib_fwd_ms = cuda_time_ms(lib_fwd, calls=5, reps=20)
        lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            lib_fwd(), leaves + [lmask], do), calls=5, reps=20) - lib_fwd_ms
        pairs = fl.unmasked_pairs(B, H, T, T, ab, None, None)
        b6 = fl.bound(B, H, T, T, Dh, dtype, True, False, pairs)
        bb = (B, H, T, T, Dh, dtype, True, False, pairs, True)
        b_dkv, b_dq = fl.bound_bwd(*bb, part="dkv"), fl.bound_bwd(*bb, part="dq")
        name = str(dtype)[6:]
        log(f"per-rank heads (model=2): 10 s Shaw shape, B={B} H={H} T={T} Dh={Dh}, {name}: "
            f"K6 out max err {float(err.max()):.3g}, K6b/K6c max errs "
            + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f"; device K6 {k6_ms * 1e3:.2f} us (plain {plain['k6'] * 1e3:.2f}, SDPA "
            f"{lib_fwd_ms * 1e3:.2f}, bound {b6[0] * 1e3:.2f} {b6[1]}), K6b "
            f"{dkv_ms * 1e3:.2f} us (plain {plain['dkv'] * 1e3:.2f}, bound "
            f"{b_dkv[0] * 1e3:.2f} {b_dkv[1]}), K6c {dq_ms * 1e3:.2f} us (plain "
            f"{plain['dq'] * 1e3:.2f}, bound {b_dq[0] * 1e3:.2f} {b_dq[1]}); K6b + K6c "
            f"{(dkv_ms + dq_ms) * 1e3:.2f} us against SDPA's backward "
            f"{lib_bwd_ms * 1e3:.2f} us [{smi}]")
        out[name] = {
            "flash_attention": {"ms": k6_ms, "plain_ms": plain["k6"], "library_ms": lib_fwd_ms,
                                "bound_ms": b6[0], "bound_by": b6[1],
                                "max_abs_err": float(err.max())},
            "flash_attention_bwd_dkv": {"ms": dkv_ms, "plain_ms": plain["dkv"],
                                        "bound_ms": b_dkv[0], "bound_by": b_dkv[1],
                                        "library_ms": None,
                                        "max_abs_err": max(errs["dk"], errs["dv"])},
            "flash_attention_bwd_dq": {"ms": dq_ms, "plain_ms": plain["dq"],
                                       "bound_ms": b_dq[0], "bound_by": b_dq[1],
                                       "library_ms": None,
                                       "max_abs_err": max(errs["dq"], errs["dab"])},
            "pair_library_ms": lib_bwd_ms}
    return out


def write_finetune_manifest(d, tok, name: str, seconds, seed: int) -> str:
    """A manifest of seeded noise WAVs of ``seconds`` (16 kHz) with synthetic
    target texts of 20-60 tokens of the synthetic vocabulary."""
    import json

    import numpy as np

    from seamless_communication_torch.audio.wav import write_wav

    rng = np.random.default_rng(seed)
    lines = []
    for i, s in enumerate(seconds):
        path = d / f"{name}{i}.wav"
        write_wav(str(path), (rng.standard_normal(int(s * 16000)) * 0.1).astype(np.float32),
                  16000)
        text = synthetic_text(tok, int(rng.integers(20, 61)), seed * 100 + i)
        lines.append(json.dumps({"source": {"audio_local_path": str(path), "lang": "eng"},
                                 "target": {"text": text, "lang": "fra"}}))
    path = d / f"{name}.json"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def flat_on_host(tree) -> dict:
    """{dotted path: host copy} of a tree's tensors."""
    from seamless_communication_torch.checkpoint.serialize import flat_tensors

    return {k: t.detach().to("cpu", copy=True) for k, t in flat_tensors(tree).items()}


def phase_finetune(smi: str, shared=None) -> dict:
    """3m. ``m4t_finetune`` at full width and the meshes on the one card.

    a. ``base_v2`` on seeded bf16 weights written by the port's exporter as
       an fp16 ``.pt`` with the synthetic cards (``write_cards``): 3h's,
       left in ``shared`` by the same run, else its own (seed 7); and a
       seeded full-width conformer-shaw ``.pt`` (seed 8, bf16); a
       manifest of 8 noise WAVs of 4-10 s with synthetic texts and an eval
       manifest of 2; ``cli.finetune.main`` in-process, S2T, ``--batch_size 2
       --max_epochs 1 --eval_steps 2 --init_speech_encoder``, the best model
       and the state to directories, bf16, ``SEAMLESS_FUSED_ATTN=1``: when
       the run starts, the trainer's speech-encoder conformer stack and
       frontend projection equal the exported ones (part c); 4 steps with
       finite losses; K6 launched as ``k6_train_expected`` counts for each
       train and eval batch, K6b and K6c for each train batch; the best
       model loads back leaf for leaf equal to the trainer's parameters when
       it was saved.
    b. The trained trainer takes 2 more steps (the first two batches); then
       it restores (a)'s state directory and takes the same 2 steps: the
       losses bit for bit, else within 2e-3 relative (bf16).
    d. One S2T step (the first batch) from the loaded parameters with
       ``remat`` "dots", "offload_dots" and "full": losses within 2e-2 of
       each other (3g's bf16 tolerance), the loss and backward's peak
       (``fwd_bwd_peak``) and the step's wall.
    e. Two processes on ``cuda:0`` over gloo (``mesh_worker``), full width
       at 4 + 4 layers, fp32, TF32 off, the fused option on: one S2T step on
       the meshes (data 2), (model 2) and (pipe 2, n_micro 2, remat full),
       each held to the same process's step without a mesh from the same
       parameters: loss within 1e-4, every updated parameter within 2e-4
       (as JAX's tests), the whole clipped gradient within 1e-4 of its norm
       and every leaf's within 1e-4 of its own or 10 times what rounding
       alone moves it, by the larger of two witnesses (``mesh_worker``): at
       lr 1e-4 AdamW's first step moves each element by about lr whatever
       its gradient, so only the gradients show a wrong sum."""
    import numpy as np
    import torch

    from seamless_communication_torch.checkpoint.fairseq_export import (
        export_conformer_shaw_fairseq1, export_unity,
    )
    from seamless_communication_torch.checkpoint.serialize import flat_tensors, load_params
    from seamless_communication_torch.cli import finetune
    from seamless_communication_torch.datasets.loader import manifest_batches
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.ops.kernels import launch_counts, reset_launch_counts
    from seamless_communication_torch.train import trainer as ttrainer

    dev = torch.device("cuda")
    cfg = get_arch("base_v2")
    names = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    out: dict = {}
    with contextlib.nullcontext(shared) if shared is not None else offline_dir() as d:
        t0 = time.perf_counter()
        if shared is None:
            params = unity.unity_init(torch.Generator(device=dev).manual_seed(7), cfg,
                                      dtype=torch.bfloat16, device=dev)
            torch.save({"model": export_unity(params, dtype=torch.float16)},
                       d / "unity.pt")
            del params
            write_cards(d)
        shaw = unity.unity_init(torch.Generator(device=dev).manual_seed(8), cfg,
                                dtype=torch.bfloat16, device=dev)["speech_encoder"]
        shaw = {k: shaw[k] for k in ("feature_projection", "encoder")}
        torch.save({"model": export_conformer_shaw_fairseq1(shaw, dtype=torch.bfloat16)},
                   d / "shaw.pt")
        shaw = flat_on_host(shaw)
        gc.collect()
        torch.cuda.empty_cache()
        tok = synthetic_tokenizer()
        train = write_finetune_manifest(d, tok, "train", FT_SECONDS, 3)
        evals = write_finetune_manifest(d, tok, "eval", FT_EVAL_SECONDS, 4)
        out["write_s"] = time.perf_counter() - t0
        batches = list(manifest_batches(train, tok, batch_size=2))
        eval_batches = list(manifest_batches(evals, tok, batch_size=2))
        per_train = [sum(k6_train_expected(cfg, b, s2s=False).values()) for b in batches]
        per_eval = sum(sum(k6_train_expected(cfg, b, s2s=False).values())
                       for b in eval_batches)
        held, saved = {}, {}
        real_run, real_save = ttrainer.UnitYFinetune.run, ttrainer.UnitYFinetune.save

        def checked_run(self, start_step: int = 0):
            # c: the conformer-shaw initialisation, before any step
            got = flat_on_host({k: self.params["speech_encoder"][k]
                                for k in ("feature_projection", "encoder")})
            bad = [k for k in shaw if not torch.equal(got[k], shaw[k])]
            if set(got) != set(shaw) or bad:
                raise AssertionError(f"3m --init_speech_encoder: {len(bad)} leaves differ "
                                     f"from the exported ones ({bad[:3]})")
            held["shaw_leaves"] = len(shaw)
            return real_run(self, start_step)

        def recorded_save(self):
            saved["params"] = flat_on_host(self.params)
            saved["step"] = len(self.step_losses)
            return real_save(self)

        argv = ["--train_dataset", train, "--eval_dataset", evals,
                "--model_name", OFFLINE_CARD, "--local_pt_path", str(d / "unity.pt"),
                "--batch_size", "2", "--max_epochs", "1", "--eval_steps", "2",
                "--learning_rate", "1e-4", "--warmup_steps", "1",
                "--init_speech_encoder", str(d / "shaw.pt"),
                "--save_model_to", str(d / "best"), "--save_state_to", str(d / "state")]
        ttrainer.UnitYFinetune.run, ttrainer.UnitYFinetune.save = checked_run, recorded_save
        try:
            with fused_attention(True):
                reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = finetune.main(argv)
                torch.cuda.synchronize()
                cli_s = time.perf_counter() - t0
                launches = {k: launch_counts[k] for k in names}
        finally:
            ttrainer.UnitYFinetune.run, ttrainer.UnitYFinetune.save = real_run, real_save
        tr = res.trainer
        n_evals = res.final_step // 2
        want = {"flash_attention": sum(per_train) + n_evals * per_eval,
                "flash_attention_bwd_dkv": sum(per_train),
                "flash_attention_bwd_dq": sum(per_train)}
        losses = tr.step_losses
        if (res.final_step != len(batches) or launches != want or "shaw_leaves" not in held
                or not all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"3m CLI: {res.final_step} steps, losses {losses}, launches "
                                 f"{launches} (expected {want})")
        best = flat_on_host(load_params(str(d / "best")))
        if set(best) != set(saved["params"]) or any(
                not torch.equal(best[k], saved["params"][k]) for k in best):
            raise AssertionError("3m: the best-model directory does not load back leaf for leaf")
        sizes = {name: sum(f.stat().st_size for f in (d / name).rglob("*") if f.is_file())
                 for name in ("best", "state")}
        log(f"3m m4t_finetune (base_v2 from an fp16 .pt, bf16, S2T, the option on, "
            f"--init_speech_encoder: {held['shaw_leaves']} leaves equal the exported ones): "
            f"{cli_s:.1f} s in main with the load, {len(batches)} steps of 2 WAVs (4-10 s), "
            f"losses {', '.join(f'{x:.5f}' for x in losses)}, evals {n_evals} (best "
            f"{tr.best_eval:.5f}, saved at step {saved['step']}); K6, K6b, K6c {launches} as "
            f"counted for each batch; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; best model {sizes['best'] / 2**30:.2f} GiB and state "
            f"{sizes['state'] / 2**30:.2f} GiB as directories; the best model loads back "
            f"leaf for leaf ({len(best)} leaves) [{smi}]")
        out["cli"] = {"main_s": cli_s, "losses": losses, "launches": launches,
                      "evals": n_evals, "best_eval": tr.best_eval,
                      "dir_bytes": sizes, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

        # b: resume
        two = batches[:2]
        with fused_attention(True):
            cont = [float(tr.step(b)["loss"]) for b in two]
            t0 = time.perf_counter()
            step = tr.restore_state(str(d / "state"))
            restore_s = time.perf_counter() - t0
            again = [float(tr.step(b)["loss"]) for b in two]
        rel = max(abs(a - b) / abs(a) for a, b in zip(cont, again))
        if step != len(batches) or rel > 2e-3:
            raise AssertionError(f"3m resume: step {step}, losses {again} against {cont}")
        log(f"3m resume from the state directory (restored in {restore_s:.1f} s, step "
            f"{step}): 2 more steps {', '.join(f'{x:.6f}' for x in again)} against the "
            f"uninterrupted {', '.join(f'{x:.6f}' for x in cont)} "
            f"({'bit for bit' if again == cont else f'{rel:.3g} relative'}) [{smi}]")
        out["resume"] = {"continued": cont, "resumed": again, "restore_s": restore_s,
                         "bitwise": again == cont}
        params = {k: v for k, v in tr.params.items()}
        base = ttrainer.trainable_copy(params, dev)
        del res, tr, params, saved, best
        gc.collect()
        torch.cuda.empty_cache()

    # d: remat policies from the same parameters
    rows = {}
    with fused_attention(True):
        for policy in ("dots", "offload_dots", "full"):
            trainer = ttrainer.UnitYFinetune(base, cfg, ttrainer.FinetuneParams(
                learning_rate=1e-4, warmup_steps=1, remat=policy), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(trainer.step(batches[0])["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            rows[policy] = {"loss": loss, "wall_ms": wall * 1e3,
                            "fwd_bwd_peak_gib": fwd_bwd_peak(base, cfg, batches[0], dev, policy)}
    spread = max(r["loss"] for r in rows.values()) - min(r["loss"] for r in rows.values())
    log("3m remat, one S2T step each from the same parameters: " + "; ".join(
        f"{p}: loss {r['loss']:.5f}, wall {r['wall_ms']:.1f} ms, loss + backward peak "
        f"{r['fwd_bwd_peak_gib']:.2f} GiB above the params" for p, r in rows.items())
        + f" (losses within {spread:.3g}, limit 2e-2) [{smi}]")
    if spread > 2e-2:
        raise AssertionError(f"3m remat: losses {rows}")
    out["remat"] = rows
    del base
    gc.collect()
    torch.cuda.empty_cache()

    out["meshes"] = phase_meshes(smi)
    return out


def mesh_cfg():
    """base_v2 at full width cut to 4 conformer and 4 decoder layers (3g's
    gradient parity's cut, the text encoder and T2U left out)."""
    import dataclasses

    from seamless_communication_torch.models.unity.builder import get_arch

    cfg = get_arch("base_v2")
    conf = cfg.speech.conformer._replace(num_layers=4)
    return dataclasses.replace(cfg, speech=cfg.speech._replace(conformer=conf),
                               nllb=cfg.nllb._replace(num_decoder_layers=4),
                               nar_t2u=None, use_text_encoder=False)


def mesh_worker(rank: int, port: int, path: str) -> None:
    """One of the two gloo processes of 3m (e), both on ``cuda:0``: the
    process's own step without a mesh and its rounding witnesses
    (``no_mesh_grads``), then one step on each of ``MESH_CASES_3M`` from the
    same parameters, each held to it; rank 0 writes the results to
    ``path``.

    The witnesses say how far rounding alone moves each gradient leaf: the
    step's gradient computed as the sum of the batch's two one-row halves
    (what "data" 2 and two micro-batches compute), against the step's; and
    with the plain attention's output rounded otherwise by about one ulp
    (3g's control, ``flash_versions``), against the plain attention's. A
    mesh's leaf may depart from the step's by 1e-4 of its norm or by 10
    times the larger witness, whichever is more (an attention's ``k_proj``
    bias, whose exact gradient is 0, by 1e-4 of its weight's)."""
    import os

    import torch
    import torch.distributed as dist

    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.ops.kernels import launch_counts
    from seamless_communication_torch.parallel.collectives import (
        all_gather, local_heads, model_shard,
    )
    from seamless_communication_torch.parallel.sharding import make_mesh
    from seamless_communication_torch.train.trainer import (
        MAX_GRAD_NORM, FinetuneParams, UnitYFinetune, batch_to, map_tree, named_leaves,
        s2t_loss, trainable_copy,
    )

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["SEAMLESS_FUSED_ATTN"] = "1"
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    dev = torch.device("cuda")
    cfg = mesh_cfg()
    params = unity.unity_init(torch.Generator(device=dev).manual_seed(12), cfg,
                              dtype=torch.float32, device=dev)
    batch = train_batch(cfg, 33)
    names = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    ft = dict(learning_rate=1e-4, warmup_steps=1, float_dtype=torch.float32)
    ref = UnitYFinetune(params, cfg, FinetuneParams(**ft), device=dev)
    ref_loss = float(ref.step(batch)["loss"])
    ref_params = map_tree(torch.Tensor.detach, ref.params)
    ref_grads = [t.grad.detach() for _, t in named_leaves(ref.params)]
    paths = [".".join(where) for where, _ in named_leaves(ref.params)]
    del ref

    def no_mesh_grads(rows, ctx) -> list:
        """The step's clipped gradient without a mesh, its summed loss taken
        over the slices ``rows`` of the batch, over the batch's tokens."""
        p = trainable_copy(params, dev, torch.float32)
        leaves = [t for _, t in named_leaves(p)]
        with ctx:
            sums = [s2t_loss(p, cfg, batch_to({k: v[r] for k, v in batch.items()}, dev),
                             label_smoothing=FinetuneParams().label_smoothing)
                    for r in rows]
            loss = (sum(l for l, _ in sums)
                    / torch.clamp_min(sum(n for _, n in sums), 1.0))
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, gs)]
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in gs])))
        return [g * (MAX_GRAD_NORM / norm) if norm >= MAX_GRAD_NORM else g for g in gs]

    halves = no_mesh_grads([slice(0, 1), slice(1, 2)], contextlib.nullcontext())
    w_split = [float((a - b).norm()) for a, b in zip(halves, ref_grads)]
    del halves
    plain = no_mesh_grads([slice(None)], flash_versions("plain", "plain"))
    ulp = no_mesh_grads([slice(None)], flash_versions("plain, out +-1 ulp", "plain"))
    w_ulp = [float((a - b).norm()) for a, b in zip(ulp, plain)]
    del plain, ulp
    ref_norms = [float(g.norm()) for g in ref_grads]
    index = {w: i for i, w in enumerate(paths)}
    # the norm each leaf is held to: an attention's k_proj bias, its weight's
    scale = [ref_norms[index[w[:-len("bias")] + "weight"]] if w.endswith("k_proj.bias")
             else n for w, n in zip(paths, ref_norms)]
    limits = [max(1e-4 * n, 10 * max(a, b)) for n, a, b in zip(scale, w_split, w_ulp)]
    witness = {"split_max": max(a / n for a, n in zip(w_split, scale) if n > 0),
               "ulp_max": max(a / n for a, n in zip(w_ulp, scale) if n > 0)}
    results = []
    for label, mesh_kw, extra in MESH_CASES_3M:
        mesh = make_mesh(**mesh_kw)
        tr = UnitYFinetune(params, cfg, FinetuneParams(**ft, **extra), mesh=mesh,
                           device=dev)
        before = dict(launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(tr.step(batch)["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: launch_counts[k] - before[k] for k in names}
        worst, sq, leaf_errs = 0.0, 0.0, []

        def whole(x, like):
            s = model_shard(like)
            return torch.cat(all_gather(x.detach(), s.axis), s.dim) if s else x.detach()

        for i, ((_, t), (_, r)) in enumerate(zip(named_leaves(tr.params),
                                                 named_leaves(ref_params))):
            worst = max(worst, float(((whole(t, t) - r).abs() / (1 + r.abs())).max()))
            # the clipped gradients: the whole tree's, and each leaf's against
            # its limit
            dg = float((whole(t.grad, t) - ref_grads[i]).norm())
            sq += dg ** 2
            leaf_errs.append((dg / limits[i] if limits[i] > 0 else math.inf if dg else 0.0,
                              paths[i], dg / scale[i] if scale[i] > 0 else dg,
                              w_split[i] / scale[i] if scale[i] > 0 else 0.0,
                              w_ulp[i] / scale[i] if scale[i] > 0 else 0.0))
        leaf_errs.sort(reverse=True)
        heads = local_heads(tr.params["speech_encoder"]["encoder"][0]["self_attn"]["q_proj"],
                            cfg.speech.conformer.num_heads)
        results.append({"mesh": label, "loss": loss, "ref_loss": ref_loss,
                        "max_param_err": worst,
                        "grad_err": (sq / sum(n * n for n in ref_norms)) ** 0.5,
                        "leaf_grad_errs": leaf_errs[:3], "leaves": len(paths),
                        "witness": witness, "launches": got, "heads": heads,
                        "wall_ms": wall * 1e3,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        del tr
        torch.cuda.empty_cache()
    if rank == 0:
        with open(path, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


def phase_meshes(smi: str) -> list:
    """3m (e): ``mesh_worker`` in two spawned processes on the one card
    (NCCL puts no two ranks on one device, so the group is gloo; the port's
    collectives carry CUDA tensors through the host under gloo). Each mesh's
    loss within 1e-4 of the no-mesh step's, every parameter within 2e-4
    (relative to 1 + |ref|), the whole clipped gradient within 1e-4 of its
    norm and each leaf's within its limit (``mesh_worker``); the K6
    launches a rank and its heads shown."""
    import multiprocessing as mp
    import os
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=mesh_worker, args=(r, port, path)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.terminate()
    wall = time.perf_counter() - t0
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"3m meshes: worker exit codes {[p.exitcode for p in procs]}")
    with open(path) as f:
        rows = json.load(f)
    os.unlink(path)
    bad = []
    for r in rows:
        ok = (abs(r["loss"] - r["ref_loss"]) <= 1e-4 and r["max_param_err"] <= 2e-4
              and r["grad_err"] <= 1e-4 and r["leaf_grad_errs"][0][0] <= 1)
        log(f"3m mesh ({r['mesh']}) on one card, two gloo processes, base_v2 4 + 4 layers "
            f"fp32: loss {r['loss']:.6f} against {r['ref_loss']:.6f} without a mesh "
            f"({abs(r['loss'] - r['ref_loss']):.3g}, limit 1e-4), {r['leaves']} params within "
            f"{r['max_param_err']:.3g} (limit 2e-4; at lr 1e-4 AdamW's first step moves an "
            f"element by about 1e-4, so a gradient that rounds to the other sign moves it "
            f"2e-4), the whole clipped gradient within {r['grad_err']:.3g} of its norm "
            f"(limit 1e-4), the leaves nearest their limits "
            + ", ".join(f"{p} {e:.3g} of its norm ({q:.3g} of its limit; witnesses: "
                        f"halves {a:.3g}, 1 ulp {b:.3g})" for q, p, e, a, b in
                        r["leaf_grad_errs"])
            + f" (limit: 1e-4 or 10 times the larger witness; the witnesses' largest "
            f"{r['witness']['split_max']:.3g} and {r['witness']['ulp_max']:.3g}); "
            f"rank 0: K6 {r['launches']['flash_attention']}, "
            f"K6b {r['launches']['flash_attention_bwd_dkv']}, K6c "
            f"{r['launches']['flash_attention_bwd_dq']} launches, {r['heads']} heads a rank; "
            f"step wall {r['wall_ms']:.1f} ms, peak {r['peak_gib']:.2f} GiB [{smi}]")
        if not ok:
            bad.append(r["mesh"])
    log(f"3m meshes: {wall:.1f} s with the two processes' start [{smi}]")
    if bad:
        raise AssertionError(f"3m meshes {bad} differ from the step without a mesh")
    return rows


# ---------------------------------------------------------------------------
# phase 3n: the auxiliary models (unit extraction, the aligner, MuToX, VAD,
# denoising, profiling)
# ---------------------------------------------------------------------------

XLSR_T, XLSR_VALID = 499, (499, 350)     # 10 s of 16 kHz audio through the conv stack
AUX_SECONDS, AUX_LONG_SECONDS = 10.0, 60.0
# 3n: two centroids whose fp64 distances to a feature differ by less than
# this share of the distance are a tie that fp32 rounding may decide either
# way (fp32 distances near 1e4 are off by about 2e-7 of themselves)
KMEANS_TIE = 1e-6


def xlsr_flash_case(smi: str) -> dict:
    """Phase 2's K6 at the XLSR2-1B encoder's shape: B=2, H=16, Dh=80 (1280
    over 16 heads), T=499 (10 s through the conv stack) with 499 and 350
    valid keys as key segment ids, as ``try_flash`` turns the encoder's
    key-padding bias into them. K6 against its plain version in fp32 (with
    32- and 64-row blocks) and bf16 within rtol = atol = 1e-5 and 1.6e-2,
    timed beside the library's SDPA with the segment mask as a float mask
    and the bound over the unmasked logits (bytes over 3.35 TB/s against
    operations over the dtype's peak rate); the fp32 kernel's skipped key
    tiles counted."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from seamless_communication_torch.ops.kernels import flash_attention as fl

    dev = torch.device("cuda")
    rng = np.random.default_rng(47)
    B, H, T, Dh = 2, 16, XLSR_T, 80
    qkv = [torch.as_tensor(rng.standard_normal((B, H, T, Dh)), dtype=torch.float32,
                           device=dev) for _ in range(3)]
    qkv[0] = qkv[0] / Dh ** 0.5
    q_seg = torch.ones((B, T), dtype=torch.int32, device=dev)
    valid = torch.tensor(XLSR_VALID, device=dev)
    kv_seg = (torch.arange(T, device=dev)[None] < valid[:, None]).to(torch.int32)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        qs, k, v = (x.to(dtype) for x in qkv)
        args = (qs, k, v, None, q_seg, kv_seg)
        got = fl.flash_attention(*args)
        ref = fl._reference(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= tol[dtype] * (1 + ref.float().abs())).all()):
            raise AssertionError(f"K6 XLSR {dtype}: out max err {float(err.max()):.3g} "
                                 "over tolerance")
        mask = torch.where(q_seg[:, None, :, None] == kv_seg[:, None, None, :], 0.0,
                           fl.MASK_VALUE).to(dtype)
        k_ms = cuda_time_ms(lambda: fl.flash_attention(*args))
        p_ms = cuda_time_ms(lambda: fl._reference(*args), calls=5, reps=20)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, scale=1.0), calls=5, reps=20)
        pairs = fl.unmasked_pairs(B, H, T, T, None, q_seg, kv_seg)
        bound = fl.bound(B, H, T, T, Dh, dtype, False, True, pairs)
        skipped = int(fl.skippable_tiles_fwd(q_seg, kv_seg, T, T, None).sum())
        how = "wgmma, five 32-byte boxes a row"
        if dtype is torch.float32:
            err = max(float(err.max()), hold_fp32_rows("XLSR Dh=80", qkv, None,
                                                       (q_seg, kv_seg)))
            heights = ", ".join(
                f"{r} rows {cuda_time_ms(lambda: fl._launch(*args, block_rows=r)) * 1e3:.2f} us"
                for r in (32, 64))
            how = (f"five 64-byte boxes a row, {fl.fp32_block_rows(B, H, T)}-row blocks "
                   f"({heights})")
        else:
            err = float(err.max())
        log(f"K6 XLSR2-1B encoder, B={B} H={H} Dh={Dh} T={T} (valid keys {XLSR_VALID}, key "
            f"segment ids), {str(dtype)[6:]} ({how}): out max abs err {err:.3g} "
            f"(rtol=atol={tol[dtype]}); device kernel {k_ms * 1e3:.2f} us, plain "
            f"{p_ms * 1e3:.2f} us, library SDPA with the float mask {lib_ms * 1e3:.2f} us, "
            f"bound {bound[0] * 1e3:.2f} us ({bound[1]}; {pairs} unmasked logits of "
            f"{B * H * T * T}), {skipped} tile pairs skipped, kernel at "
            f"{k_ms / bound[0]:.1f}x its bound [{smi}]")
        out[str(dtype)[6:]] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                               "bound_ms": bound[0], "bound_by": bound[1],
                               "max_abs_err": err, "tiles_skipped": skipped,
                               "unmasked_pairs": pairs}
    return out


def stand_in_speech_encoder(dim: int, seed: int):
    """A TorchScript stand-in for a SONAR speech encoder (no SONAR weights
    are in the repository): waveform (1, T) -> (1, dim), a fixed seeded
    projection of four statistics of the waveform, traced."""
    import torch

    class Encoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("w", torch.randn((4, dim), generator=torch.Generator()
                                                  .manual_seed(seed)))

        def forward(self, wav):
            stats = torch.stack([wav.mean() * 10.0, wav.abs().mean() * 10.0,
                                 wav.std() * 10.0, wav.abs().max()])
            return (stats @ self.w)[None]

    return torch.jit.trace(Encoder().eval(), torch.zeros((1, 1600)))


def aux_waveform(seconds: float, seed: int):
    """Seeded 16 kHz audio shaped like speech: bursts of a few harmonics in
    noise of 0.6-2.4 s between pauses of 0.1-0.8 s of faint noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sr, n = 16000, int(seconds * 16000)
    parts, m = [], 0
    while m < n:
        k = int(rng.uniform(0.6, 2.4) * sr)
        t = np.arange(k) / sr
        f0 = rng.uniform(90, 250)
        burst = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 5))
        parts.append(0.2 * burst + 0.05 * rng.standard_normal(k))
        k = int(rng.uniform(0.1, 0.8) * sr)
        parts.append(0.003 * rng.standard_normal(k))
        m += sum(len(p) for p in parts[-2:])
    return np.concatenate(parts)[:n].astype(np.float32)


def phase_aux(smi: str) -> dict:
    """3n. The auxiliary models at full width, seeded, each step timed.

    1. ``cli.audio_to_units.main`` in-process on a 10 s 16 kHz WAV, the
       full-width ``Wav2Vec2RawConfig()`` XLSR2-1B (48 x 1280, 16 heads of
       80) written by the port's exporter as an fp32 ``.pt`` into a
       temporary directory, a 10000 x 1280 k-means ``.npy``,
       ``SEAMLESS_FUSED_ATTN=1``, layer 35: K6 launched once a layer run
       (35: the port stops after the output layer), 499 units, the wall by
       stage.
    2. The encoder again with the option off: layer 35's features within
       atol 2e-3 + rtol 2e-3 of the kernel path's (as 3e); the share of
       equal units printed; k-means on the card against k-means on the CPU
       on the same features: the units equal, save where the fp64 distances
       of the two centroids differ by less than ``KMEANS_TIE`` of the
       distance (a tie that fp32's rounding decides; counted and printed).
    3. ``AlignmentExtractor`` at the full ``AlignerConfig()`` from an
       ``export_aligner`` ``.pt``, on step 1's units and a text of about 60
       characters through the synthetic char tokenizer, against the same
       extractor on the CPU: log-probs within 1e-4, durations equal and
       summing to the unit count.
    4. ``cli.mutox_speech.main`` with the full-width classifier (1024 ->
       512 -> 128 -> 1) in the reference ``.pt`` layout and a TorchScript
       stand-in speech encoder, on three WAVs: the scores finite and within
       1e-5 of the same CLI on the CPU.
    5. ``VADSegmenter`` (the energy VAD, 10 s chunks) and
       ``Denoiser.spectral_subtract`` on 60 s of seeded audio: host work,
       timed.
    6. Step 1 again inside the port's ``device_trace``: the top device
       events of its aggregation.

    Launches are counted from 0 just before step 1. The CLI's log line of
    the 499 units is held back (the count and the distinct units are
    printed)."""
    import logging

    import torch

    from seamless_communication_torch.models.unit_extractor.wav2vec2_raw import (
        Wav2Vec2RawConfig,
    )

    dev = torch.device("cuda")
    cfg = Wav2Vec2RawConfig()
    layer = 35
    cli_log = logging.getLogger("audio_to_units")
    level = cli_log.level
    cli_log.setLevel(logging.WARNING)
    try:
        return aux_steps(smi, dev, cfg, layer)
    finally:
        cli_log.setLevel(level)


def aux_steps(smi: str, dev, cfg, layer: int) -> dict:
    """The steps of ``phase_aux``."""
    import os

    import numpy as np
    import torch

    from seamless_communication_torch.audio.wav import write_wav
    from seamless_communication_torch.checkpoint.fairseq_export import (
        export_aligner, export_w2v2_raw,
    )
    from seamless_communication_torch.cli import audio_to_units, mutox_speech
    from seamless_communication_torch.denoise.denoiser import Denoiser
    from seamless_communication_torch.models.aligner.extractor import AlignmentExtractor
    from seamless_communication_torch.models.aligner.model import AlignerConfig, aligner_init
    from seamless_communication_torch.models.unit_extractor.unit_extractor import KmeansModel
    from seamless_communication_torch.models.unit_extractor.wav2vec2_raw import (
        wav2vec2_raw_init,
    )
    from seamless_communication_torch.ops.kernels import launch_counts, reset_launch_counts
    from seamless_communication_torch.segment.vad import VADSegmenter
    from seamless_communication_torch.toxicity.mutox import MutoxConfig, mutox_init
    from seamless_communication_torch.utils.profiling import device_trace

    stats: dict = {}
    t0 = time.perf_counter()
    params = wav2vec2_raw_init(torch.Generator(device=dev).manual_seed(51), cfg, device=dev)
    n_params = sum(t.numel() for t in tensor_leaves(params))
    rng = np.random.default_rng(52)
    centroids = rng.standard_normal((10000, cfg.model_dim)).astype(np.float32)
    wav = aux_waveform(AUX_SECONDS, 53)
    with offline_dir() as d:
        torch.save({"model": export_w2v2_raw(params)}, d / "xlsr.pt")
        del params
        gc.collect()
        np.save(d / "kmeans.npy", centroids)
        write_wav(str(d / "in.wav"), wav, 16000)
        export_s = time.perf_counter() - t0
        size = os.path.getsize(d / "xlsr.pt")
        log(f"3n: XLSR2-1B ({n_params / 1e9:.3f} B parameters) drawn on the card and "
            f"written as an fp32 .pt of {size / 2**30:.3f} GiB, k-means {centroids.shape}, "
            f"{AUX_SECONDS:.0f} s WAV in {export_s:.1f} s [{smi}]")
        stats.update(xlsr_params=n_params, xlsr_pt_bytes=size, export_s=export_s)

        # ---- 1. m4t_audio_to_units with the fused option (K6 at Dh = 80)
        argv = [str(d / "in.wav"), "--kmeans_path", str(d / "kmeans.npy"),
                "--w2v2_checkpoint", str(d / "xlsr.pt"), "--out_layer_number", str(layer),
                "--device", "cuda"]
        torch.cuda.synchronize()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with fused_attention(True):
            t0 = time.perf_counter()
            res = audio_to_units.main(argv)
            wall = time.perf_counter() - t0
        launches = dict(launch_counts)
        k6 = launches["flash_attention"]
        others = {k: v for k, v in launches.items() if v and k != "flash_attention"}
        if k6 != layer or others:
            raise AssertionError(f"3n: K6 launched {k6} times for {layer} layers run "
                                 f"(other kernels {others})")
        if len(res.units) != XLSR_T or not all(0 <= u < 10000 for u in res.units):
            raise AssertionError(f"3n: {len(res.units)} units, expected {XLSR_T} in [0, 10000)")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"3n m4t_audio_to_units, {AUX_SECONDS:.0f} s, layer {layer}, "
            f"SEAMLESS_FUSED_ATTN=1: wall {wall:.2f} s = "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in res.timings.items())
            + f"; K6 launches {k6} (one a layer run), {len(res.units)} units "
            f"({len(set(res.units))} distinct), peak {peak:.2f} GiB [{smi}]")
        stats["audio_to_units"] = {"wall_s": wall, "stages_s": res.timings, "units": len(res.units),
                                   "k6_launches": k6, "peak_gib": peak}

        # ---- 2. the option off; k-means on the card against the CPU
        ex = res.extractor
        x = torch.as_tensor(wav[None], device=dev)
        lens = torch.tensor([wav.size], device=dev)
        feats = {}
        with torch.inference_mode():
            for on in (True, False):
                with fused_attention(on):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    feats[on] = ex.features(x, lens)[0]
                    torch.cuda.synchronize()
                    stats[f"encoder_ms_option_{'on' if on else 'off'}"] = (
                        time.perf_counter() - t0) * 1e3
            err = (feats[True] - feats[False]).abs()
            if not bool((err <= 2e-3 + 2e-3 * feats[False].abs()).all()):
                raise AssertionError(f"3n: layer {layer}'s features with and without the fused "
                                     f"option differ by up to {float(err.max()):.3g}")
            units = {on: ex.kmeans(feats[on])[0].cpu().numpy() for on in (True, False)}
            if units[True].tolist() != res.units:
                raise AssertionError("3n: the extractor's units differ from the CLI's")
            same = float((units[True] == units[False]).mean())
            f_cpu = feats[True][0].cpu()
            t0 = time.perf_counter()
            cpu_units = KmeansModel(centroids)(f_cpu).numpy()
            cpu_ms = (time.perf_counter() - t0) * 1e3
        differ = np.nonzero(cpu_units != units[True])[0]
        f64 = f_cpu.double().numpy()
        c64 = centroids.astype(np.float64)
        for i in differ:
            a, b = int(cpu_units[i]), int(units[True][i])
            da, db = ((f64[i] - c64[a]) ** 2).sum(), ((f64[i] - c64[b]) ** 2).sum()
            if abs(da - db) >= KMEANS_TIE * da:
                raise AssertionError(f"3n: frame {i}: k-means on the card chose {b}, on the "
                                     f"CPU {a}, whose fp64 distances are {db:.8g} and {da:.8g}")
        log(f"3n encoder with the option on / off: {stats['encoder_ms_option_on']:.1f} / "
            f"{stats['encoder_ms_option_off']:.1f} ms; layer {layer}'s features max abs "
            f"difference {float(err.max()):.3g} (atol 2e-3 + rtol 2e-3), "
            f"max |feature| {float(feats[False].abs().max()):.3g}; units equal at "
            f"{same * 100:.2f} % of frames; k-means on the card and on the CPU "
            f"({cpu_ms:.1f} ms) give the same units at {XLSR_T - len(differ)} of {XLSR_T} "
            f"frames, the rest ties within {KMEANS_TIE} of the distance in fp64 [{smi}]")
        stats.update(features_max_abs_diff=float(err.max()), units_equal_share=same,
                     kmeans_cpu_ms=cpu_ms, kmeans_ties=len(differ))
        del ex, res, feats
        gc.collect()

        # ---- 3. the aligner at full width, card against CPU
        acfg = AlignerConfig()
        aparams = aligner_init(torch.Generator(device=dev).manual_seed(54), acfg, device=dev)
        torch.save(export_aligner(aparams), d / "aligner.pt")
        del aparams
        text = ("the quick brown fox jumps over the lazy dog while seven "
                "birds sing")
        durs, lprobs, walls = {}, {}, {}
        for where in ("cuda", "cpu"):
            ae = AlignmentExtractor(str(d / "aligner.pt"), char_tokenizer=synthetic_char_tokenizer(),
                                    aligner_cfg=acfg, device=where)
            t0 = time.perf_counter()
            durs[where], lprobs[where] = ae.extract_alignment(units[True], text)
            walls[where] = time.perf_counter() - t0
        lp_err = float(np.abs(np.where(np.isinf(lprobs["cpu"]), 0.0,
                                       lprobs["cuda"] - lprobs["cpu"])).max())
        if (not np.array_equal(np.isinf(lprobs["cuda"]), np.isinf(lprobs["cpu"]))
                or lp_err > 1e-4 or not np.array_equal(durs["cuda"], durs["cpu"])
                or int(durs["cuda"].sum()) != XLSR_T):
            raise AssertionError(f"3n aligner: log-probs differ by {lp_err:.3g}, durations "
                                 f"sum {int(durs['cuda'].sum())} of {XLSR_T}, equal to the "
                                 f"CPU's: {np.array_equal(durs['cuda'], durs['cpu'])}")
        log(f"3n AlignmentExtractor, full AlignerConfig(), {XLSR_T} units and {len(text)} "
            f"characters ({durs['cuda'].shape[1]} tokens): card {walls['cuda'] * 1e3:.1f} ms, "
            f"CPU {walls['cpu'] * 1e3:.1f} ms; log-probs within {lp_err:.3g} (limit 1e-4), "
            f"durations equal, summing to {int(durs['cuda'].sum())}, longest "
            f"{int(durs['cuda'].max())} [{smi}]")
        stats["aligner"] = {"card_ms": walls["cuda"] * 1e3, "cpu_ms": walls["cpu"] * 1e3,
                            "lprob_max_abs_diff": lp_err, "tokens": int(durs["cuda"].shape[1])}

        # ---- 4. MuToX speech at full width, card against CPU
        mcfg = MutoxConfig()
        mparams = mutox_init(torch.Generator().manual_seed(55), mcfg)
        sd = {}
        for i, lyr in enumerate(mparams["layers"]):
            sd[f"model_all.{i}.1.weight"] = lyr["linear"]["weight"].T.contiguous()
            sd[f"model_all.{i}.1.bias"] = lyr["linear"]["bias"]
        torch.save({"model": sd}, d / "mutox.pt")
        stand_in_speech_encoder(mcfg.input_size, 56).save(str(d / "sonar_speech.pt"))
        paths = []
        for i, secs in enumerate((3.0, 5.5, 8.0)):
            write_wav(str(d / f"m{i}.wav"), aux_waveform(secs, 57 + i), 16000)
            paths.append(str(d / f"m{i}.wav"))
        (d / "mutox_in.txt").write_text("\n".join(paths) + "\n")
        scores, mwalls = {}, {}
        for where in ("cuda", "cpu"):
            out = d / f"mutox_{where}.tsv"
            t0 = time.perf_counter()
            mutox_speech.main(["eng", str(d / "mutox_in.txt"), str(out), "--classifier_pt",
                               str(d / "mutox.pt"), "--sonar_torchscript",
                               str(d / "sonar_speech.pt"), "--device", where])
            mwalls[where] = time.perf_counter() - t0
            gc.collect()
            rows = [line.split("\t") for line in out.read_text().splitlines()[1:]]
            if [r[0] for r in rows] != paths:
                raise AssertionError(f"3n mutox_speech on {where}: rows {rows}")
            scores[where] = np.array([float(r[1]) for r in rows])
        m_err = float(np.abs(scores["cuda"] - scores["cpu"]).max())
        if not np.isfinite(scores["cuda"]).all() or m_err > 1e-5:
            raise AssertionError(f"3n mutox_speech: scores {scores}")
        log(f"3n mutox_speech, 1024 -> 512 -> 128 -> 1, a TorchScript stand-in encoder, three "
            f"WAVs: card {mwalls['cuda'] * 1e3:.1f} ms, CPU {mwalls['cpu'] * 1e3:.1f} ms; "
            f"scores {np.round(scores['cuda'], 4).tolist()}, within {m_err:.3g} of the CPU's "
            f"(limit 1e-5) [{smi}]")
        stats["mutox"] = {"card_ms": mwalls["cuda"] * 1e3, "cpu_ms": mwalls["cpu"] * 1e3,
                          "max_abs_diff": m_err}

        # ---- 5. host segmentation and denoising of 60 s
        long_wav = aux_waveform(AUX_LONG_SECONDS, 60)
        t0 = time.perf_counter()
        segments = VADSegmenter(chunk_size_sec=10.0).segment_long_input(long_wav)
        vad_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        clean = Denoiser.spectral_subtract(long_wav, 16000)
        den_ms = (time.perf_counter() - t0) * 1e3
        if (not segments or any(not 0 < e - s <= 10 * 16000 for s, e in segments)
                or clean.shape != long_wav.shape or not np.isfinite(clean).all()):
            raise AssertionError(f"3n: VAD segments {segments}, denoised {clean.shape}")
        log(f"3n host work on {AUX_LONG_SECONDS:.0f} s: VADSegmenter (energy VAD, 10 s chunks) "
            f"{vad_ms:.1f} ms, {len(segments)} segments of "
            f"{min(e - s for s, e in segments) / 16000:.2f}-"
            f"{max(e - s for s, e in segments) / 16000:.2f} s; spectral_subtract "
            f"{den_ms:.1f} ms [{smi}]")
        stats.update(vad_ms=vad_ms, vad_segments=len(segments), denoise_ms=den_ms)

        # ---- 6. step 1 under the profiler
        with fused_attention(True):
            t0 = time.perf_counter()
            with device_trace(str(d / "trace")) as trace:
                audio_to_units.main(argv)
            traced_s = time.perf_counter() - t0
        top = trace.aggregate(top=8)
        total = sum(ms for ms, _, _ in trace.aggregate(top=0))
        log(f"3n m4t_audio_to_units under device_trace: wall {traced_s:.2f} s, device events "
            f"{total:.2f} ms in all; top: "
            + (", ".join(f"{name[:60]} {ms:.2f} ms x{n}" for ms, n, name in top)
               or "none (the profiler recorded no device events)") + f" [{smi}]")
        stats["trace"] = {"wall_s": traced_s, "device_ms": total,
                          "top": [[ms, n, name[:80]] for ms, n, name in top]}
    return {"launches": k6, "stats": stats}


EVAL_MAX_LEN = 62               # 3o's decodes cut to 63 steps
EVAL_CARD = "smoke_m4t_v2_words"


def word_tokenizer_spm(vocab_size: int, n_langs: int) -> bytes:
    """A SentencePiece model whose pieces fill an NLLB vocabulary of
    ``vocab_size`` ids with ``n_langs`` languages: distinct words ("▁bb",
    "▁bc", ...) up to the language symbols, so that every token a random
    model writes decodes to a word."""
    from seamless_communication_torch.text.spm import (
        TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, build_spm_model,
    )

    def word(i: int) -> str:
        out, i = "", i + 27
        while i:
            i, r = divmod(i, 26)
            out = "abcdefghijklmnopqrstuvwxyz"[r] + out
        return "\u2581" + out

    base = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
            ("</s>", 0.0, TYPE_CONTROL)]
    # pad, the languages and <MINED_DATA> take the other ids
    n_words = vocab_size - 1 - n_langs - 1 - len(base)
    return build_spm_model(base + [(word(i), -2.0, TYPE_NORMAL) for i in range(n_words)])


@contextlib.contextmanager
def recording_model_calls(record: list):
    """Within the block, each ``UnitYGenerator.generate_text`` appends
    ("decode", its beam's steps) to ``record`` and each
    ``unity.encode_speech`` ("encode", its padded fbank frames)."""
    from seamless_communication_torch.inference import generator
    from seamless_communication_torch.models.unity import model as unity

    gen, enc = generator.UnitYGenerator.generate_text, unity.encode_speech

    def generate_text(self, *a, **kw):
        out = gen(self, *a, **kw)
        record.append(("decode", int(self.last_result.steps)))
        return out

    def encode_speech(params, cfg, fbank, lens):
        record.append(("encode", int(fbank.shape[1])))
        return enc(params, cfg, fbank, lens)

    generator.UnitYGenerator.generate_text, unity.encode_speech = generate_text, encode_speech
    try:
        yield
    finally:
        generator.UnitYGenerator.generate_text, unity.encode_speech = gen, enc


def expected_launches(cfg, record: list) -> dict:
    """K1 and K6 launches of the decodes and speech encodes in ``record``
    (``recording_model_calls``): K1 once a decoder layer a step, K6 where
    the encoder's shapes make attentions eligible (``k6_expected``)."""
    k1 = cfg.nllb.num_decoder_layers * sum(n for kind, n in record if kind == "decode")
    k6 = sum(sum(k6_expected(cfg, src_len=n // 2, speech=True).values())
             for kind, n in record if kind == "encode")
    return {"decode_attention_int8": k1, "flash_attention": k6}


def wave_decode(data: bytes):
    """A 16-bit PCM WAV's bytes through the standard library's ``wave``, as
    ``inference/serving.py _decode_wav_b64`` reads a file the native decoder
    does not take: (mono float32 waveform, sample rate)."""
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(data), "rb") as w:
        rate, n = w.getframerate(), w.getnframes()
        raw = np.frombuffer(w.readframes(n), "<i2").astype(np.float32)
    return (raw / 32768.0).reshape(n, -1).mean(axis=1), rate


def native_checks(d, smi: str) -> dict:
    """The native runtime built from ``native/*.cpp`` on this machine against
    the port's numpy and Python paths: fbank (atol 1e-3, rtol 1e-4), WAV
    decoding (1e-6 of ``read_wav``; its time on a 10 s WAV beside ``wave``'s,
    serving's two decoders), the threaded loader (1e-4 of the numpy
    fbank of the PCM16 waveforms, padded with zeros, a corrupted file at
    length 0) and the SentencePiece encoder (equal to the Python Viterbi on
    the synthetic vocabulary, which has no duplicate piece)."""
    import numpy as np

    from seamless_communication_torch import native
    from seamless_communication_torch.audio.fbank import fbank_numpy
    from seamless_communication_torch.audio.wav import read_wav, write_wav
    from seamless_communication_torch.text.spm import SentencePieceModel

    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(31)
    wav = (rng.standard_normal(160000) * 0.1).astype(np.float32)
    t0 = time.perf_counter()
    fb = native.fbank_native(wav)
    fbank_ms = (time.perf_counter() - t0) * 1e3
    fb_err = float(np.abs(fb - fbank_numpy(wav)).max())
    np.testing.assert_allclose(fb, fbank_numpy(wav), atol=1e-3, rtol=1e-4)
    paths = []
    for i, seconds in enumerate((4.0, 7.0, 10.0)):
        p = d / f"native_{i}.wav"
        write_wav(str(p), wav[:int(seconds * 16000)], 16000)
        paths.append(str(p))
    (d / "native_bad.wav").write_bytes(b"not a wav")
    paths.insert(1, str(d / "native_bad.wav"))
    got, rate = native.wav_decode_native(open(paths[0], "rb").read())
    ref, ref_rate = read_wav(paths[0])
    if rate != ref_rate or got.shape != ref.shape or float(np.abs(got - ref).max()) > 1e-6:
        raise AssertionError("3o native: the WAV decode differs from read_wav")
    # serving's decode of an uploaded 10 s WAV: the binding against ``wave``
    # (the other decoder ``_decode_wav_b64`` keeps), median of 20 each
    data = open(paths[-1], "rb").read()
    decode_ms = {}
    for name, fn in (("native", native.wav_decode_native), ("wave", wave_decode)):
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn(data)
            times.append((time.perf_counter() - t0) * 1e3)
        decode_ms[name] = sorted(times)[len(times) // 2]
    t0 = time.perf_counter()
    batches = list(native.NativeFbankLoader(paths, batch_size=4))
    loader_ms = (time.perf_counter() - t0) * 1e3
    (fbs, lens), = batches
    loader_err = 0.0
    for b, p in enumerate(paths):
        if "bad" in p:
            if lens[b] != 0:
                raise AssertionError("3o native: the corrupted file has a length")
            continue
        want = fbank_numpy(read_wav(p)[0])
        if lens[b] != want.shape[0] or fbs[b, lens[b]:].any():
            raise AssertionError(f"3o native: loader row {b} has length {lens[b]}, not "
                                 f"{want.shape[0]}, or is not zero-padded")
        loader_err = max(loader_err, float(np.abs(fbs[b, :lens[b]] - want).max()))
    if loader_err > 1e-4:
        raise AssertionError(f"3o native: the loader differs from the numpy fbank by "
                             f"{loader_err:.3g}")
    spm = SentencePieceModel.from_bytes(synthetic_spm())
    enc = native.NativeSpmEncoder.from_model(spm)
    texts = [synthetic_text(synthetic_tokenizer(), 40, seed) for seed in range(20)]
    texts += ["", " x ", "unknown\U0001d11eglyph", "the a . ,"]
    for t in texts:
        if enc.encode_normalized(spm._normalize(t)) != spm.encode(t):
            raise AssertionError(f"3o native: the SentencePiece encoder differs on {t!r}")
    log(f"3o native runtime (g++ -O3 -march=native): built and loaded in {build_s:.2f} s; "
        f"fbank of 10 s {fbank_ms:.1f} ms, max abs difference to numpy {fb_err:.3g}; WAV "
        f"decode equal to read_wav, of 10 s {decode_ms['native']:.3f} ms (wave "
        f"{decode_ms['wave']:.3f} ms); loader of 4 files (one corrupted, length 0) "
        f"{loader_ms:.1f} ms, {loader_err:.3g} from numpy; SentencePiece encoder equal to "
        f"the Python Viterbi on {len(texts)} texts [{smi}]")
    return {"build_s": build_s, "fbank_10s_ms": fbank_ms, "fbank_err": fb_err,
            "wav_decode_10s_ms": decode_ms,
            "loader_ms": loader_ms, "loader_err": loader_err, "spm_texts": len(texts)}


def phase_eval(smi: str, shared=None, stream_models: Optional[dict] = None) -> dict:
    """3o. The evaluation entry points at full width, ``SEAMLESS_FUSED_ATTN=1``,
    every decode cut to ``EVAL_MAX_LEN + 2`` tokens:

    a. The native runtime against the numpy and Python paths
       (``native_checks``).
    b. ``cli.evaluate.main`` (m4t_evaluate) S2TT on base_v2's fp16 ``.pt``
       (3h's in ``shared``, else written here from seed 7, with a vocoder
       ``.pt`` from seed 6) over a TSV of four WAVs (4-10 s, the second
       corrupted), one batch, through the native loader: ``run_info.json``
       says native, the corrupted row's hypothesis is empty, the other
       hypotheses pass ``check_hypotheses``.
    c. The ``Transcriber`` on the loaded tree: 10 s, then 24 s with a
       silence at 11.5-12.5 s that the VAD splits; tokens, times, the wall;
       ``lid_scores`` on the 10 s input.
    d. ``cli.evaluate.main`` S2ST with ``--compute_asr_bleu`` on two of the
       WAVs: the port's own Transcriber scores the written WAVs
       (``s2st_asr_bleu.json``: "own_asr", a finite score).
    e. ``evaluate_streaming`` over one 10 s S2TT stream on the streaming
       models (``stream_models``, 3i's, else ``seeded_streaming_models(21)``;
       the EMMA decoder's final layer-norm scale drawn at random so that it
       writes words), the decoder cut to 40 tokens: AL and LAAL.

    K1 launches equal 24 a decode step of every beam in (b)-(d) and K6 the
    speech encodes' eligible attentions in (b) and (c), counted from 0
    before each part; (d) launches K6 at least at its encodes (its T2U and
    re-decode add launches no record counts), (e) at least once (as 3i
    holds the streaming re-encode)."""
    import numpy as np
    import torch

    from seamless_communication_torch.assets import load_card
    from seamless_communication_torch.audio.wav import write_wav
    from seamless_communication_torch.checkpoint.fairseq_export import (
        export_unity, export_vocoder,
    )
    from seamless_communication_torch.cli import evaluate
    from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
    from seamless_communication_torch.inference.transcriber import Transcriber
    from seamless_communication_torch.models.unity import model as unity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.vocoder.codehifigan import (
        CodeHifiGanConfig, code_hifigan_init,
    )
    from seamless_communication_torch.ops.kernels import launch_counts, reset_launch_counts
    from seamless_communication_torch.streaming.evaluator import evaluate_streaming
    from seamless_communication_torch.streaming.pipeline import build_s2t_pipeline
    from seamless_communication_torch.text.nllb import NllbTokenizer
    from seamless_communication_torch.text.spm import SentencePieceModel

    dev = torch.device("cuda")
    cfg = get_arch("base_v2")
    names = ("decode_attention_int8", "flash_attention")
    max_len = ["--text_generation_max_len_a", "0", "--text_generation_max_len_b",
               str(EVAL_MAX_LEN)]
    stats: dict = {}
    launches = {n: 0 for n in names}

    def run(label: str, fn, exact: bool = True):
        """``fn()`` with its launches counted from 0 and held to the decodes
        and encodes it made; returns (result, wall s, launches)."""
        record: list = []
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with recording_model_calls(record):
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: launch_counts[n] for n in names}
        want = expected_launches(cfg, record)
        k6_ok = got["flash_attention"] == want["flash_attention"] if exact else \
            got["flash_attention"] >= want["flash_attention"]
        if got["decode_attention_int8"] != want["decode_attention_int8"] or not k6_ok:
            raise AssertionError(f"3o {label}: launches {got}, expected {want} from "
                                 f"{record}")
        for n in names:
            launches[n] += got[n]
        return out, wall, got, record

    with fused_attention(True), (contextlib.nullcontext(shared) if shared is not None
                                 else offline_dir()) as d:
        if shared is None:
            kw = dict(dtype=torch.bfloat16, device=dev)
            params = unity.unity_init(torch.Generator(device=dev).manual_seed(7), cfg, **kw)
            torch.save({"model": export_unity(params, dtype=torch.float16)}, d / "unity.pt")
            del params
            vocoder = code_hifigan_init(torch.Generator(device=dev).manual_seed(6),
                                        CodeHifiGanConfig(), **kw)
            torch.save({"generator": export_vocoder(vocoder, dtype=torch.float16)},
                       d / "vocoder.pt")
            del vocoder
            gc.collect()
            write_cards(d)
        stats["native"] = native_checks(d, smi)
        # base_v2's card with a tokenizer whose every id is a word
        n_langs = len(load_card(OFFLINE_CARD)["langs"])
        (d / "words.model").write_bytes(word_tokenizer_spm(cfg.nllb.vocab_size, n_langs))
        (d / f"{EVAL_CARD}.yaml").write_text(
            f"name: {EVAL_CARD}\nbase: {OFFLINE_CARD}\ntokenizer: {d / 'words.model'}\n")

        rng = np.random.default_rng(32)
        (d / "eval").mkdir(exist_ok=True)
        rows = []
        for i, seconds in enumerate((4.0, 0.0, 7.0, 10.0)):
            if seconds:
                write_wav(str(d / "eval" / f"{i}.wav"),
                          (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(
                              np.float32), 16000)
            else:
                (d / "eval" / f"{i}.wav").write_bytes(b"a corrupted upload")
            rows.append(f"{i}.wav\tthe cat sat on the mat")
        (d / "eval" / "data.tsv").write_text("audio\ttgt_text\n" + "\n".join(rows) + "\n")
        (d / "eval" / "two.tsv").write_text(
            "audio\ttgt_text\n" + "\n".join(rows[2:]) + "\n")
        common = ["--model_name", EVAL_CARD, "--local_pt_path", str(d / "unity.pt"),
                  "--audio_root_dir", str(d / "eval"), *max_len]

        # (b) m4t_evaluate S2TT through the native loader
        res, wall, got, rec = run("m4t_evaluate S2TT", lambda: evaluate.main(
            [str(d / "eval" / "data.tsv"), "s2tt", "eng", "--batch_size", "4",
             "--output_path", str(d / "out_s2tt"), *common]))
        info = json.loads((d / "out_s2tt" / "run_info.json").read_text())
        gen = res.translator.generator.last_result
        if info["loader"] != "native" or res.loader != "native" or res.hypotheses[1] != "":
            raise AssertionError(f"3o m4t_evaluate S2TT: loader {info}, corrupted row "
                                 f"{res.hypotheses[1]!r}")
        check_hypotheses(gen, res.translator.text_tokenizer.target_prefix("eng").tolist(),
                         gen.tokens.shape[-1], cfg.nllb.eos_idx)
        request = {k: v * 1e3 for k, v in res.translator.last_timings.items()}
        log(f"3o m4t_evaluate S2TT, four WAVs (4, corrupted, 7, 10 s) in one batch, the "
            f"native loader: wall {wall:.2f} s (the .pt load included); the batch "
            + ", ".join(f"{k} {v:.1f}" for k, v in request.items())
            + f" ms, {gen.steps} decode steps, {request['text_decode'] / gen.steps:.2f} ms "
            f"a step; K1 {got['decode_attention_int8']}, K6 {got['flash_attention']}; "
            f"scores {res.metrics}; corrupted row empty; hypothesis 0 "
            f"{res.hypotheses[0][:40]!r} [{smi}]")
        stats["evaluate_s2tt"] = {"wall_s": wall, "steps": int(gen.steps),
                                  "request_ms": request, "launches": got,
                                  "metrics": res.metrics, "loader": info["loader"]}
        params, text_tok = res.translator.params, res.translator.text_tokenizer
        del res
        gc.collect()

        # (c) the Transcriber and language identification
        asr = Transcriber(params, cfg, text_tok, text_opts=SequenceGeneratorOptions(
            soft_max_seq_len=(0, EVAL_MAX_LEN)))
        long = (rng.standard_normal(24 * 16000) * 0.1).astype(np.float32)
        long[int(11.5 * 16000):int(12.5 * 16000)] = 0.0
        spans = asr.segmenter.segment_long_input(long)
        if len(spans) < 2:
            raise AssertionError(f"3o Transcriber: the VAD did not split 24 s ({spans})")
        inputs = {"10 s": (rng.standard_normal(10 * 16000) * 0.1).astype(np.float32),
                  "24 s with a silence": long}
        stats["transcriber"] = {}
        for label, wav in inputs.items():
            tr, wall, got, rec = run(f"Transcriber {label}",
                                     lambda wav=wav: asr.transcribe(wav, "eng"))
            times = [t.time_s for t in tr.tokens]
            if not all(0.0 <= t <= len(wav) / 16000 for t in times):
                raise AssertionError(f"3o Transcriber {label}: a token time outside the "
                                     f"input: {times}")
            if not all(0.0 <= t.prob <= 1.0 for t in tr.tokens):
                raise AssertionError(f"3o Transcriber {label}: a probability outside [0, 1]")
            segs = [n for kind, n in rec if kind == "decode"]
            log(f"3o Transcriber {label}: {len(segs)} segment(s) "
                f"{spans if len(segs) > 1 else [(0, len(wav))]}, decode steps {segs}; "
                f"{len(tr.tokens)} tokens, {len(tr.words())} words, times from "
                f"{min(times, default=0):.2f} to {max(times, default=0):.2f} s; wall {wall:.2f} s; K1 "
                f"{got['decode_attention_int8']}, K6 {got['flash_attention']} [{smi}]")
            stats["transcriber"][label] = {"segments": len(segs), "steps": segs,
                                           "tokens": len(tr.tokens), "wall_s": wall,
                                           "launches": got}
        lid, wall, got, _ = run("lid_scores", lambda: asr.lid_scores(inputs["10 s"]))
        if len(lid) != min(5, len(text_tok.lang_to_id)) or not all(
                0.0 <= v <= 1.0 for v in lid.values()):
            raise AssertionError(f"3o lid_scores: {lid}")
        log(f"3o lid_scores 10 s: {wall * 1e3:.1f} ms, top {list(lid.items())[:2]}; K6 "
            f"{got['flash_attention']} [{smi}]")
        stats["lid"] = {"wall_s": wall, "top": lid, "launches": got}
        del asr, params
        gc.collect()

        # (d) m4t_evaluate S2ST with ASR-BLEU through the port's Transcriber
        res, wall, got, rec = run("m4t_evaluate S2ST", lambda: evaluate.main(
            [str(d / "eval" / "two.tsv"), "s2st", "eng", "--batch_size", "2",
             "--vocoder_name", OFFLINE_VOCODER, "--compute_asr_bleu",
             "--output_path", str(d / "out_s2st"), *common]), exact=False)
        scores = json.loads((d / "out_s2st" / "s2st_asr_bleu.json").read_text())
        n_wavs = len(list((d / "out_s2st" / "wavs").glob("*.wav")))
        if scores.get("asr") != "own_asr" or not math.isfinite(scores["asr_bleu"]) \
                or n_wavs != 2:
            raise AssertionError(f"3o m4t_evaluate S2ST: {scores}, {n_wavs} WAVs")
        decodes = [n for kind, n in rec if kind == "decode"]
        log(f"3o m4t_evaluate S2ST with --compute_asr_bleu, two WAVs (7, 10 s): wall "
            f"{wall:.2f} s (the .pt loads included); decodes {decodes} steps (the batch, "
            f"then the Transcriber on each written WAV); ASR-BLEU {scores['asr_bleu']:.2f} "
            f"({scores['asr']}); K1 {got['decode_attention_int8']}, K6 "
            f"{got['flash_attention']} [{smi}]")
        stats["evaluate_s2st"] = {"wall_s": wall, "decodes": decodes, "scores": scores,
                                  "launches": got}
        del res
        gc.collect()

    # (e) evaluate_streaming over one 10 s S2TT stream
    models = stream_models or seeded_streaming_models(21)
    words = NllbTokenizer(SentencePieceModel.from_bytes(word_tokenizer_spm(
        models["mono_cfg"].vocab_size, 2)), langs=["__eng__", "__fra__"])
    # a random final layer-norm scale: the random decoder then writes words
    # instead of repeating the language token, which decodes to nothing
    mono = dict(models["mono"])
    scale = mono["layer_norm"]["scale"]
    mono["layer_norm"] = {**mono["layer_norm"], "scale": torch.randn(
        scale.shape, generator=torch.Generator(device=scale.device).manual_seed(33),
        device=scale.device).to(scale.dtype)}
    pipes = []

    def factory():
        pipe = build_s2t_pipeline(models["unity"], models["cfg"], mono,
                                  models["mono_cfg"], words, tgt_lang="eng")
        text_decoder_agent(pipe).max_len_a = 0
        text_decoder_agent(pipe).max_len_b = 40
        pipes.append(pipe)
        return pipe

    with fused_attention(True):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = evaluate_streaming(factory, [stream_waveform()], references=[
            "the cat sat on the mat"], tgt_lang="eng")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: launch_counts[n] for n in names}
    tokens = text_decoder_agent(pipes[0]).policy_counts["tokens"]
    if not (math.isfinite(metrics["AL_ms"]) and math.isfinite(metrics["LAAL_ms"])) \
            or metrics["num_instances"] != 1 or tokens <= 0 or metrics["AL_ms"] <= 0:
        raise AssertionError(f"3o evaluate_streaming: {metrics}, {tokens} tokens")
    if got["flash_attention"] <= 0:
        raise AssertionError("3o evaluate_streaming: the re-encode never launched K6")
    launches["flash_attention"] += got["flash_attention"]
    log(f"3o evaluate_streaming S2TT, one 10 s stream: {tokens} tokens, AL "
        f"{metrics['AL_ms']:.1f} ms, LAAL {metrics['LAAL_ms']:.1f} ms, BLEU "
        f"{metrics['bleu']:.2f}; wall {wall:.2f} s; K6 {got['flash_attention']} [{smi}]")
    stats["evaluate_streaming"] = {"wall_s": wall, "metrics": metrics, "tokens": tokens,
                                   "launches": got}
    del models, mono, pipes
    gc.collect()
    return {"launches": launches, "stats": stats}


def main() -> int:
    import torch

    dev = phase_device()
    if sys.argv[1:] == ["--profile"]:
        profile_main_path(dev["smi"])
        return 0
    if sys.argv[1:2] in (["--k6-parts"], ["--k6b-parts"], ["--k6c-parts"], ["--k3b-parts"],
                         ["--k3a-parts"], ["--k4-parts"]):
        which = sys.argv[1][2:].split("-")[0]
        dtypes = sys.argv[2:] or ["bf16"]
        if len(dtypes) > 1 or dtypes[0] not in ("bf16", "fp32") or (
                dtypes != ["bf16"] and which not in ("k6b", "k6c")):
            raise SystemExit(f"chip_smoke: {sys.argv[1]} takes no dtype or one of bf16, fp32 "
                             "(fp32 for --k6b-parts and --k6c-parts)")
        kernel_parts(dev["smi"], which, dtypes[0])
        return 0
    if sys.argv[1:] == ["--k12-trace"]:
        k12_trace(dev["smi"])
        return 0
    if sys.argv[1:] == ["--k5-trace"]:
        k5_trace(dev["smi"])
        return 0
    if sys.argv[1:] == ["--offline"]:
        phase_offline(dev["smi"])
        phase_tiny_offline()
        return 0
    if sys.argv[1:] == ["--streaming"]:
        k6s = streaming_flash_case(dev["smi"])
        streaming = phase_streaming(dev["smi"], record=False)
        phase_tiny_streaming()
        log(json.dumps({"streaming": streaming["stats"], "k6_streaming": k6s,
                        "k6_launches_3i": streaming["launches"], "card": dev["smi"]}))
        return 0
    if sys.argv[1:] == ["--serving"]:
        floor_ms = launch_floor_ms()
        k1b = timed("2 K1 batched", decode_batch_case, dev["smi"], floor_ms)
        k6a = timed("2 K6 adaptor", adaptor_flash_case, dev["smi"])
        translator, tok, cfg, _ = timed("3 base_v2 build", build_base_v2)
        serving = timed("3k", phase_serving, translator, tok, cfg, dev["smi"])
        del translator
        gc.collect()
        streaming = timed("3i", phase_streaming, dev["smi"])
        pool = timed("3l", phase_pool, dev["smi"], streaming.pop("models"),
                     streaming["single"])
        timed("4 serving", phase_tiny_serving)
        log(json.dumps({"k1_batched": k1b, "k6_adaptor": k6a, "serving": serving["stats"],
                        "launches_3k": serving["launches"], "pool": pool["stats"],
                        "launches_3l": pool["launches"], "phase_s": PHASE_S,
                        "card": dev["smi"]}))
        return 0
    if sys.argv[1:] == ["--finetune"]:
        k6r = timed("2 K6 per-rank heads", rank_flash_case, dev["smi"])
        ft = timed("3m", phase_finetune, dev["smi"])
        log(json.dumps({"finetune": ft, "k6_per_rank": k6r, "phase_s": PHASE_S,
                        "card": dev["smi"]}))
        return 0
    if sys.argv[1:] == ["--eval"]:
        ev = timed("3o", phase_eval, dev["smi"])
        log(json.dumps({"eval": ev["stats"], "launches_3o": ev["launches"],
                        "phase_s": PHASE_S, "card": dev["smi"]}))
        return 0
    if sys.argv[1:] == ["--aux"]:
        aux = timed("3n", phase_aux, dev["smi"])
        log(json.dumps({"aux": aux["stats"], "launches_3n": aux["launches"],
                        "phase_s": PHASE_S, "card": dev["smi"]}))
        return 0
    if sys.argv[1:] == ["--expressive"]:
        k6p = timed("2 K6 PRETSSEL", pretssel_flash_case, dev["smi"])
        expressive = timed("3j", phase_expressive, dev["smi"])
        timed("4 expressive", phase_tiny_expressive)
        log(json.dumps({"expressive": expressive["stats"], "k6_pretssel": k6p,
                        "launches_3j": expressive["launches"], "phase_s": PHASE_S,
                        "card": dev["smi"]}))
        return 0
    floor_ms = launch_floor_ms()
    log(f"launch floor (a one-element in-place add, CUDA-graph replay): "
        f"{floor_ms * 1e3:.2f} us [{dev['smi']}]")
    k1 = timed("2 K1", phase_decode_attention, "decode_attention_int8", floor_ms)
    k2 = timed("2 K2", phase_decode_attention, "decode_attention_int4", floor_ms)
    k5 = timed("2 K5", phase_indexed, dev["smi"], floor_ms)
    k4 = timed("2 K4", phase_fbank, dev["smi"], floor_ms)
    k3b, k3a = timed("2 K3", phase_vocab_topk, dev["smi"])
    k6 = timed("2 K6", phase_flash_attention, dev["smi"])
    # the 3i re-encode's shape and 3j's PRETSSEL decoder
    k6["streaming"] = timed("2 K6 streaming", streaming_flash_case, dev["smi"])
    k6["pretssel"] = timed("2 K6 PRETSSEL", pretssel_flash_case, dev["smi"])
    # 3k's batched decode and 3l's pooled adaptor
    k1["batched"] = timed("2 K1 batched", decode_batch_case, dev["smi"], floor_ms)
    k6["adaptor"] = timed("2 K6 adaptor", adaptor_flash_case, dev["smi"])
    # 3n's XLSR2-1B encoder: head dim 80
    k6["xlsr"] = timed("2 K6 XLSR", xlsr_flash_case, dev["smi"])
    k6b, k6c = timed("2 K6b K6c", phase_flash_attention_bwd, dev["smi"])
    # 3m's per-rank heads under model=2
    rank = timed("2 K6 per-rank heads", rank_flash_case, dev["smi"])
    for row in (k6, k6b, k6c):
        row["per_rank_h8"] = {dt: rank[dt][row["name"]] for dt in rank}
    timed("2 sweep", phase_flash_sweep, dev["smi"])
    if sys.argv[1:] == ["--kernels"]:
        return 0
    base_v2 = timed("3 base_v2 build", build_base_v2)
    # each kernel's launches are counted over its own path, reset just before
    s2tt = timed("3a", phase_s2tt, *base_v2, dev["smi"])
    k1["launches"] = s2tt["launches"]
    s2st = timed("3b", phase_s2st, *base_v2, dev["smi"])
    k2["launches"] = s2st["launches"]
    translator, tok, cfg, noise = base_v2
    t2t = timed("3c", phase_t2t, translator, tok, cfg, dev["smi"])
    k3b["launches"] = t2t["launches"]["vocab_topk_v2"]
    k3a["launches"] = t2t["launches"]["vocab_topk"]     # not on any path: 0
    lazy = timed("3d", phase_lazy, *base_v2, dev["smi"])
    k5["launches"] = lazy["launches"]["decode_attention_indexed"]
    k4["launches"] = lazy["launches"]["fbank"]          # not on any path: 0
    fused = timed("3e", phase_fused, *base_v2, dev["smi"])
    serving = timed("3k", phase_serving, translator, tok, cfg, dev["smi"])
    k1["launches_3k"] = serving["launches"]
    vocoder = (translator.vocoder_params, translator.vocoder_cfg)
    del base_v2, translator
    gc.collect()        # 3d's MinTox translator holds base_v2's tree in a cycle
    log(f"base_v2 released: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    v1_translator, v1_cfg = build_base_v1(*vocoder)
    v1 = timed("3f", phase_v1, v1_translator, v1_cfg, noise, dev["smi"])
    k6["launches"] = fused["launches"]["flash_attention"] + v1["launches"]["flash_attention"]
    del v1_translator, vocoder
    gc.collect()
    # 3h's fp16 base_v2 .pt and cards stay for 3m (finetuning)
    shared = contextlib.ExitStack()
    ft_dir = shared.enter_context(offline_dir())
    offline = timed("3h", phase_offline, dev["smi"], ft_dir)
    k1["launches_3h"] = offline["launches"]     # 3h's m4t_predict S2ST request
    gc.collect()
    streaming = timed("3i", phase_streaming, dev["smi"])
    k6["launches"] += streaming["launches"]
    k6["launches_3i"] = streaming["launches"]
    gc.collect()
    # 3j's stream, 3l's pool and 3o's evaluation run on 3i's loaded streaming models
    stream_models = streaming["models"]
    expressive = timed("3j", phase_expressive, dev["smi"], stream_models)
    k1["launches_3j"] = expressive["launches"]["decode_attention_int8"]
    k6["launches"] += expressive["launches"]["flash_attention"]
    k6["launches_3j"] = expressive["launches"]["flash_attention"]
    gc.collect()
    pool = timed("3l", phase_pool, dev["smi"], streaming.pop("models"), streaming["single"])
    k6["launches"] += pool["launches"]
    k6["launches_3l"] = pool["launches"]
    gc.collect()
    train = timed("3g", phase_train, dev["smi"])
    k6["launches"] += train["launches"]["flash_attention"]
    for row, name in ((k6b, "flash_attention_bwd_dkv"), (k6c, "flash_attention_bwd_dq")):
        row["launches"] = train["launches"][name]
        row["launches_fp32"] = train["launches_fp32"][name]   # 3g's fp32 gradient parity
    gc.collect()
    with shared:
        finetune = timed("3m", phase_finetune, dev["smi"], ft_dir)
        for row in (k6, k6b, k6c):
            row["launches_3m"] = finetune["cli"]["launches"][row["name"]]
            row["launches"] += row["launches_3m"]
        gc.collect()
        # 3o reads 3h's .pt and cards too
        evaluation = timed("3o", phase_eval, dev["smi"], ft_dir, stream_models)
    del stream_models
    k1["launches_3o"] = evaluation["launches"]["decode_attention_int8"]
    k6["launches_3o"] = evaluation["launches"]["flash_attention"]
    k6["launches"] += k6["launches_3o"]
    gc.collect()
    aux = timed("3n", phase_aux, dev["smi"])
    k6["launches_3n"] = aux["launches"]
    k6["launches"] += aux["launches"]
    for label, phase in (("4 cuda vs cpu", phase_tiny_cuda_vs_cpu),
                         ("4 s2st", phase_tiny_s2st), ("4 t2t", phase_tiny_t2t),
                         ("4 options", phase_tiny_options),
                         ("4 v1 and fused", phase_tiny_v1_and_fused),
                         ("4 offline", phase_tiny_offline),
                         ("4 streaming", phase_tiny_streaming),
                         ("4 expressive", phase_tiny_expressive),
                         ("4 serving", phase_tiny_serving),
                         ("4 train", phase_tiny_train)):
        timed(label, phase)
    log(json.dumps({"main_path": s2tt["requests"] + s2st["requests"] + t2t["requests"],
                    "lazy": lazy["requests"], "fused": fused["requests"],
                    "v1": v1["requests"], "offline": offline["stats"],
                    "streaming": streaming["stats"], "expressive": expressive["stats"],
                    "serving": serving["stats"], "pool": pool["stats"],
                    "train": train, "finetune": finetune, "aux": aux["stats"],
                    "eval": evaluation["stats"],
                    "phase_s": PHASE_S, "card": dev["smi"]}))
    log(json.dumps({"kernels": [k1, k2, k3a, k3b, k4, k5, k6, k6b, k6c]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
