"""The port's batched multi-session streaming pool (``streaming/multi.py``)
and the row-wise pieces under it, fp32 on the CPU, on the tiny chunk-causal
card and policy (``KW``) of tests/integration/test_streaming_multi.py, the
JAX parameters carried across by ``checkpoint/from_jax.py``.

- The row-wise pieces against the same function on each row alone: the
  incremental encoder step at four per-slot offsets (within 1e-5), the
  decision statistic in each method (exactly), and the write burst (tokens
  and ``finished`` exactly, statistics within 1e-5).
- The pool against JAX's ``BatchedStreamingPool`` on a staggered schedule of
  three sessions of different lengths in four slots: every segment's tokens,
  text and ``finished`` flag exactly.
- The pool against the port's single-session incremental agent (which
  tests/test_torch_streaming.py holds to JAX's): with an idle slot beside,
  with the EMMA decoder int8, with a slot reused, and through
  ``StreamingPoolService`` over HTTP with its error codes."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from seamless_communication_tpu.models.monotonic.model import (
    MonotonicDecoderConfig as JMonoConfig, monotonic_decoder_init as jmono_init,
)
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.models.wav2vec2.encoder import (
    SpeechEncoderConfig as JSpeechConfig,
)
from seamless_communication_tpu.ops.conformer import ConformerConfig as JConformer
from seamless_communication_tpu.streaming.multi import (
    BatchedStreamingPool as JBatchedStreamingPool,
)
from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

from seamless_communication_torch.checkpoint.from_jax import (
    monotonic_params_from_jax, unity_params_from_jax,
)
from seamless_communication_torch.inference.serving import serve
from seamless_communication_torch.models.monotonic import model as mono
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.wav2vec2 import incremental
from seamless_communication_torch.models.wav2vec2.encoder import SpeechEncoderConfig
from seamless_communication_torch.ops.conformer import ConformerConfig
from seamless_communication_torch.ops.quantization import quantize_params
from seamless_communication_torch.streaming import pipeline
from seamless_communication_torch.streaming.multi import BatchedStreamingPool
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
)

SEG = 5120  # 320 ms at 16 kHz
KW = dict(min_starting_wait=16, decision_threshold=0.001, max_len_b=12,
          max_consecutive_writes=6)
BASE = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
        ("</s>", 0.0, TYPE_CONTROL)]
TEXT_SPM = build_spm_model(BASE + [(w, -2.0, TYPE_NORMAL)
                                   for w in ["▁aa", "▁bb", "▁cc", ",", "."]])
LANGS = ["__eng__", "__fra__"]
CONF = dict(dim=64, ffn_inner_dim=128, num_heads=4, num_layers=2, depthwise_kernel_size=7,
            pos_type="shaw", shaw_max_left=8, shaw_max_right=3, causal_depthwise_conv=True)
SPEECH = dict(model_dim=64, feature_dim=160, ffn_inner_dim=128, num_adaptor_heads=4,
              chunk_size=4, left_chunk_num=-1)
MONO = dict(model_dim=64, num_layers=2, num_heads=4, ffn_inner_dim=128, vocab_size=256,
            num_monotonic_energy_layers=2, pre_decision_ratio=2)
# (start tick, seconds, tone Hz) of the staggered schedule
STAGGERED = [(0, 2.0, 300), (2, 1.5, 440), (3, 1.0, 520)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wave(freq: float, seconds: float = 2.0) -> np.ndarray:
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.1 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget_arch("tiny_v2"), speech=JSpeechConfig(
        conformer=JConformer(**CONF), **SPEECH))
    cfg = dataclasses.replace(get_arch("tiny_v2"), speech=SpeechEncoderConfig(
        conformer=ConformerConfig(**CONF), **SPEECH))
    jparams = junity.unity_init(jax.random.PRNGKey(3), jcfg)
    jmono = jmono_init(jax.random.PRNGKey(5), JMonoConfig(**MONO))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    jax_side = dict(cfg=jcfg, unity=jparams, mono=jmono, mono_cfg=JMonoConfig(**MONO),
                    text=JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), LANGS))
    port = dict(cfg=cfg, unity=unity_params_from_jax(np_tree(jparams)),
                mono=monotonic_params_from_jax(np_tree(jmono)),
                mono_cfg=mono.MonotonicDecoderConfig(**MONO),
                text=NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), LANGS))
    return jax_side, port


def make_pool(m, cls, n_slots, **kw):
    return cls(m["unity"], m["cfg"], m["mono"], m["mono_cfg"], m["text"], n_slots=n_slots,
               **dict(dict(KW, mono_quantize_int8=False), **kw))


def port_pool(m, n_slots, **kw):
    return make_pool(m, BatchedStreamingPool, n_slots, device="cpu", **kw)


def single_session(m, wav):
    """The port's single-session incremental agent on ``wav`` -> (tokens,
    the statistic at each decision)."""
    pipe = pipeline.build_s2t_pipeline(
        m["unity"], m["cfg"], m["mono"], m["mono_cfg"], m["text"], tgt_lang="eng",
        fused="incremental", min_starting_wait_w2vbert=KW["min_starting_wait"],
        decision_threshold=KW["decision_threshold"], max_len_b=KW["max_len_b"],
        max_consecutive_writes=KW["max_consecutive_writes"], mono_quantize_int8=False,
        device="cpu")
    list(pipeline.StreamingSession(pipe, segment_size_ms=320, tgt_lang="eng").run(wav))
    return list(pipe.agents[1].states.target_indices), list(pipe.agents[1].decision_stats)


def single_session_tokens(m, wav):
    return single_session(m, wav)[0]


def same_decisions(pool, sid, want_stats):
    """The pooled session's statistics are the single session's, within
    1e-5 (they read the encoder output, which the tokens of a tiny model
    barely do)."""
    got = [st for st, _, _ in pool.session_decisions(sid)]
    assert len(got) == len(want_stats)
    np.testing.assert_allclose(got, want_stats, rtol=1e-5, atol=1e-5)


def drive(pool, schedule, max_ticks=128):
    """``schedule``: (start tick, waveform) a session. A session opens at its
    start tick and pushes one 320 ms chunk a tick (finished on its last);
    the pool steps once a tick until every session has finished. Returns
    each session's segments as (tokens, text, finished) and its tokens."""
    n_chunks = [max(1, -(-len(w) // SEG)) for _, w in schedule]
    sids, segs = {}, {i: [] for i in range(len(schedule))}
    for tick in range(max_ticks):
        for i, (start, w) in enumerate(schedule):
            if tick == start:
                sids[i] = pool.open_session(tgt_lang="eng")
            j = tick - start
            if 0 <= j < n_chunks[i]:
                pool.push(sids[i], w[j * SEG:(j + 1) * SEG], finished=j == n_chunks[i] - 1)
        pool.step()
        for i, sid in sids.items():
            segs[i] += [(list(g.token_indices), g.text, g.finished) for g in pool.pop(sid)]
        if len(sids) == len(schedule) and all(pool.session_finished(s)
                                              for s in sids.values()):
            return segs, {i: pool.session_tokens(s) for i, s in sids.items()}
    raise AssertionError(f"the sessions did not finish in {max_ticks} ticks")


# ---------------------------------------------------------------------------
# the row-wise pieces
# ---------------------------------------------------------------------------

def test_incremental_step_at_per_slot_offsets(models):
    """Four slots at offsets 0, 4, 8 and 16 stacked frames, the last block
    partial in two of them: each row of one batched step equals that slot's
    step alone (keys, values, output rows, conv tail, the adaptor output and
    its length)."""
    _, m = models
    sp, se = m["cfg"].speech, m["unity"]["speech_encoder"]
    rng = np.random.default_rng(0)
    block = lambda: torch.as_tensor(rng.standard_normal((1, 16, 80)),  # noqa: E731
                                    dtype=torch.float32)
    alone = []
    for blocks in (0, 1, 2, 4):          # 8 stacked frames a block
        st = incremental.speech_encoder_stream_init(sp, max_frames=64)
        for _ in range(blocks):
            st = incremental.speech_encoder_stream_step(se, st, block(), sp)
        alone.append(st)
    starts = tuple(int(st.n[0]) for st in alone)
    assert starts == (0, 8, 16, 32)
    stack = lambda f: torch.cat([f(st) for st in alone], dim=1)  # noqa: E731
    batched = alone[0]._replace(k=stack(lambda s: s.k.clone()), v=stack(lambda s: s.v.clone()),
                                conv_tail=stack(lambda s: s.conv_tail.clone()),
                                buf=torch.cat([s.buf.clone() for s in alone]),
                                n=torch.tensor(starts))
    new = torch.cat([block() for _ in alone])
    valid = (8, 5, 8, 3)
    got = incremental.speech_encoder_stream_step(se, batched, new, sp, n_valid=valid)
    assert got.n.tolist() == [a + b for a, b in zip(starts, valid)]
    enc, lens = incremental.speech_encoder_stream_output(se, got, sp)
    for b, st in enumerate(alone):
        want = incremental.speech_encoder_stream_step(se, st, new[b:b + 1], sp,
                                                      n_valid=valid[b])
        wenc, wlens = incremental.speech_encoder_stream_output(se, want, sp)
        end = starts[b] + 8
        for a, w in ((got.k[:, b, :, :end], want.k[:, 0, :, :end]),
                     (got.v[:, b, :, :end], want.v[:, 0, :, :end]),
                     (got.buf[b, :end], want.buf[0, :end]),
                     (got.conv_tail[:, b], want.conv_tail[:, 0]), (enc[b], wenc[0])):
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
        assert int(lens[b]) == int(wlens[0])


@pytest.mark.parametrize("method", ["min", "mean", "median"])
def test_decision_stat_rows(models, method):
    """(3, L * H = 8, Sp) p_choose with a last valid key a row: each row's
    statistic equals the statistic of that row alone; 8 heads make the
    median's count even."""
    _, m = models
    pcs = torch.as_tensor(np.random.default_rng(1).uniform(size=(3, 8, 6)),
                          dtype=torch.float32)
    sp_valid = [5, 2, 6]
    got = mono.decision_stat(pcs, m["mono_cfg"], start_layer=0, sp_valid=sp_valid,
                             method=method)
    assert got.shape == (3,)
    for b in range(3):
        one = mono.decision_stat(pcs[b:b + 1], m["mono_cfg"], start_layer=0,
                                 sp_valid=sp_valid[b], method=method)
        assert float(got[b]) == float(one[0])
        want = {"min": np.min, "mean": np.mean, "median": np.median}[method](
            pcs[b, :, sp_valid[b] - 1].numpy())
        np.testing.assert_allclose(float(got[b]), want, rtol=1e-6)


# (threshold, source finished, max_len) a row; one row starts inactive
BURST_ROWS = [
    (0.0, [False, True, False], [64, 8, 64]),
    (0.5, [False, False, True], [64, 64, 6]),
    (1.0, [True, False, False], [9, 64, 64]),
]


@pytest.mark.parametrize("threshold,src_fin,max_len", BURST_ROWS)
def test_batched_burst_equals_each_row(models, threshold, src_fin, max_len):
    """Three rows with contexts of 3, 5 and 2 tokens (padded to 16) over
    encoder outputs with 9, 11 and 4 valid frames: the batched prefill and
    burst give each row the tokens, ``finished`` and statistics of the same
    prefill and burst on that row alone; an inactive fourth row writes
    nothing."""
    _, m = models
    cfg, params = m["mono_cfg"], m["mono"]
    rng = np.random.default_rng(2)
    S = 11
    enc = torch.as_tensor(rng.standard_normal((4, S, 64)), dtype=torch.float32)
    valid = [9, 11, 4, 6]
    mask = torch.arange(S)[None] < torch.tensor(valid)[:, None]
    ctx = [[3, 252, 17], [3, 252, 40, 41, 42], [3, 253], [3, 252]]
    tokens = torch.zeros((4, 16), dtype=torch.long)
    for b, c in enumerate(ctx):
        tokens[b, :len(c)] = torch.tensor(c)
    n_tok = [len(c) for c in ctx]
    kw = dict(decision_threshold=threshold, decision_method="min", p_choose_start_layer=0,
              eos_idx=3, max_writes=6, with_gaps=True)
    sp_valid = [-(-v // 2) for v in valid]
    lg, _, pcs, cache = mono.monotonic_encode_and_prefill(params, tokens, n_tok, enc, 32,
                                                          cfg, enc_padding_mask=mask)
    bursts = mono.monotonic_write_burst_rows(
        params, cache, n_tok, lg, pcs, cfg, sp_valid=sp_valid, max_len=max_len + [64],
        n_context=n_tok, source_finished=src_fin + [True],
        active=[True, True, True, False], enc_padding_mask=mask, **kw)
    assert bursts[3].tokens == [] and bursts[3].stats == []
    for b in range(3):
        lg1, _, pcs1, cache1 = mono.monotonic_encode_and_prefill(
            params, tokens[b:b + 1, :8], n_tok[b], enc[b:b + 1], 32, cfg,
            enc_padding_mask=mask[b:b + 1])
        want = mono.monotonic_write_burst(
            params, cache1, n_tok[b], lg1, pcs1, cfg, sp_valid=sp_valid[b],
            max_len=max_len[b], n_context=n_tok[b], source_finished=src_fin[b],
            enc_padding_mask=mask[b:b + 1], **kw)
        got = bursts[b]
        assert got.tokens == want.tokens and got.finished == want.finished
        np.testing.assert_allclose(got.stats, want.stats, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.gaps, want.gaps, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.features.numpy(), want.features.numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert any(len(bursts[b].tokens) for b in range(3))


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def test_pool_matches_jax_pool_staggered(models):
    """Three sessions of 2, 1.5 and 1 s opening at ticks 0, 2 and 3 in four
    slots: every segment of every session equals JAX's pool's, and each
    session's statistics equal its single-session run's."""
    jm, m = models
    schedule = [(start, wave(hz, s)) for start, s, hz in STAGGERED]
    want_segs, want = drive(make_pool(jm, JBatchedStreamingPool, 4), schedule)
    pool = port_pool(m, 4, record_decisions=True)
    got_segs, got = drive(pool, schedule)
    assert got_segs == want_segs
    assert got == want and all(len(t) > 0 for t in got.values())
    assert all(segs[-1][2] for segs in got_segs.values())
    for sid, (_, w) in zip(sorted(pool._sessions), schedule):
        tokens, stats = single_session(m, w)
        assert pool.session_tokens(sid) == tokens
        same_decisions(pool, sid, stats)


@pytest.mark.parametrize("quantize", [False, True])
def test_pool_matches_single_session(models, quantize):
    """One pooled session with an idle slot beside it writes the tokens of
    the port's single-session incremental agent, with the EMMA decoder fp32
    and int8 weight-only (the tiny tables quantized with ``min_size=1``, as
    tests/test_torch_streaming.py quantizes them)."""
    _, m = models
    if quantize:
        m = dict(m, mono=quantize_params(m["mono"], min_size=1))
    wav = wave(300)
    want, want_stats = single_session(m, wav)
    pool = port_pool(m, 2, record_decisions=True)
    assert ("weight_i8" in pool.mono_params["layers"][0]["ffn"]["inner_proj"]) == quantize
    segs, got = drive(pool, [(0, wav)])
    assert got[0] == want and len(want) > 0
    same_decisions(pool, next(iter(pool._sessions)), want_stats)
    assert [t for toks, _, _ in segs[0] for t in toks] == want
    assert segs[0][-1][2]
    sid = next(iter(pool._sessions))
    decisions = pool.session_decisions(sid)
    assert [t for _, _, t in decisions if t is not None] == want
    assert all(gap >= 0.0 for _, gap, _ in decisions)


def test_pool_slot_reuse(models):
    """With one slot: a second open raises while the first session holds it;
    after closing it, a new session in the same slot starts from a reset
    state and writes its single-session tokens."""
    _, m = models
    wav_b = wave(500)
    want_b = single_session_tokens(m, wav_b)
    pool = port_pool(m, 1)
    drive(pool, [(0, wave(300))])
    a = next(iter(pool._sessions))
    assert pool.session_finished(a)
    with pytest.raises(RuntimeError):
        pool.open_session(tgt_lang="eng")
    pool.close_session(a)
    _, got = drive(pool, [(0, wav_b)])
    assert got[0] == want_b


def test_pool_service_over_http(models):
    """``serve(stream_pool=...)``: two concurrent sessions over a real
    socket each write their single-session tokens; a third open while both
    slots are held gets 503; an unknown session and a push after the source
    finished get 400."""
    _, m = models
    wavs = {"a": wave(300), "b": wave(440, 1.5)}
    want = {k: single_session_tokens(m, w) for k, w in wavs.items()}
    srv = serve(stream_pool=port_pool(m, 2), port=0, stream_tick_ms=10)
    port = srv.server_address[1]

    def post(path, obj):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/stream/{path}",
                                     data=json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    sids = {k: post("open", {"tgt_lang": "eng"})[1]["session_id"] for k in wavs}
    results = {}

    def client(key):
        w, sid, toks = wavs[key], sids[key], []
        n = max(1, -(-len(w) // SEG))
        for i in range(n):
            _, out = post("push", {"session_id": sid,
                                   "samples": w[i * SEG:(i + 1) * SEG].tolist(),
                                   "finished": i == n - 1})
            toks += [t for g in out["segments"] for t in g["tokens"]]
        for _ in range(256):
            _, out = post("poll", {"session_id": sid})
            toks += [t for g in out["segments"] for t in g["tokens"]]
            if out["finished"]:
                break
        results[key] = toks

    try:
        code, body = post("open", {"tgt_lang": "eng"})
        assert code == 503 and "busy" in body["error"]
        threads = [threading.Thread(target=client, args=(k,)) for k in wavs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        code, body = post("push", {"session_id": sids["a"], "samples": [0.0] * 160})
        assert code == 400 and "already finished" in body["error"]
        for sid in sids.values():
            assert post("close", {"session_id": sid}) == (200, {"status": "closed"})
        code, body = post("poll", {"session_id": 999})
        assert code == 400 and "unknown session" in body["error"]
    finally:
        srv.shutdown()
        srv.stream_service.stop()
    assert results == want


def test_pool_session_outgrowing_the_state(models):
    """``max_stream_frames`` = 80 stacked frames (five blocks of 16): session
    A's 1.5 s (75 frames) fit, its first drain pump would not, and it ends
    there with a finished segment and a prefix of its single-session tokens;
    session C pushes audio without end and gets ``ValueError`` once it holds
    80 frames, after it ended at the block that would not fit; session B (1 s)
    beside them writes its single-session tokens. No step raises, and every
    finished session's slot is back at count 0."""
    _, m = models
    wav_a, wav_b, wav_c = wave(440, 1.5), wave(520, 1.0), wave(300, 4.0)
    pool = port_pool(m, 4, max_stream_frames=80)
    a, c = pool.open_session(tgt_lang="eng"), pool.open_session(tgt_lang="eng")
    b = None
    chunks = lambda w: [w[i:i + SEG] for i in range(0, len(w), SEG)]  # noqa: E731
    pushes = {a: chunks(wav_a), c: chunks(wav_c)}
    segs, refused = {}, []
    for tick in range(64):
        if tick == 1:
            b = pool.open_session(tgt_lang="eng")
            pushes[b] = chunks(wav_b)
        for sid, left in pushes.items():
            if left and not pool.session_source_finished(sid):
                chunk = left.pop(0)
                try:
                    pool.push(sid, chunk, finished=sid != c and not left)
                except ValueError as e:
                    assert sid == c and "outgrew max_stream_frames" in str(e)
                    refused.append(tick)
        pool.step()
        for sid in pushes:
            segs.setdefault(sid, []).extend(pool.pop(sid))
        if refused and all(pool.session_finished(s) for s in pushes):
            break
    assert all(pool.session_finished(s) for s in pushes)
    assert refused and pool.session_finished(c) and not pool.session_source_finished(c)
    assert pool.session_tokens(b) == single_session_tokens(m, wav_b)
    alone = single_session_tokens(m, wav_a)
    got_a = pool.session_tokens(a)
    assert len(got_a) < len(alone) and got_a == alone[:len(got_a)]
    # all of A's audio taken up (1.5 s: 74 stacked frames), then no drain pump fits
    assert pool._sessions[a].n_stacked == 74
    for sid in (a, c):
        assert segs[sid][-1].finished and segs[sid][-1].token_indices == []
    assert pool.enc_state.n.tolist() == [0, 0, 0, 0]
    pool.close_session(b)
    assert pool.open_session(tgt_lang="eng") == 3
