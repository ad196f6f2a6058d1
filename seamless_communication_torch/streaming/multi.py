"""Batched multi-session streaming: N concurrent S2T streams on one card
(counterpart of ``seamless_communication_tpu/streaming/multi.py``).

The streaming agents of ``streaming/pipeline.py`` serve one session each.
``BatchedStreamingPool`` runs up to ``n_slots`` independent sessions through
one batched chunk, ``streaming/fused.py batched_incremental_s2t_chunk``: the
incremental encoder, the monotonic prefill and the EMMA write burst of the
single-session incremental agent, with a leading slot axis, so every product
of the chunk is one product over all slots instead of one a session:

- every chunk runs all ``n_slots`` rows, the idle ones on zero frames
  (``n_valid`` 0) with their outputs thrown away, so the shapes do not
  change as sessions come and go;
- each slot's encoder state is taken up by a ``commit`` mask (the monotonic
  cache is rebuilt from the context every chunk, so a decode whose outputs
  are ignored changes nothing), and ``source_finished`` is per slot;
- the write burst loops while any slot writes, one host copy of every
  slot's decision a token; a block that is only taken up runs no decode,
  and the sessions' block queues of a step end together, so that their
  decodes share one chunk and one burst;
- a session whose next block would outgrow the encoder state
  (``max_stream_frames`` stacked frames) is ended there with a final
  segment, so that no session's length reaches another's chunk. The JAX
  pool's ``dynamic_update_slice`` clamps such a session's writes instead
  and lets it run on over its overwritten rows.

The host policy (the feature extractor's tick, ``min_starting_wait``,
``min_input_length``, the block plan, ``max_len`` and the drain after the
source ends) copies the JAX pool's, token for token, and so the single-session
``IncrementalFusedMMASpeechToTextDecoderAgent``'s: each session gets the
tokens it would get alone (``tests/test_torch_streaming_multi.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.models.monotonic.model import MonotonicDecoderConfig
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.models.wav2vec2.incremental import (
    speech_encoder_stream_init,
)
from seamless_communication_torch.streaming.agents.common import (
    EmptySegment, Segment, SpeechSegment, WriteAction,
)
from seamless_communication_torch.streaming.agents.online_feature_extractor import (
    OnlineFeatureExtractorAgent,
)
from seamless_communication_torch.streaming.fused import (
    _float_dtype, batched_incremental_s2t_chunk, encoder_output_length,
)
from seamless_communication_torch.streaming.pipeline import _maybe_quantize_mono
from seamless_communication_torch.utils.profiling import TRACER

__all__ = ["BatchedStreamingPool", "PooledSegment"]


class PooledSegment:
    """One emitted chunk of a pooled session's output."""

    __slots__ = ("text", "token_indices", "finished")

    def __init__(self, text: str, token_indices: List[int], finished: bool):
        self.text = text
        self.token_indices = token_indices
        self.finished = finished

    def __repr__(self) -> str:
        return (f"PooledSegment(text={self.text!r}, "
                f"tokens={self.token_indices}, finished={self.finished})")


class _Session:
    """The host state of one slot (the incremental agent's and the feature
    extractor's states, without the agent pipeline)."""

    __slots__ = ("sid", "slot", "tgt_lang", "prefix", "feat_agent", "feat_states",
                 "fbank", "fb_consumed", "n_stacked", "last_decode_stacked",
                 "target_indices", "source_finished", "target_finished", "out",
                 "tick_due", "pushed_since_step", "outgrown", "decisions")

    def __init__(self, sid: int, slot: int, tgt_lang: str, prefix: List[int],
                 feat_agent: OnlineFeatureExtractorAgent):
        self.sid = sid
        self.slot = slot
        self.tgt_lang = tgt_lang
        self.prefix = prefix
        self.feat_agent = feat_agent
        self.feat_states = feat_agent.build_states()
        self.fbank: List[np.ndarray] = []     # extracted, maybe not yet encoded
        self.fb_consumed = 0                  # fbank frames taken up by the encoder
        self.n_stacked = 0                    # stacked frames taken up
        self.last_decode_stacked = 0
        self.target_indices: List[int] = []
        self.source_finished = False
        self.target_finished = False
        self.out: List[PooledSegment] = []
        self.tick_due = False          # the feature agent wrote since the last plan
        self.pushed_since_step = False  # no drain pump this step
        self.outgrown = False          # the last block it runs is planned
        # (statistic, top-2 logit gap, token written or None) at each decision,
        # where the pool records them
        self.decisions: List[tuple] = []

    @property
    def fb_len(self) -> int:
        return sum(f.shape[0] for f in self.fbank)


class BatchedStreamingPool:
    """Fixed-slot batched S2T streaming sessions sharing one batched chunk.

    Usage::

        pool = BatchedStreamingPool(unity_params, unity_cfg, mono_params,
                                    mono_cfg, text_tokenizer, n_slots=4)
        a = pool.open_session(tgt_lang="eng")
        b = pool.open_session(tgt_lang="fra")
        pool.push(a, samples_320ms); pool.push(b, samples_320ms)
        pool.step()                  # one batched chunk for all slots
        for seg in pool.pop(a): ...

    The parameters move to ``device`` (the CUDA card unless the caller passes
    ``device="cpu"``); ``mono_quantize_int8=None`` makes the EMMA decoder
    int8 weight-only on the card, as the pipelines do. ``last_timings`` holds
    the wall seconds of the last ``step``'s stages (encoder, prefill, burst;
    each ended by a synchronize on the card), summed over its chunks.
    ``record_decisions`` keeps every decision of every session, with its
    top-2 logit gap (``session_decisions``), for a measurement that compares
    runs; it costs a top-k over the vocabulary a decision."""

    def __init__(self, unity_params: dict, unity_cfg: UnitYConfig, mono_params: dict,
                 mono_cfg: MonotonicDecoderConfig, text_tokenizer, *, n_slots: int = 4,
                 fbank_block: int = 32, max_stream_frames: int = 2048,
                 min_starting_wait: Optional[int] = 192, min_input_length: int = 80,
                 max_len_a: int = 1, max_len_b: int = 200,
                 max_consecutive_writes: int = 50, decision_threshold: float = 0.5,
                 decision_method: str = "min", p_choose_start_layer: int = 0,
                 max_target_len: int = 512, min_gen_len: int = 0,
                 denormalize: bool = False, mono_quantize_int8: Optional[bool] = None,
                 record_decisions: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        sp = unity_cfg.speech
        if not (sp.chunk_size and sp.left_chunk_num == -1
                and sp.conformer.causal_depthwise_conv):
            raise ValueError(
                "BatchedStreamingPool requires a chunk-causal encoder card "
                "(same exactness condition as the incremental fused agent)")
        if fbank_block % (sp.fbank_stride * sp.chunk_size) != 0:
            raise ValueError("fbank_block must cover whole attention chunks")
        self.device = resolve_device(device)
        self.unity_params = params_to(unity_params, self.device)
        self.mono_params = _maybe_quantize_mono(params_to(mono_params, self.device),
                                                mono_quantize_int8)
        self.unity_cfg = unity_cfg
        self.mono_cfg = mono_cfg
        self.text_tokenizer = text_tokenizer
        self.n_slots = n_slots
        self.fbank_block = fbank_block
        self.max_stream_frames = max_stream_frames
        self.min_starting_wait = min_starting_wait
        self.min_input_length = min_input_length
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.max_consecutive_writes = max_consecutive_writes
        self.decision_threshold = decision_threshold
        self.decision_method = decision_method
        self.p_choose_start_layer = p_choose_start_layer
        self.max_target_len = max_target_len
        self.min_gen_len = min_gen_len
        self.denormalize = denormalize
        self.record_decisions = record_decisions
        self.eos_idx = text_tokenizer.vocab_info.eos_idx
        # (n_slots, ...) stacked encoder stream states, a count a slot
        self.enc_state = speech_encoder_stream_init(
            sp, batch=n_slots, max_frames=max_stream_frames,
            dtype=_float_dtype(self.unity_params), device=self.device)
        self.last_timings: Dict[str, float] = {}
        self._sessions: Dict[int, _Session] = {}
        self._slot_owner: List[Optional[int]] = [None] * n_slots
        self._next_sid = 0

    # -- session lifecycle -------------------------------------------------

    @torch.inference_mode()
    def open_session(self, tgt_lang: str = "eng") -> int:
        """Claim a free slot; returns a session id."""
        try:
            slot = self._slot_owner.index(None)
        except ValueError:
            raise RuntimeError(f"all {self.n_slots} slots busy") from None
        sid = self._next_sid
        self._next_sid += 1
        prefix = [self.eos_idx, self.text_tokenizer.lang_token(tgt_lang)]
        sess = _Session(sid, slot, tgt_lang, prefix,
                        OnlineFeatureExtractorAgent(denormalize=self.denormalize))
        self._sessions[sid] = sess
        self._slot_owner[slot] = sid
        self._reset_slot(slot)
        return sid

    @torch.inference_mode()
    def close_session(self, sid: int) -> None:
        sess = self._sessions.pop(sid)
        self._slot_owner[sess.slot] = None
        self._reset_slot(sess.slot)

    def _reset_slot(self, slot: int) -> None:
        """Empty one slot's encoder stream state: its count back to 0, so
        that an idle slot's zero frames are written at the start of its own
        rows and no stale offset widens the other rows' attention."""
        st = self.enc_state
        for t in (st.k[:, slot], st.v[:, slot], st.conv_tail[:, slot], st.buf[slot]):
            t.zero_()
        n = st.n.clone()
        n[slot] = 0
        self.enc_state = st._replace(n=n)

    def _finish(self, sess: _Session, segment: Optional[PooledSegment]) -> None:
        """End a session's target: emit its last segment, free its encoder
        state (the session stays open for ``pop``)."""
        if segment is not None:
            sess.out.append(segment)
        sess.target_finished = True
        self._reset_slot(sess.slot)

    def _feat_tick(self, sess: _Session, seg: Segment) -> None:
        """One feature-extractor cycle (the pipeline's push and pop on the
        fbank agent): keep any fbank written, and arm the decode tick iff the
        agent wrote (after a READ the pipeline does not poll the decoder)."""
        span = TRACER.begin("pool.fbank") if TRACER.on else None
        sess.feat_states.update_source(seg)
        action = sess.feat_agent.policy(sess.feat_states)
        if span is not None:
            TRACER.end(span)
        if isinstance(action, WriteAction):
            sess.tick_due = True
            out = action.content
            if (isinstance(out, Segment) and not out.is_empty
                    and out.content is not None):
                fb = np.asarray(out.content, np.float32)
                if fb.ndim == 2 and fb.shape[0]:
                    sess.fbank.append(fb)

    def push(self, sid: int, samples: np.ndarray, *, finished: bool = False) -> None:
        """Feed a chunk of 16 kHz samples (int16-scaled floats unless the pool
        was built with ``denormalize=True``) to one session. Call
        :meth:`step` afterwards (once an arrival interval, for all
        sessions). A session whose fbank already holds ``max_stream_frames``
        stacked frames raises ``ValueError``, before taking any sample (its
        target ends at the block that would outgrow the encoder state)."""
        sess = self._sessions[sid]
        if sess.source_finished:
            raise ValueError(f"session {sid} source already finished")
        if sess.fb_len // self.unity_cfg.speech.fbank_stride >= self.max_stream_frames:
            raise ValueError(f"session {sid} outgrew max_stream_frames "
                             f"({self.max_stream_frames} stacked frames)")
        span = TRACER.begin("pool.push") if TRACER.on else None
        samples = np.asarray(samples, np.float32)
        if samples.size == 0:
            seg = EmptySegment(finished=finished, tgt_lang=sess.tgt_lang)
        else:
            seg = SpeechSegment(content=list(samples), finished=finished,
                                tgt_lang=sess.tgt_lang)
        self._feat_tick(sess, seg)
        sess.source_finished = finished
        sess.pushed_since_step = True
        if span is not None:
            TRACER.count("pool.audio_samples", samples.size)
            TRACER.end(span)

    # -- the batched tick --------------------------------------------------

    def _plan(self, sess: _Session) -> list:
        """This tick's block queue for one session, a list of (fbank block,
        n_valid, frames consumed, commit, decoded), or [] when the slot idles.

        The block schedule of one incremental agent's policy call: full
        blocks are taken up without a decode, the last pending full block
        (or the padded partial one, or the zero block that pumps the decode
        after the source ends) is decoded. The queue stops before the first
        block that would write past the encoder state (``_fit``)."""
        if sess.target_finished or not sess.tick_due:
            return []
        total = sess.fb_len
        if (self.min_starting_wait is not None and total < self.min_starting_wait
                and not sess.source_finished):
            return []
        if total < self.min_input_length:
            if sess.source_finished:
                # too little audio ever: an empty finish
                self._finish(sess, PooledSegment("", [], True))
            return []

        FB = self.fbank_block
        stride = self.unity_cfg.speech.fbank_stride
        pending = total - sess.fb_consumed
        n_full = pending // FB
        partial = pending - n_full * FB
        if n_full == 0 and partial == 0 and not sess.source_finished:
            return []

        flat = (np.concatenate(sess.fbank, axis=0)[sess.fb_consumed:total]
                if pending else np.zeros((0, 80), np.float32))
        blocks = []
        if partial > 0:
            for b in range(n_full):
                blocks.append((flat[b * FB:(b + 1) * FB], FB // stride, FB, True, False))
            blk = np.zeros((FB, 80), np.float32)
            blk[:partial] = flat[n_full * FB:]
            commit = bool(sess.source_finished)
            blocks.append((blk, partial // stride, partial if commit else 0, commit, True))
        elif n_full > 0:
            for b in range(n_full - 1):
                blocks.append((flat[b * FB:(b + 1) * FB], FB // stride, FB, True, False))
            blocks.append((flat[(n_full - 1) * FB:n_full * FB], FB // stride, FB, True,
                           True))
        else:
            # the drain pump after the source ended: a decode over a zero block
            blocks.append((np.zeros((FB, 80), np.float32), 0, 0, True, True))
        return self._fit(sess, blocks)

    def _fit(self, sess: _Session, blocks: list) -> list:
        """The blocks of ``blocks`` that fit in the encoder state, each
        writing FB / stride rows at the session's count before it. If one
        does not fit, the last that does is decoded and the session ends
        after it (at once, with an empty final segment, when none fits)."""
        rows = self.fbank_block // self.unity_cfg.speech.fbank_stride
        n, fit = sess.n_stacked, []
        for blk in blocks:
            if n + rows > self.max_stream_frames:
                break
            fit.append(blk)
            n += blk[1] if blk[3] else 0
        if len(fit) == len(blocks):
            return blocks
        if not fit:
            self._finish(sess, PooledSegment("", [], True))
            return []
        sess.outgrown = True
        fit[-1] = fit[-1][:4] + (True,)
        return fit

    @torch.inference_mode()
    def step(self) -> None:
        """Process every session's pending audio to its decode point. Each
        inner iteration runs one block a session through one batched chunk
        over all ``n_slots`` (idle slots on zero frames); the sessions'
        queues are aligned at their ends, so that all decodes of the step
        share the last chunk and its write burst. A session's blocks keep
        their order, and a session's outputs do not depend on which others
        share its chunks.

        A session whose source has finished but whose target has not gets a
        drain pump first: an empty segment through its feature extractor, as
        the single-session session loop does after the source ends. The
        extractor extracts its leftover samples and the last chunk again at
        every such cycle (it reads ``source[-1]``, which no longer advances),
        so each drain tick grows the decoder's fbank as the single-session
        agents see it."""
        span = TRACER.begin("pool.step") if TRACER.on else None
        self.last_timings = {}
        for sess in self._sessions.values():
            if (sess.source_finished and not sess.target_finished
                    and not sess.pushed_since_step):
                self._feat_tick(sess, EmptySegment(finished=True, tgt_lang=sess.tgt_lang))
            sess.pushed_since_step = False
        queues = {sid: self._plan(sess) for sid, sess in self._sessions.items()}
        for sess in self._sessions.values():
            sess.tick_due = False
        # the queues end together: every session's decoded block (its last)
        # runs in the last chunk, so the write bursts of a step run as one
        n = max(map(len, queues.values()), default=0)
        for k in range(n):
            self._run_batch({sid: q[k - n + len(q)] for sid, q in queues.items()
                             if k >= n - len(q)})
        if span is not None:
            TRACER.end(span)

    def _run_batch(self, batch: dict) -> None:
        span = None
        if TRACER.on:
            span = TRACER.begin("pool.chunk")
            TRACER.count("pool.chunks")
        N, FB = self.n_slots, self.fbank_block
        fb = np.zeros((N, FB, 80), np.float32)
        nv, srcfin, commit, active = [0] * N, [False] * N, [False] * N, [False] * N
        ctxs: Dict[int, List[int]] = {}
        for sid, (blk, n_valid, _consume, com, accept) in batch.items():
            sess = self._sessions[sid]
            fb[sess.slot] = blk
            nv[sess.slot] = n_valid
            srcfin[sess.slot] = sess.source_finished
            commit[sess.slot] = com
            active[sess.slot] = accept
            ctxs[sess.slot] = sess.prefix + sess.target_indices
        Tb = max(16, int(math.ceil(max(2, *map(len, ctxs.values())) / 16)) * 16)
        toks = np.zeros((N, Tb), np.int64)
        n_tok = [2] * N
        for slot, ctx in ctxs.items():
            toks[slot, :len(ctx)] = ctx
            n_tok[slot] = len(ctx)

        timings: Dict[str, float] = {}
        self.enc_state, bursts = batched_incremental_s2t_chunk(
            self.unity_params, self.mono_params, self.enc_state,
            torch.as_tensor(fb, device=self.device), nv,
            torch.as_tensor(toks, device=self.device), n_tok, self.unity_cfg,
            self.mono_cfg, source_finished=srcfin, commit=commit, active=active,
            max_target_len=self.max_target_len,
            decision_threshold=self.decision_threshold,
            decision_method=self.decision_method,
            p_choose_start_layer=self.p_choose_start_layer, eos_idx=self.eos_idx,
            max_len_a=self.max_len_a, max_len_b=self.max_len_b,
            max_writes=self.max_consecutive_writes, min_gen_len=self.min_gen_len,
            with_gaps=self.record_decisions, timings=timings)
        for k, v in timings.items():
            self.last_timings[k] = self.last_timings.get(k, 0.0) + v

        for sid, (blk, n_valid, consume, com, accept) in batch.items():
            sess = self._sessions[sid]
            # the agent's decode_stacked = n_stacked + decode_nv (the count
            # after the take-up for a committed decode block)
            decode_stacked = sess.n_stacked + n_valid
            if com:
                sess.fb_consumed += consume
                sess.n_stacked += n_valid
            if not accept:
                continue
            sess.last_decode_stacked = decode_stacked
            burst = bursts[sess.slot]
            pred = list(burst.tokens)
            if self.record_decisions:
                sess.decisions += [(s, g, pred[i] if i < len(pred) else None)
                                   for i, (s, g) in enumerate(zip(burst.stats, burst.gaps))]
            finished = burst.finished
            sess.target_indices += pred
            if pred or finished:
                finished = finished or len(sess.target_indices) > self._max_len(sess)
                sess.out.append(PooledSegment(self.text_tokenizer.decode(pred), pred,
                                              finished))
            if finished:
                self._finish(sess, None)
            elif sess.outgrown:
                self._finish(sess, PooledSegment("", [], True))
        if span is not None:
            TRACER.end(span)

    def _max_len(self, sess: _Session) -> int:
        n = sess.last_decode_stacked or sess.n_stacked
        return self.max_len_a * encoder_output_length(
            self.unity_cfg.speech, n * self.unity_cfg.speech.fbank_stride) + self.max_len_b

    # -- output ------------------------------------------------------------

    def pop(self, sid: int) -> List[PooledSegment]:
        """Drain this session's emitted segments."""
        sess = self._sessions[sid]
        out, sess.out = sess.out, []
        return out

    def session_tokens(self, sid: int) -> List[int]:
        return list(self._sessions[sid].target_indices)

    def session_finished(self, sid: int) -> bool:
        return self._sessions[sid].target_finished

    def session_source_finished(self, sid: int) -> bool:
        return self._sessions[sid].source_finished

    def session_decisions(self, sid: int) -> List[tuple]:
        """(statistic, top-2 logit gap, token written or None) at each of the
        session's decisions; empty unless the pool ``record_decisions``."""
        return list(self._sessions[sid].decisions)
