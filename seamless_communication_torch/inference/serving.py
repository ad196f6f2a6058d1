"""Serving: dynamic request batching over a Translator, and live streaming
sessions over one batched pool (counterpart of
``seamless_communication_tpu/inference/serving.py``).

- ``DynamicBatcher``: collects requests for up to ``max_wait_ms`` or
  ``max_batch``, groups them by (task, tgt_lang, src_lang), and runs one
  batched ``Translator.predict`` a group on one worker thread, which owns the
  card. A decode step is bound by the host's launches, so a group of 8
  costs the card little more than one request.
- ``StreamingPoolService``: N concurrent live streaming sessions multiplexed
  over one card through ``streaming.multi.BatchedStreamingPool``: every
  arrival interval runs one batched chunk for all sessions.
- ``serve``: a stdlib ThreadingHTTPServer exposing
    POST /v1/translate      {"task","tgt_lang","src_lang"?,"text"?,"audio_b64"?}
                            -> {"text", "audio_b64"?, "sample_rate"?}
    POST /v1/stream/open    {"tgt_lang"} -> {"session_id"}
    POST /v1/stream/push    {"session_id","audio_b64"?|"samples"?,"finished"?}
                            -> {"segments":[{"text","tokens","finished"}],
                                "finished"}
    POST /v1/stream/poll    {"session_id"} -> same as push (drain phase)
    POST /v1/stream/close   {"session_id"} -> {"status":"closed"}
    GET  /healthz           -> {"status":"ok"}
  Audio is 16-bit WAV, base64 in both directions.

HTTP threads only enqueue and wait on their request's event or the pool step
that covers them. ``Translator.predict`` and the pool's ``step`` enter
``torch.inference_mode`` themselves, on the worker thread that calls them
(the mode is thread-local). An uploaded WAV is decoded by the native
runtime's decoder (``native.wav_decode_native``), as in the JAX package;
a file it does not take is read with the standard library's ``wave``.
``serve`` builds the native library before it listens, so that no request
waits on the compiler, and raises if it cannot (the JAX package serves on
with ``wave`` when its library is missing).
"""

from __future__ import annotations

import base64
import io
import itertools
import json
import logging
import queue
import threading
import time
import wave
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from seamless_communication_torch import native
from seamless_communication_torch.audio.wav import resample
from seamless_communication_torch.native import wav_decode_native
from seamless_communication_torch.utils.profiling import TRACER

logger = logging.getLogger("seamless_serve")
_request_ids = itertools.count(1)


@dataclass
class _Request:
    task: str
    tgt_lang: str
    src_lang: Optional[str]
    payload: Any                      # waveform np.ndarray or text str
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[str] = None
    request_id: int = field(default_factory=_request_ids.__next__)
    # time.perf_counter at submit and at the start of its group's predict
    t_enqueued: float = 0.0
    t_started: float = 0.0

    @property
    def group_key(self):
        return (self.task, self.tgt_lang, self.src_lang)


class DynamicBatcher:
    """Collect requests into per-(task, tgt_lang, src_lang) batches and run
    them through the Translator on a single worker thread."""

    def __init__(self, translator, *, max_batch: int = 8, max_wait_ms: int = 30):
        self.translator = translator
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, req: _Request, timeout: float = 300.0) -> _Request:
        req.t_enqueued = time.perf_counter()
        self._q.put(req)
        if not req.done.wait(timeout):
            req.error = "timeout"
        return req

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=5)

    # ------------------------------------------------------------------

    def _collect(self) -> List[_Request]:
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1000.0
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            groups: Dict[tuple, List[_Request]] = {}
            for r in batch:
                groups.setdefault(r.group_key, []).append(r)
            for (task, tgt_lang, src_lang), reqs in groups.items():
                t = time.perf_counter()
                for r in reqs:
                    r.t_started = t
                span = None
                if TRACER.on:
                    # the group's predict, and each request's wait for it
                    span = TRACER.begin("predict")
                    for r in reqs:
                        TRACER.record("batcher.queue", r.t_enqueued, t, parent=span.id,
                                      request=r.request_id)
                    TRACER.count("batcher.groups")
                    TRACER.count("batcher.requests", len(reqs))
                try:
                    texts, speech = self.translator.predict(
                        [r.payload for r in reqs], task, tgt_lang,
                        src_lang=src_lang)
                    for i, r in enumerate(reqs):
                        out = {"text": str(texts[i])}
                        if speech is not None:
                            out["waveform"] = np.asarray(speech.audio_wavs[i])
                            out["sample_rate"] = speech.sample_rate
                        r.result = out
                except Exception as e:  # report, don't kill the worker
                    logger.exception("batch failed")
                    for r in reqs:
                        r.error = f"{type(e).__name__}: {e}"
                finally:
                    if span is not None:
                        TRACER.end(span)
                    for r in reqs:
                        r.done.set()


class StreamingPoolService:
    """Thread-safe front end over a ``BatchedStreamingPool``.

    One worker thread owns the device. HTTP threads call :meth:`push` /
    :meth:`poll`, which enqueue and then wait for the next pool step that
    covers them — concurrent pushes from different sessions land in the SAME
    batched device chunk (the whole point of the pool). After a session's
    source finishes the worker keeps draining it on a ``tick_ms`` cadence
    until the target finishes, exactly like the single-session evaluator's
    drain loop."""

    def __init__(self, pool, *, tick_ms: int = 40, wait_timeout_s: float = 60.0):
        self.pool = pool
        self.tick_s = tick_ms / 1000.0
        self.wait_timeout_s = wait_timeout_s
        self._cond = threading.Condition()
        self._buffers: Dict[int, list] = {}
        self._step_count = 0
        self._work = False
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- session lifecycle (HTTP-thread side) ------------------------------

    def open(self, tgt_lang: str) -> int:
        with self._cond:
            sid = self.pool.open_session(tgt_lang=tgt_lang)
            self._buffers[sid] = []
            return sid

    def close(self, sid: int) -> None:
        with self._cond:
            self.pool.close_session(sid)
            self._buffers.pop(sid, None)

    def push(self, sid: int, samples, *, finished: bool = False):
        """Feed one audio chunk; returns (segments, session_finished) after
        the next batched step has processed it."""
        with self._cond:
            if sid not in self._buffers:
                raise KeyError(f"unknown session {sid}")
            self.pool.push(sid, samples, finished=finished)
            self._work = True
            target = self._step_count + 1
            self._cond.notify_all()
            self._cond.wait_for(lambda: self._step_count >= target,
                                timeout=self.wait_timeout_s)
            return self._drain(sid)

    def poll(self, sid: int):
        """Collect buffered output; during the post-EOS drain phase waits for
        one more step so the drain visibly advances between polls."""
        with self._cond:
            if sid not in self._buffers:
                raise KeyError(f"unknown session {sid}")
            if (self._buffers[sid] or self.pool.session_finished(sid)
                    or not (self._work or self._draining())):
                return self._drain(sid)
            target = self._step_count + 1
            self._cond.wait_for(lambda: self._step_count >= target,
                                timeout=self.wait_timeout_s)
            return self._drain(sid)

    def _drain(self, sid: int):
        segs, self._buffers[sid] = self._buffers[sid], []
        return segs, self.pool.session_finished(sid)

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker.join(timeout=5)

    # -- the device-owning worker ------------------------------------------

    def _draining(self) -> bool:
        return any(not self.pool.session_finished(sid)
                   and self.pool.session_source_finished(sid)
                   for sid in self._buffers)

    def _run(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(lambda: self._stop or self._work,
                                    timeout=self.tick_s)
                if self._stop:
                    return
                if not (self._work or self._draining()):
                    continue
                self._work = False
                try:
                    self.pool.step()
                    for sid in self._buffers:
                        self._buffers[sid].extend(self.pool.pop(sid))
                except Exception:  # report, don't kill the worker
                    logger.exception("pool step failed")
                self._step_count += 1
                self._cond.notify_all()


def _wav_bytes(waveform: np.ndarray, sample_rate: int) -> bytes:
    """A mono waveform in [-1, 1] as the bytes of a 16-bit PCM WAV."""
    buf = io.BytesIO()
    pcm = (np.clip(np.asarray(waveform, np.float32), -1.0, 1.0)
           * 32767.0).astype("<i2")
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _decode_wav_b64(b64: str) -> np.ndarray:
    """A base64 16-bit PCM WAV -> a mono float32 waveform at 16 kHz."""
    data = base64.b64decode(b64)
    decoded = wav_decode_native(data)
    if decoded is None:
        with wave.open(io.BytesIO(data), "rb") as w:
            rate = w.getframerate()
            n = w.getnframes()
            raw = np.frombuffer(w.readframes(n), "<i2").astype(np.float32)
            wav = (raw / 32768.0).reshape(n, -1).mean(axis=1)
    else:
        wav, rate = decoded
    return resample(wav, rate, 16000)


def make_handler(batcher: Optional[DynamicBatcher],
                 stream_service: Optional[StreamingPoolService] = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(200, {"status": "ok"})
            return self._json(404, {"error": "not found"})

        def _read_json(self) -> dict:
            length = int(self.headers.get("Content-Length", "0"))
            return json.loads(self.rfile.read(length) or b"{}")

        def _stream_route(self, req_json: dict):
            if stream_service is None:
                return self._json(503, {"error": "streaming not enabled "
                                                 "(start with --streaming N)"})
            op = self.path.rsplit("/", 1)[-1]
            try:
                if op == "open":
                    sid = stream_service.open(req_json.get("tgt_lang", "eng"))
                    return self._json(200, {"session_id": sid})
                sid = int(req_json["session_id"])
                if op == "close":
                    stream_service.close(sid)
                    return self._json(200, {"status": "closed"})
                if op == "push":
                    if "audio_b64" in req_json:
                        samples = _decode_wav_b64(req_json["audio_b64"])
                    else:
                        samples = np.asarray(req_json.get("samples", []),
                                             np.float32)
                    segs, fin = stream_service.push(
                        sid, samples, finished=bool(req_json.get("finished")))
                elif op == "poll":
                    segs, fin = stream_service.poll(sid)
                else:
                    return self._json(404, {"error": "not found"})
                return self._json(200, {
                    "segments": [{"text": g.text, "tokens": g.token_indices,
                                  "finished": g.finished} for g in segs],
                    "finished": fin})
            except KeyError as e:
                return self._json(400, {"error": f"bad request: {e}"})
            except RuntimeError as e:       # all slots busy
                return self._json(503, {"error": str(e)})
            except ValueError as e:         # push after finish, bad audio
                return self._json(400, {"error": str(e)})

        def do_POST(self):
            if self.path.startswith("/v1/stream/"):
                try:
                    req_json = self._read_json()
                except (ValueError, json.JSONDecodeError) as e:
                    return self._json(400, {"error": f"bad request: {e}"})
                return self._stream_route(req_json)
            if self.path != "/v1/translate":
                return self._json(404, {"error": "not found"})
            if batcher is None:
                return self._json(503, {"error": "offline translation not "
                                                 "enabled on this server"})
            try:
                req_json = self._read_json()
                task = req_json["task"]
                tgt_lang = req_json["tgt_lang"]
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                return self._json(400, {"error": f"bad request: {e}"})
            src_lang = req_json.get("src_lang")
            if "audio_b64" in req_json:
                try:
                    payload = _decode_wav_b64(req_json["audio_b64"])
                except Exception as e:
                    return self._json(400, {"error": f"bad audio: {e}"})
            elif "text" in req_json:
                payload = req_json["text"]
                if src_lang is None:
                    return self._json(400,
                                      {"error": "src_lang required for text"})
            else:
                return self._json(400, {"error": "need text or audio_b64"})
            r = batcher.submit(_Request(task, tgt_lang, src_lang, payload))
            if r.error:
                return self._json(500, {"error": r.error})
            out = {"text": r.result["text"]}
            if "waveform" in r.result:
                out["audio_b64"] = base64.b64encode(
                    _wav_bytes(r.result["waveform"],
                               r.result["sample_rate"])).decode()
                out["sample_rate"] = r.result["sample_rate"]
            return self._json(200, out)

    return Handler


def serve(translator=None, *, host: str = "127.0.0.1", port: int = 8008,
          max_batch: int = 8, max_wait_ms: int = 30,
          stream_pool=None, stream_tick_ms: int = 40) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; call .shutdown() to stop).

    ``translator`` enables the offline /v1/translate route; ``stream_pool``
    (a ``BatchedStreamingPool``) enables the live /v1/stream/* routes —
    either or both."""
    if translator is None and stream_pool is None:
        raise ValueError("need a translator, a stream_pool, or both")
    native.get_lib()        # the WAV decoder: built now, not in the first request
    batcher = (DynamicBatcher(translator, max_batch=max_batch,
                              max_wait_ms=max_wait_ms)
               if translator is not None else None)
    stream_service = (StreamingPoolService(stream_pool, tick_ms=stream_tick_ms)
                      if stream_pool is not None else None)
    server = ThreadingHTTPServer((host, port),
                                 make_handler(batcher, stream_service))
    server.batcher = batcher
    server.stream_service = stream_service
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    logger.info("serving on %s:%d (max_batch=%d, max_wait=%dms, streaming=%s)",
                host, port, max_batch, max_wait_ms,
                "on" if stream_service else "off")
    return server
