"""m4t_serve: an HTTP endpoint with dynamic batching over one card
(counterpart of ``seamless_communication_tpu/cli/serve.py``).

    python3 -m seamless_communication_torch.cli.serve --model_name CARD \\
        [--local_pt_path FILE.pt] [--port 8008] [--quantize] [--device cuda|cpu]

POST /v1/translate {"task": "s2tt"|"t2tt"|"asr"|"s2st"|"t2st",
                    "tgt_lang": ..., "src_lang"?: ...,
                    "text"? | "audio_b64"? (16 kHz WAV, base64)}
GET  /healthz

With ``--streaming N`` the server also multiplexes up to N live streaming S2T
sessions over the same card through ``BatchedStreamingPool``
(``streaming/multi.py``):

POST /v1/stream/open  {"tgt_lang"}                       -> {"session_id"}
POST /v1/stream/push  {"session_id","audio_b64"|"samples","finished"?}
POST /v1/stream/poll  {"session_id"}
POST /v1/stream/close {"session_id"}

The flags are the JAX package's, without its ``--platform``, plus
``--device`` (the CUDA card unless it says ``cpu``), ``--local_pt_path`` and
``--stream_local_pt_path`` (the models' original ``.pt`` checkpoints on disk).
``make_server(argv)`` loads the models and starts the server; ``main`` blocks
on it.
"""

from __future__ import annotations

import argparse
import logging
import threading
from typing import Optional, Sequence

logger = logging.getLogger("seamless_serve")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Seamless serving on one card")
    parser.add_argument("--model_name", type=str, default="seamlessM4T_v2_large")
    parser.add_argument("--vocoder_name", type=str, default="vocoder_v2")
    parser.add_argument("--local_hf_path", type=str, default=None,
                        help="local HF checkpoint directory (needs transformers)")
    parser.add_argument("--local_pt_path", type=str, default=None,
                        help="the model's original .pt checkpoint on disk")
    parser.add_argument("--device", type=str, default=None,
                        help="where to run: the CUDA card by default, or cpu")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--max_wait_ms", type=int, default=30)
    parser.add_argument("--quantize", action="store_true",
                        help="int8 weight-only quantization (halves the weight "
                             "reads of a decode step against bf16)")
    parser.add_argument("--no_speech_out", action="store_true",
                        help="skip loading the vocoder (text-output tasks only)")
    parser.add_argument("--kv_bits", type=int, default=8, choices=[8, 4],
                        help="self-attention KV cache precision of the offline "
                             "decode (4 = packed int4: half the KV reads of int8; "
                             "lossier)")
    parser.add_argument("--warmup", type=str, default=None,
                        help="comma-separated task:tgt_lang[:src_lang] specs served "
                             "once each before accepting traffic, e.g. "
                             "'s2tt:spa,t2tt:fra:eng' (the kernel builds and the "
                             "cuBLAS handles otherwise fall on the first request)")
    parser.add_argument("--streaming", type=int, default=0, metavar="N",
                        help="enable N concurrent live streaming S2T sessions "
                             "(BatchedStreamingPool slots); requires a chunk-causal "
                             "streaming unity card (--stream_unity_name)")
    parser.add_argument("--stream_unity_name", type=str,
                        default="seamless_streaming_unity")
    parser.add_argument("--stream_monotonic_name", type=str,
                        default="seamless_streaming_monotonic_decoder")
    parser.add_argument("--stream_tick_ms", type=int, default=40,
                        help="pool drain cadence after a session's source ends")
    parser.add_argument("--stream_local_hf_path", type=str, default=None)
    parser.add_argument("--stream_local_pt_path", type=str, default=None,
                        help="the streaming UnitY's original .pt checkpoint on disk")
    return parser


def _warm(translator, specs: str) -> None:
    """Serve each task:tgt_lang[:src_lang] spec once, in turn."""
    import numpy as np

    for spec in specs.split(","):
        parts = spec.strip().split(":")
        task, tgt = parts[0], parts[1]
        src = parts[2] if len(parts) > 2 else None
        payload = "warm up" if task.startswith("t") else np.zeros(16000, np.float32)
        logger.info("warmup %s", spec)
        translator.predict([payload], task, tgt, src_lang=src)


def make_server(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` (``sys.argv[1:]`` when None), load the models, warm
    them up where asked, and start the server; returns the running
    ``ThreadingHTTPServer`` (``.shutdown()`` stops it; its ``batcher`` and
    ``stream_service`` have ``close()`` and ``stop()``)."""
    args = _parser().parse_args(argv)

    from seamless_communication_torch.cli.loading import (
        load_monotonic_decoder, load_unity_model_and_tokenizers, load_vocoder,
    )
    from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
    from seamless_communication_torch.inference.serving import serve
    from seamless_communication_torch.inference.translator import Translator

    params, cfg, text_tok, unit_tok, char_tok = load_unity_model_and_tokenizers(
        args.model_name, local_hf_path=args.local_hf_path,
        local_pt_path=args.local_pt_path, quantize=args.quantize, device=args.device)
    voc_params = voc_cfg = None
    idx_map = {}
    if not args.no_speech_out:
        voc_params, voc_cfg, idx_map = load_vocoder(
            args.vocoder_name, local_hf_path=args.local_hf_path, device=args.device)
    text_opts = (SequenceGeneratorOptions(kv_cache_bits=args.kv_bits)
                 if args.kv_bits != 8 else None)
    translator = Translator(params, cfg, text_tok, unit_tok, char_tok,
                            vocoder_params=voc_params, vocoder_cfg=voc_cfg,
                            lang_spkr_idx_map=idx_map, text_opts=text_opts,
                            device=args.device)
    if args.warmup:
        _warm(translator, args.warmup)

    stream_pool = None
    if args.streaming > 0:
        from seamless_communication_torch.streaming.multi import BatchedStreamingPool

        s_params, s_cfg, s_text_tok, _, _ = load_unity_model_and_tokenizers(
            args.stream_unity_name,
            local_hf_path=args.stream_local_hf_path or args.local_hf_path,
            local_pt_path=args.stream_local_pt_path, quantize=args.quantize,
            device=args.device)
        mono_params, mono_cfg = load_monotonic_decoder(args.stream_monotonic_name,
                                                       device=args.device)
        # server audio arrives as [-1, 1] floats (decoded WAV), so the fbank
        # front end scales it to 16-bit (the streaming inputs' scale)
        stream_pool = BatchedStreamingPool(
            s_params, s_cfg, mono_params, mono_cfg, s_text_tok, n_slots=args.streaming,
            denormalize=True, mono_quantize_int8=args.quantize or None,
            device=args.device)

    return serve(translator, host=args.host, port=args.port, max_batch=args.max_batch,
                 max_wait_ms=args.max_wait_ms, stream_pool=stream_pool,
                 stream_tick_ms=args.stream_tick_ms)


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s -- %(name)s: %(message)s")
    server = make_server(argv)
    try:
        threading.Event().wait()  # the server runs in a background thread
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
