"""The window's model FLOPs over the window's time at the card's peak
(%): for each request served, the speech encoder over its valid frames and
the cross-attention keys of its encoder frames once, and every beam row's
decode steps through the decoder and the vocabulary projection
(``counts/model_flops.py``); no padded frame, no recompute. fp32 work
against TF32's 495 TFLOP/s (``counts/peaks.py``)."""

from counts import model_flops as mf
from counts.peaks import PEAK_FLOPS


def read(rec):
    data = rec["data"]
    cfg = data["config"]
    enc, dec, K = cfg["speech_encoder"], cfg["text_decoder"], cfg["beam_size"]
    flops = 0.0
    for c in data["calls"]:
        for secs in c["audio_s"]:
            samples = int(secs * 16000)
            frames = 0 if samples < 400 else 1 + (samples - 400) // 160
            S = mf.adaptor_len(enc, frames // enc["fbank_stride"])
            flops += mf.speech_encoder(enc, frames) + mf.cross_kv(dec, S)
            flops += K * sum(mf.decoder_token(dec, p, S) for p in range(c["steps"]))
    if not data["window_s"]:
        return None
    return 100.0 * flops / (data["window_s"] * PEAK_FLOPS[cfg["compute_dtype"]])
