"""The window's model FLOPs over the window's time at the card's peak
(%): each 320 ms chunk pushed in the window through the conformer once
(its 16 stacked frames, chunk-causal attention) and the adaptor, the EMMA
decoder's cross-attention keys and key energies once an encoder frame, and
each token written through the EMMA decoder at its position
(``counts/model_flops.py``); the prefill of every round, done again each
chunk, is not counted. fp32 work against TF32's 495 TFLOP/s."""

from counts import model_flops as mf
from counts.peaks import PEAK_FLOPS


def read(rec):
    data = rec["data"]
    cfg = data["config"]
    enc, mono = cfg["speech_encoder"], cfg["monotonic_decoder"]
    chunk = enc["chunk_size"]
    first, last = data["first_step"], data["last_step"]
    flops = 0.0
    for s in data["sessions"]:
        rows = pos = 0
        for k, tick in enumerate(s["ticks"]):
            step = s["opened"] + k
            new = 16 if tick["pushed"] else 0
            ctx = 2 + pos
            if first <= step <= last:
                pairs = sum(min((r // chunk + 1) * chunk, rows + new)
                            for r in range(rows, rows + new))
                a0, a1 = mf.adaptor_len(enc, rows), mf.adaptor_len(enc, rows + new)
                flops += (mf.conformer_rows(enc, new, pairs)
                          + mf.adaptor_frames(enc, a1 - a0, (a1 - a0) * a1)
                          + mf.monotonic_frames(mono, a1 - a0))
                for toks, _ in tick["segments"]:
                    flops += sum(mf.monotonic_token(mono, ctx + j, a1) for j in range(len(toks)))
            rows += new
            pos += sum(len(t) for t, _ in tick["segments"])
    if not data["window_s"]:
        return None
    return 100.0 * flops / (data["window_s"] * PEAK_FLOPS[cfg["compute_dtype"]])
