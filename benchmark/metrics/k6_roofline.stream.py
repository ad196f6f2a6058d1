"""K6's share (%) of its roofline in the traced window: the sum of K6's
least times (``counts/kernels.py k6_bound_s``) over the sum of K6's device
times in the trace. In this mix K6 runs once a decoding pool step, in the
adaptor's attention over the encoder state's buffer: B = slots, H the
adaptor's heads, Tq = Tk = the adaptor's length of the buffer (the mix's
``pool.max_stream_frames``, which the pool is built with), bf16, key
segment ids; the unmasked pairs are every query against each slot's valid
keys, a slot's count read after its step (``enc_state.n``, taken up rows
only: the least)."""

from counts.kernels import k6_bound_s
from counts.model_flops import adaptor_len
from harness.readers import events_in

K6 = "flash_attention_"


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    data = rec["data"]
    enc = data["config"]["speech_encoder"]
    H, Dh = enc["num_adaptor_heads"], enc["model_dim"] // enc["num_adaptor_heads"]
    T = adaptor_len(enc, data["traffic"]["pool"]["max_stream_frames"])
    bound = spent = 0.0
    for s in data["traced_steps"]:
        ev = [e for e in events_in(tr, K6, s["t0"], s["t1"]) if "bwd" not in e[0]]
        if not ev:
            continue
        keys = sum(adaptor_len(enc, n) for n in s["counts"])
        b = k6_bound_s(len(s["counts"]), H, T, T, Dh, "bfloat16", has_ab=False, has_seg=True,
                       pairs=H * T * keys)
        bound += b * len(ev)
        spent += sum(e[2] for e in ev)
    if spent <= 0:
        return None
    return 100.0 * bound / spent
