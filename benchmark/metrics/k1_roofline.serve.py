"""K1's share (%) of its roofline in the traced window: the sum of K1's
least times (``counts/kernels.py k1_bound_s``) at each launch's shape, over
the sum of K1's device times in the trace. A launch's shape is its
``predict`` call's: B = requests x beam rows, H and Dh the decoder's, T the
cache length (``last_result``'s token columns), fp32 queries; the source
beams it reads are counted at their least, one a request."""

from counts.kernels import k1_bound_s
from harness.readers import events_in

K1 = "decode_step_kernel"


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    cfg = rec["data"]["config"]
    dec, K = cfg["text_decoder"], cfg["beam_size"]
    H, Dh = dec["num_heads"], dec["dim"] // dec["num_heads"]
    bound = spent = 0.0
    for c in rec["data"].get("traced_calls", []):
        n = len(c["ids"])
        ev = events_in(tr, K1, c["t0"], c["t1"])
        bound += len(ev) * k1_bound_s(n * K, H, c["T"], Dh, n_src=n, elem=4)
        spent += sum(e[2] for e in ev)
    if spent <= 0:
        return None
    return 100.0 * bound / spent
