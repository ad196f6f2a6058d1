"""Kernels launched a beam-search step in the traced window: the trace's
kernels (every launch, those of the ctypes-loaded kernels included, runs
one) over the decode steps the window holds, K1's launches over the
decoder's layers (K1 runs once a layer a step)."""

K1 = "decode_step_kernel"


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    layers = rec["data"]["config"]["text_decoder"]["num_layers"]
    steps = len(tr.kernels(K1)) / layers
    if steps < 1:
        return None
    return tr.n_kernels() / steps
