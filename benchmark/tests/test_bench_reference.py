"""The reference against the program at the tiny sizes on the CPU, through
the cells' own drivers and checks (``tiny.py``), and the runs with the timed
path broken underneath, which the cells' limits must refuse: a token
altered where it is produced; half of a batch left out, the rest's mean in
its place; a decode step whose cache comes back unchanged; the serve
cell's beam keeping worse candidates with consistent scores; torch's
float32 switches turned to TF32 while the window runs. (Both cells run on
one chip, so no exchange between chips can be left out.)"""

import contextlib

import pytest
import torch

import faults
import tiny
from harness.common import limits_file, load_module
from harness.context import Ctx
from harness.result import judge

SERVE = "m4t_v2_large.s2tt_serve32"
POOL = "seamless_streaming.s2tt_pool8"


def _run(driver: str, config: dict, traffic: dict, seed: int, seconds: float) -> dict:
    drv = load_module(tiny.BENCH / "drivers" / f"{driver}.py", "drv_" + driver)
    ctx = Ctx(workload={"name": "tiny"}, config=config, traffic=traffic, limits={},
              seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"),
              log=lambda s: None)
    return drv.run(ctx)


def _serve(seed=2 ** 33 + 3):
    return _run("serve", tiny.serve_config(), tiny.serve_traffic(), seed, 2.0)


def _pool(seed=2 ** 33 + 5):
    # a window that holds whole sessions on a loaded host too
    return _run("stream_pool", tiny.stream_config(), tiny.stream_traffic(), seed, 10.0)


def _refused(rec: dict, cell: str) -> None:
    """Not correct by a compared number over its limit (not by an empty
    window)."""
    assert rec["attempted"] > 0
    ok, checks = judge(rec, limits_file(cell))
    assert not ok and any(c["value"] > c["limit"] for c in checks.values()), checks


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def test_serve_agrees_with_the_reference():
    rec = _serve()
    ok, checks = judge(rec, limits_file(SERVE))
    assert ok, checks
    assert rec["checks"]["score_gap"] < 1e-4 and rec["checks"]["rank_gap"] < 1e-4
    assert rec["checks"]["precision_switches"] == 0


def test_pool_agrees_with_the_reference():
    rec = _pool()
    ok, checks = judge(rec, limits_file(POOL))
    assert ok, checks
    assert rec["checks"]["logit_gap"] == 0.0 and rec["checks"]["stat_gap"] < 1e-4


# -- the serve cell broken underneath -----------------------------------------

def _token_altered(orig):
    def beam_search(*a, **k):
        res = orig(*a, **k)
        tokens = res.tokens.clone()
        tokens[:, :, 2] = (tokens[:, :, 2] + 1) % a[5]
        return res._replace(tokens=tokens)
    return beam_search


def _half_batch(orig):
    def encode_speech(*a, **k):
        out = orig(*a, **k)
        seqs = out.seqs.clone()
        h = seqs.shape[0] // 2
        seqs[h:] = seqs[:max(h, 1)].mean(dim=0, keepdim=True)
        return out._replace(seqs=seqs)
    return encode_speech


def _cache_unchanged(orig):
    def step(params, x_t, cache, *a, **k):
        out, _ = orig(params, x_t, cache, *a, **k)
        return out, cache
    return step


@pytest.mark.parametrize("fault", ["token", "half_batch", "state"])
def test_serve_refuses_a_broken_path(fault):
    from seamless_communication_torch.inference import generator
    from seamless_communication_torch.models.nllb import model as nllb
    from seamless_communication_torch.models.unity import model as unity

    where = {"token": (generator, "beam_search", _token_altered),
             "half_batch": (unity, "encode_speech", _half_batch),
             "state": (nllb, "transformer_decoder_step", _cache_unchanged)}[fault]
    with _patched(*where):
        rec = _serve()
    _refused(rec, SERVE)


def test_serve_refuses_a_beam_that_keeps_worse_candidates():
    with faults.beam_keeps_worse():
        rec = _serve()
    # the scores stay consistent with the tokens: the ranks catch it
    assert rec["checks"]["score_gap"] < 1e-4, rec["checks"]
    _refused(rec, SERVE)
    assert rec["checks"]["rank_gap"] > limits_file(SERVE)["limits"]["rank_gap"]


def _tf32_on(orig):
    def call(*a, **k):
        from reference.nn import set_tf32

        set_tf32(True)
        return orig(*a, **k)
    return call


@pytest.mark.parametrize("driver", ["serve", "stream_pool"])
def test_tf32_turned_on_in_the_window_is_refused(driver):
    from seamless_communication_torch.inference import generator
    from seamless_communication_torch.streaming import fused

    where = {"serve": (generator, "beam_search"),
             "stream_pool": (fused, "monotonic_write_burst_rows")}[driver]
    with _patched(*where, _tf32_on):
        rec = _serve() if driver == "serve" else _pool()
    assert rec["checks"]["precision_switches"] > 0
    _refused(rec, SERVE if driver == "serve" else POOL)


# -- the pool cell broken underneath ------------------------------------------

def _burst_token(orig):
    def burst(*a, **k):
        return [b._replace(tokens=[(t + 1) % 256 for t in b.tokens]) for b in orig(*a, **k)]
    return burst


def _half_slots(orig):
    def output(*a, **k):
        x, lens = orig(*a, **k)
        x = x.clone()
        h = x.shape[0] // 2
        x[h:] = x[:h].mean(dim=0, keepdim=True)
        return x, lens
    return output


def _step_unwritten(orig):
    def step(params, tok, cache, *a, **k):
        saved = (cache.self_k.clone(), cache.self_v.clone())
        out = orig(params, tok, cache, *a, **k)
        cache.self_k.copy_(saved[0])
        cache.self_v.copy_(saved[1])
        return out
    return step


@pytest.mark.parametrize("fault", ["token", "half_batch", "state"])
def test_pool_refuses_a_broken_path(fault):
    from seamless_communication_torch.models.monotonic import model as mono
    from seamless_communication_torch.streaming import fused

    where = {"token": (fused, "monotonic_write_burst_rows", _burst_token),
             "half_batch": (fused, "speech_encoder_stream_output", _half_slots),
             "state": (mono, "monotonic_decode_step", _step_unwritten)}[fault]
    with _patched(*where):
        rec = _pool()
    _refused(rec, POOL)
