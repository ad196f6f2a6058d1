"""The port's lazy beam reorder (``SEAMLESS_LAZY_REORDER=1``: a (B, T)
row-origin table instead of permuting the int8 KV cache, attention through
``indexed_decode_self_attention_int8``) against the JAX package, on the
setting of tests/unit/test_beam_search.py
``test_lazy_indexed_cache_matches_classic_reorder``: ``tiny_v2`` decoder
steps over a seeded encoder output, beam 3, max_len 14, min_len 3, prefixes
[2, 5] and [2, 6], the same parameters carried across by
``checkpoint/from_jax.py``. Tokens and lengths exactly equal and scores
within rtol 1e-5, atol 1e-6 against the port's classic reorder, the port's
``cache_reorder=decoder_cache_beam_reorder`` mode and JAX's lazy beam. The
variable is set with ``monkeypatch``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.ops import transformer as jtr
from seamless_communication_tpu.ops.beam_search import (
    BeamSearchOptions as JOptions, beam_search as j_beam_search,
)

from seamless_communication_torch.checkpoint.from_jax import unity_params_from_jax
from seamless_communication_torch.models.unity import model as tunity
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.ops import transformer as ttr
from seamless_communication_torch.ops.beam_search import BeamSearchOptions, beam_search
from seamless_communication_torch.ops.kernels import launch_counts

K, MAX_LEN = 3, 14
OPTS = dict(beam_size=K, max_len=MAX_LEN, min_len=3, pad_idx=0, unk_idx=1, eos_idx=3)
PREFIX = np.array([[2, 5], [2, 6]], np.int32)


@pytest.fixture(scope="module")
def setup():
    cfg = jget_arch("tiny_v2")
    jparams = junity.unity_init(jax.random.PRNGKey(0), cfg)
    enc = np.random.default_rng(0).standard_normal((2 * K, 9, cfg.nllb.dim)
                                                   ).astype(np.float32)
    tparams = unity_params_from_jax(jax.tree.map(np.asarray, jparams))
    return jparams, tparams, enc


def _port(tparams, enc, *, kv_int8=True, kv_bits=8, **mode):
    cfg = get_arch("tiny_v2")
    tenc = tunity.EncoderOutput(torch.from_numpy(enc),
                                torch.full((2 * K,), 9, dtype=torch.int32))
    step_fn, cache_fn = tunity.make_text_decode_step(tparams, cfg, tenc)
    cache = cache_fn(MAX_LEN, kv_int8, kv_bits)
    res = beam_search(step_fn, cache, torch.from_numpy(PREFIX),
                      torch.tensor([2, 2], dtype=torch.int32), BeamSearchOptions(**OPTS),
                      cfg.nllb.vocab_size, **mode)
    return res, cache


def _assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got.tokens), np.asarray(want.tokens))
    np.testing.assert_array_equal(np.asarray(got.lengths), np.asarray(want.lengths))
    np.testing.assert_allclose(np.asarray(got.scores), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-6)
    assert int(got.steps) == int(want.steps)


@pytest.fixture(scope="module")
def lazy(setup):
    _, tparams, enc = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAMLESS_LAZY_REORDER", "1")
        res, cache = _port(tparams, enc)
    assert cache.row_src is not None
    return res


def _jax_lazy(jparams, enc, monkeypatch):
    monkeypatch.setenv("SEAMLESS_LAZY_REORDER", "1")
    cfg = jget_arch("tiny_v2")
    jenc = junity.EncoderOutput(jnp.asarray(enc), jnp.full((2 * K,), 9, jnp.int32))
    step_fn, cache_fn = junity.make_text_decode_step(jparams, cfg, jenc)
    cache = cache_fn(MAX_LEN, True)
    assert cache.row_src is not None
    return j_beam_search(step_fn, cache, jnp.asarray(PREFIX), jnp.array([2, 2], jnp.int32),
                         JOptions(**OPTS), cfg.nllb.vocab_size, src_to_step=True)


@pytest.mark.parametrize("against", ["classic", "cache_reorder", "jax_lazy"])
def test_lazy_reorder_matches(setup, lazy, monkeypatch, against):
    jparams, tparams, enc = setup
    if against == "jax_lazy":
        want = _jax_lazy(jparams, enc, monkeypatch)
    else:
        monkeypatch.delenv("SEAMLESS_LAZY_REORDER", raising=False)
        mode = ({} if against == "classic"
                else dict(cache_reorder=ttr.decoder_cache_beam_reorder))
        want, cache = _port(tparams, enc, **mode)
        assert cache.row_src is None
    _assert_same(lazy, want)


def test_lazy_step_keeps_the_buffers_in_place(setup, monkeypatch):
    """One lazy step: the table inherits the source beams' rows and marks
    row ``step`` as each beam's own; the buffers are the same tensors, with
    row ``step`` written; no kernel launches on the CPU."""
    _, tparams, enc = setup
    monkeypatch.setenv("SEAMLESS_LAZY_REORDER", "1")
    cfg = get_arch("tiny_v2")
    tenc = tunity.EncoderOutput(torch.from_numpy(enc),
                                torch.full((2 * K,), 9, dtype=torch.int32))
    step_fn, cache_fn = tunity.make_text_decode_step(tparams, cfg, tenc)
    cache = cache_fn(MAX_LEN, True)
    before = dict(launch_counts)
    tok = torch.full((2 * K, 1), 2, dtype=torch.long)
    _, c1 = step_fn(tok, cache, 0, torch.arange(2 * K, dtype=torch.int32))
    src = torch.tensor([1, 1, 0, 5, 3, 3], dtype=torch.int32)
    _, c2 = step_fn(tok, c1, 1, src)
    assert launch_counts == before
    assert all(a is b for a, b in zip(c2.self_k, cache.self_k))
    want = torch.stack([src, torch.arange(2 * K, dtype=torch.int32)], 1)
    assert torch.equal(c2.row_src[:, :2], want)
    assert bool((cache.self_k[0][:, :, 1] != 0).any())


def test_beam_reorder_composes_through_row_src():
    """``decoder_cache_beam_reorder`` on a cache with a non-identity table:
    row t of beam b comes from slot row_src[flat_src[b], t], as in the JAX
    package, and the table is reset to the identity."""
    rng = np.random.default_rng(3)
    Bk, H, T, Dh, L = 4, 2, 6, 8, 2
    k8 = [rng.integers(-127, 128, (Bk, H, T, Dh)).astype(np.int8) for _ in range(L)]
    v8 = [rng.integers(-127, 128, (Bk, H, T, Dh)).astype(np.int8) for _ in range(L)]
    ks = [rng.random((Bk, H, T)).astype(np.float32) for _ in range(L)]
    vs = [rng.random((Bk, H, T)).astype(np.float32) for _ in range(L)]
    cross = [rng.random((Bk, H, 3, Dh)).astype(np.float32) for _ in range(L)]
    rs = rng.integers(0, Bk, (Bk, T)).astype(np.int32)
    src = np.array([2, 2, 0, 3], np.int32)
    tc = ttr.DecoderCacheQ8(*([torch.from_numpy(a) for a in f]
                              for f in (k8, v8, ks, vs, cross, cross, cross, cross)),
                            torch.from_numpy(rs))
    jc = jtr.DecoderCacheQ8(*(tuple(jnp.asarray(a) for a in f)
                              for f in (k8, v8, ks, vs, cross, cross, cross, cross)),
                            jnp.asarray(rs))
    got = ttr.decoder_cache_beam_reorder(tc, torch.from_numpy(src))
    want = jtr.decoder_cache_beam_reorder(jc, jnp.asarray(src))
    for name in ("self_k", "self_v", "self_k_scale", "self_v_scale"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    comp = rs[src]
    np.testing.assert_array_equal(got.self_k[1].numpy()[1, 0, 4], k8[1][comp[1, 4], 0, 4])
    np.testing.assert_array_equal(got.row_src.numpy(), np.asarray(want.row_src))
    assert (got.row_src.numpy() == np.arange(Bk)[:, None]).all()
    assert got.cross_k[0] is tc.cross_k[0]


@pytest.mark.parametrize("kv", ["fp", "int4"])
def test_fp_and_int4_caches_stay_classic(setup, monkeypatch, kv):
    """With the variable set, the fp and the packed-int4 caches carry no
    table and give what they give without it."""
    _, tparams, enc = setup
    kw = dict(kv_int8=False) if kv == "fp" else dict(kv_int8=True, kv_bits=4)
    monkeypatch.setenv("SEAMLESS_LAZY_REORDER", "1")
    got, cache = _port(tparams, enc, **kw)
    assert getattr(cache, "row_src", None) is None
    monkeypatch.delenv("SEAMLESS_LAZY_REORDER")
    want, _ = _port(tparams, enc, **kw)
    _assert_same(got, want)
