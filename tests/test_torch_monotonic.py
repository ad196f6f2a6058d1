"""The port's EMMA monotonic decoder (``models/monotonic/model.py``) against
the JAX package's on the same parameters (the JAX ``monotonic_decoder_init``
carried across by ``checkpoint/from_jax.py``), fp32 on the CPU, at the
decoder size of the JAX streaming tests (dim 64, 2 layers, 4 heads, vocab
256, 2 energy layers): pooled keys, p_choose, the decode step, the serial and
parallel prefill and the write burst within 1e-5; tokens, the number written
and ``finished`` exactly; the decision statistic at an even count; and the
monotonic checkpoint converters and loader, leaf for leaf."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.checkpoint import convert_fairseq2 as jconvert
from seamless_communication_tpu.checkpoint import fairseq_export as jexport
from seamless_communication_tpu.models.monotonic import model as jmono

from seamless_communication_torch.checkpoint import convert_fairseq2, fairseq_export
from seamless_communication_torch.checkpoint.from_jax import (
    monotonic_params_from_jax, monotonic_params_to_numpy,
)
from seamless_communication_torch.models.monotonic import model as mono

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(model_dim=64, num_layers=2, num_heads=4, ffn_inner_dim=128, vocab_size=256,
           num_monotonic_energy_layers=2, pre_decision_ratio=2)
S, VALID, MAX_LEN = 11, 9, 32


@pytest.fixture(scope="module")
def setup():
    jcfg = jmono.MonotonicDecoderConfig(**CFG)
    jparams = jmono.monotonic_decoder_init(jax.random.PRNGKey(5), jcfg)
    params = monotonic_params_from_jax(jax.tree.map(np.asarray, jparams))
    enc = np.random.default_rng(0).standard_normal((1, S, 64)).astype(np.float32)
    mask = np.arange(S)[None] < VALID
    return jcfg, jparams, mono.MonotonicDecoderConfig(**CFG), params, enc, mask


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(kw or TOL))


@pytest.mark.parametrize("n", [10, 11])
def test_pool_keys_and_p_choose(setup, n):
    jcfg, jparams, cfg, params, enc, _ = setup
    pooled = mono.pool_keys(torch.from_numpy(enc[:, :n]), 2)
    jpooled = jmono.pool_keys(jnp.asarray(enc[:, :n]), 2)
    assert pooled.shape == (1, -(-n // 2), 64)
    close(pooled, jpooled)
    q = np.random.default_rng(n).standard_normal((1, 3, 64)).astype(np.float32)
    layer = params["layers"][1]["p_choose"]
    jlayer = jax.tree.map(lambda x: x[1], jparams["layers"])["p_choose"]
    got = mono.p_choose(layer, torch.from_numpy(q), pooled, cfg)
    close(got, jmono.p_choose(jlayer, jnp.asarray(q), jpooled, jcfg))
    # the cache's precomputed key energies give the same probabilities
    close(mono.p_choose(layer, torch.from_numpy(q), None, cfg,
                        k_energy=mono.key_energy(layer, pooled, cfg)), got, rtol=0, atol=0)


def test_decode_steps(setup):
    jcfg, jparams, cfg, params, enc, mask = setup
    cache = mono.monotonic_decoder_cache(params, cfg, torch.from_numpy(enc), MAX_LEN)
    jcache = jmono.monotonic_decoder_cache(jparams, jcfg, jnp.asarray(enc), MAX_LEN)
    for a, b in zip(cache[:5], jcache):
        close(a, b)
    tmask, jmask = torch.from_numpy(mask), jnp.asarray(mask)
    for step, tok in enumerate([3, 17, 200, 5]):
        lg, feat, pcs, cache = mono.monotonic_decode_step(
            params, torch.tensor([[tok]]), cache, step, cfg, enc_padding_mask=tmask)
        jlg, jfeat, jpcs, jcache = jmono.monotonic_decode_step(
            jparams, jnp.asarray([[tok]]), jcache, jnp.asarray(step), jcfg,
            enc_padding_mask=jmask)
        assert lg.shape == (1, 256) and pcs.shape == (1, 8, -(-S // 2))
        close(lg, jlg)
        close(feat, jfeat)
        close(pcs, jpcs)
        close(cache.self_k[:, :, :, :step + 1], jcache.self_k[:, :, :, :step + 1])
        close(cache.self_v[:, :, :, :step + 1], jcache.self_v[:, :, :, :step + 1])


def _prefill(setup, parallel: bool, tokens, n):
    jcfg, jparams, cfg, params, enc, mask = setup
    out = mono.monotonic_encode_and_prefill(
        params, torch.tensor(tokens), n, torch.from_numpy(enc), MAX_LEN, cfg,
        enc_padding_mask=torch.from_numpy(mask), parallel=parallel)
    jout = jmono.monotonic_encode_and_prefill(
        jparams, jnp.asarray(tokens), jnp.asarray(n), jnp.asarray(enc), MAX_LEN, jcfg,
        enc_padding_mask=jnp.asarray(mask), parallel=parallel)
    return out, jout


@pytest.mark.parametrize("parallel", [False, True])
def test_prefill(setup, parallel):
    tokens = np.zeros((1, 16), np.int64)
    tokens[0, :5] = [3, 256 - 4, 17, 42, 99]
    (lg, feats, pcs, cache), (jlg, jfeats, jpcs, jcache) = _prefill(setup, parallel,
                                                                   tokens, 5)
    close(lg, jlg)
    close(feats[:, :5], jfeats[:, :5])
    close(pcs, jpcs)
    close(cache.self_k[:, :, :, :5], jcache.self_k[:, :, :, :5])
    close(cache.self_v[:, :, :, :5], jcache.self_v[:, :, :, :5])


# (decision method, threshold, source finished, max_len): write until EOS or
# max_writes; never write; write to the length limit of a finished source
BURSTS = [("min", 0.0, False, 64), ("mean", 1.0, False, 64), ("median", 0.0, False, 64),
          ("median", 0.5, True, 7), ("min", 1.0, True, 64)]


@pytest.mark.parametrize("method,threshold,src_fin,max_len", BURSTS)
def test_write_burst(setup, method, threshold, src_fin, max_len):
    jcfg, jparams, cfg, params, enc, mask = setup
    tokens = np.zeros((1, 16), np.int64)
    tokens[0, :3] = [3, 256 - 4, 17]
    (lg, _, pcs, cache), (jlg, _, jpcs, jcache) = _prefill(setup, True, tokens, 3)
    kw = dict(decision_threshold=threshold, decision_method=method,
              p_choose_start_layer=0, sp_valid=-(-VALID // 2), eos_idx=3, max_len=max_len,
              n_context=3, max_writes=6, source_finished=src_fin)
    burst = mono.monotonic_write_burst(params, cache, 3, lg, pcs, cfg,
                                       enc_padding_mask=torch.from_numpy(mask), **kw)
    jkw = dict(kw, sp_valid=jnp.asarray(kw["sp_valid"]), max_len=jnp.asarray(max_len),
               n_context=jnp.asarray(3))
    jtoks, jfeats, jn, jfin, jcache = jmono.monotonic_write_burst(
        jparams, jcache, jnp.asarray(3), jlg, jpcs, jcfg,
        enc_padding_mask=jnp.asarray(mask), **jkw)
    n = int(jn)
    assert burst.tokens == [int(t) for t in np.asarray(jtoks)[:n]]
    assert burst.finished == bool(jfin)
    close(burst.features, np.asarray(jfeats)[:n])
    close(burst.cache.self_k[:, :, :, :3 + n], jcache.self_k[:, :, :, :3 + n])
    close(burst.cache.self_v[:, :, :, :3 + n], jcache.self_v[:, :, :, :3 + n])
    assert len(burst.stats) == n + (0 if n == kw["max_writes"] else 1)
    if threshold == 0.0 and not src_fin:
        assert n > 0


@pytest.mark.parametrize("method", ["min", "mean", "median"])
def test_decision_stat_even_count(setup, method):
    """L * H = 8 heads (an even count): the median is the mean of the two
    middle values, as jnp.median and np.median take it."""
    _, _, cfg, _, _, _ = setup
    pcs = np.random.default_rng(3).uniform(size=(1, 8, 6)).astype(np.float32)
    got = float(mono.decision_stat(torch.from_numpy(pcs), cfg, start_layer=0,
                                   sp_valid=5, method=method))
    last = pcs[0, :, 4]
    want = {"min": jnp.min, "mean": jnp.mean, "median": jnp.median}[method](
        jnp.asarray(last))
    assert got == float(want)
    if method == "median":
        assert got == float(np.median(last))
        assert got != float(torch.median(torch.from_numpy(last)))   # the lower middle
    # from a start layer on: the heads of layer 1 only
    got1 = float(mono.decision_stat(torch.from_numpy(pcs), cfg, start_layer=1,
                                    sp_valid=5, method=method))
    want1 = {"min": np.min, "mean": np.mean, "median": np.median}[method](last[4:])
    np.testing.assert_allclose(got1, want1, rtol=1e-6)


def _same_tree(got, want):
    """Leaf for leaf, exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_tree(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("route", ["fairseq2", "fairseq1"])
def test_converters_match_jax(setup, route):
    """JAX's exporter -> the port's converter gives from_jax of JAX's tree;
    the port's exporter -> JAX's converter gives JAX's tree."""
    _, jparams, _, params, _, _ = setup
    jtree = jax.tree.map(np.asarray, jparams)
    jexp = {"fairseq2": jexport.export_monotonic,
            "fairseq1": jexport.export_monotonic_fairseq1}[route]
    exp = {"fairseq2": fairseq_export.export_monotonic,
           "fairseq1": fairseq_export.export_monotonic_fairseq1}[route]
    got = convert_fairseq2.monotonic_tree_from_pt(jexp(jtree))
    _same_tree(monotonic_params_to_numpy(got), jtree)
    _same_tree(got, params)
    sd = {k: v.numpy() for k, v in exp(params).items()}
    _same_tree(jax.tree.map(np.asarray, jconvert.monotonic_tree_from_pt(sd)), jtree)


@pytest.mark.parametrize("fmt", ["pt", "npz"])
def test_load_monotonic_decoder(setup, tmp_path, monkeypatch, fmt):
    from seamless_communication_torch.checkpoint.serialize import save_params
    from seamless_communication_torch.cli import loading

    _, _, _, params, _, _ = setup
    path = tmp_path / f"mono.{fmt}"
    if fmt == "pt":
        torch.save({"model": fairseq_export.export_monotonic_fairseq1(params)}, path)
    else:
        save_params(str(path), params)
    (tmp_path / "mono_card.yaml").write_text(
        f"name: mono_card\nbase: seamless_streaming_monotonic_decoder\ncheckpoint: {path}\n")
    monkeypatch.setenv("SEAMLESS_CARDS_DIR", str(tmp_path))
    timings = {}
    got, cfg = loading.load_monotonic_decoder("mono_card", dtype=torch.float32,
                                              device="cpu", timings=timings)
    assert cfg == mono.MonotonicDecoderConfig()
    _same_tree(got, params)
    assert {"convert", "transfer"} <= set(timings)
