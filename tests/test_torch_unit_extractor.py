"""Unit extraction in the port against the JAX package in fp32 on the CPU:
the raw-waveform XLSR wav2vec2 (``models/unit_extractor/wav2vec2_raw.py``)
at a tiny width (3 layers, width 32, 2 heads, a 3-conv feature extractor, a
positional conv of kernel 16 in 4 groups) on a batch of two waveforms of
different valid lengths, with the output layer in the middle and at the
last layer; ``KmeansModel``; ``UnitExtractor``; the ``.pt`` exporter and
converter of either package read by the other's; ``cli/audio_to_units.py``;
and the plain version of K6 at the XLSR's head dim of 80.

Features within 1e-5 (absolute; the same fp32 arithmetic in two libraries),
units, lengths and converted leaves identical. The weights come from the port's
init on a seeded generator; every other random input from numpy's seeded
generators."""

import functools
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.checkpoint import convert_fairseq2 as jf2
from seamless_communication_tpu.checkpoint import fairseq_export as jexport
from seamless_communication_tpu.cli import audio_to_units as jcli
from seamless_communication_tpu.models import unit_extractor as junit_pkg
from seamless_communication_tpu.models.unit_extractor import unit_extractor as ju
from seamless_communication_tpu.models.unit_extractor import wav2vec2_raw as jw
from seamless_communication_tpu.ops import attention as jattn

from seamless_communication_torch.audio.wav import write_wav
from seamless_communication_torch.checkpoint import convert_fairseq2 as tf2
from seamless_communication_torch.checkpoint import fairseq_export as texport
from seamless_communication_torch.checkpoint.from_jax import (
    wav2vec2_raw_params_from_jax, wav2vec2_raw_params_to_numpy,
)
from seamless_communication_torch.cli import audio_to_units as tcli
from seamless_communication_torch.models import unit_extractor as tunit_pkg
from seamless_communication_torch.models.unit_extractor import unit_extractor as tu
from seamless_communication_torch.models.unit_extractor import wav2vec2_raw as tw
from seamless_communication_torch.ops import attention as tattn
from seamless_communication_torch.ops.kernels import launch_counts

TINY = dict(model_dim=32, feature_dim=16, conv_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)),
            pos_conv_kernel=16, pos_conv_groups=4, num_layers=3, num_heads=2,
            ffn_inner_dim=64)
JCFG, TCFG = jw.Wav2Vec2RawConfig(**TINY), tw.Wav2Vec2RawConfig(**TINY)
N_SAMPLES, LENGTHS = 4000, (4000, 2900)      # 199 and 144 frames
FEAT_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tiny ops on one intra-op thread while the file runs: the
    suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """One tree of weights in both packages' layouts (drawn by the port's
    ``wav2vec2_raw_init`` from a seeded generator: JAX's jitted init of
    threefry keys takes seconds to compile), the waveforms and 24 k-means
    centroids."""
    np_tree = wav2vec2_raw_params_to_numpy(
        tw.wav2vec2_raw_init(torch.Generator().manual_seed(0), TCFG))
    jparams = jax.tree.map(jnp.asarray, np_tree)
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, N_SAMPLES)) * 0.3).astype(np.float32)
    centroids = rng.standard_normal((24, TINY["model_dim"])).astype(np.float32)
    return dict(jparams=jparams, np_tree=np_tree, tparams=wav2vec2_raw_params_from_jax(np_tree),
                wav=wav, lens=np.asarray(LENGTHS, np.int32), centroids=centroids)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def assert_leaves_equal(want, got):
    """Same paths, shapes, dtypes and values."""
    w, g = _flat(want), _flat(got)
    assert set(w) == set(g), (sorted(set(w) ^ set(g))[:5])
    for key in w:
        assert w[key].dtype == g[key].dtype and w[key].shape == g[key].shape, key
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("out_layer_idx", [1, TINY["num_layers"] - 1])
def test_layer_output_matches_jax(models, out_layer_idx):
    """The features of one layer (the port stops there; JAX freezes the
    rest of its scan) and the valid frames of each waveform."""
    want, want_lens = jax.jit(jw.wav2vec2_layer_output, static_argnums=3,
                              static_argnames="out_layer_idx")(
        models["jparams"], jnp.asarray(models["wav"]), jnp.asarray(models["lens"]), JCFG,
        out_layer_idx=out_layer_idx)
    got, got_lens = tw.wav2vec2_layer_output(
        models["tparams"], torch.from_numpy(models["wav"]),
        torch.from_numpy(models["lens"]).long(), TCFG, out_layer_idx=out_layer_idx)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert tuple(got.shape) == (2, 199, TINY["model_dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FEAT_TOL)


def test_kmeans_matches_jax():
    """The nearest centroid of each of 600 features, as ||x||^2 - 2xC +
    ||C||^2; a repeated centroid ties, and the first one wins."""
    rng = np.random.default_rng(1)
    centroids = rng.standard_normal((40, 16)).astype(np.float32)
    centroids[7] = centroids[3]
    x = rng.standard_normal((3, 200, 16)).astype(np.float32)
    x[0, 0] = centroids[3]
    want = np.asarray(ju.KmeansModel(centroids)(jnp.asarray(x)))
    got = tu.KmeansModel(centroids)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 3


def test_unit_extractor_matches_jax(models):
    """``UnitExtractor.predict`` at the last layer: the same units, each row
    cut to its valid frames."""
    want = ju.UnitExtractor(models["jparams"], ju.KmeansModel(models["centroids"]), JCFG,
                            out_layer_idx=TINY["num_layers"] - 1).predict(
        models["wav"], models["lens"])
    ex = tu.UnitExtractor(models["tparams"], tu.KmeansModel(models["centroids"]), TCFG,
                          out_layer_idx=TINY["num_layers"] - 1, device="cpu")
    got = ex.predict(models["wav"], models["lens"])
    assert [len(u) for u in got] == [199, 144]
    assert got == want
    assert set(ex.last_timings) == {"encoder", "kmeans", "to_host"}


@pytest.mark.parametrize("writer", ["jax_export", "port_export"])
def test_pt_round_trip(models, tmp_path, writer):
    """A ``.pt`` written by either package's ``export_w2v2_raw`` reads back
    through both converters to the same leaves (the positional conv's
    weight norm folded by the same arithmetic); the two exporters write the
    same state dict."""
    jsd = jexport.export_w2v2_raw(models["np_tree"])
    tsd = texport.export_w2v2_raw(models["tparams"])
    assert set(jsd) == set(tsd)
    for key in jsd:
        assert torch.equal(jsd[key], tsd[key]), key
    path = tmp_path / "xlsr.pt"
    torch.save({"model": jsd if writer == "jax_export" else tsd}, path)
    want = jf2.wav2vec2_raw_tree_from_pt(jf2.load_pt_state_dict(str(path)))
    got = tf2.wav2vec2_raw_tree_from_pt(tf2.load_pt_state_dict(str(path)))
    assert_leaves_equal(want, wav2vec2_raw_params_to_numpy(got))


def test_audio_to_units_cli_logs_jax_units(models, tmp_path, monkeypatch, caplog):
    """``audio_to_units.main`` of both packages on one 16-bit WAV, one
    ``.pt`` and one k-means ``.npy`` (the extractors built at the tiny
    config): the same "Units:" line."""
    path = tmp_path / "xlsr.pt"
    torch.save({"model": jexport.export_w2v2_raw(models["np_tree"])}, path)
    km = tmp_path / "kmeans.npy"
    np.save(km, models["centroids"])
    wav = tmp_path / "in.wav"
    write_wav(str(wav), models["wav"][0], 16000)
    argv = [str(wav), "--kmeans_path", str(km), "--w2v2_checkpoint", str(path),
            "--out_layer_number", "2"]
    monkeypatch.setattr(junit_pkg, "UnitExtractor", functools.partial(ju.UnitExtractor, cfg=JCFG))
    monkeypatch.setattr(tunit_pkg, "UnitExtractor", functools.partial(tu.UnitExtractor, cfg=TCFG))
    monkeypatch.setattr("sys.argv", ["m4t_audio_to_units"] + argv)
    with caplog.at_level(logging.INFO, logger="audio_to_units"):
        jcli.main()
        want = [r.getMessage() for r in caplog.records if r.getMessage().startswith("Units:")]
        caplog.clear()
        res = tcli.main(argv + ["--device", "cpu"])
        got = [r.getMessage() for r in caplog.records if r.getMessage().startswith("Units:")]
    assert len(want) == 1 and got == want
    assert res.units == [int(u) for u in want[0].split()[1:]]
    assert len(res.units) == 199
    assert {"read_wav", "load", "build", "encoder", "kmeans"} <= set(res.timings)


def test_plain_flash_at_head_dim_80(monkeypatch):
    """The XLSR's attention shape at a small size (B=2, H=2, T=160, Dh=80,
    a key-padding bias): with the fused option on, ``_sdpa`` takes K6's
    plain version on the CPU (no launch) and gives the plain ``_sdpa`` of
    both packages within 1e-5."""
    rng = np.random.default_rng(5)
    B, H, T, Dh = 2, 2, 160, 80
    q, k, v = (rng.standard_normal((B, H, T, Dh)).astype(np.float32) for _ in range(3))
    pad = np.where(np.arange(T)[None] < np.array([[T], [101]]), 0.0, -1e9)
    bias = pad.astype(np.float32)[:, None, None, :]
    scale = Dh ** -0.5
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", "0")
    want = np.asarray(jattn._sdpa(*(jnp.asarray(x) for x in (q, k, v, bias)), scale=scale))
    t = [torch.from_numpy(x) for x in (q, k, v, bias)]
    plain = tattn._sdpa(*t, scale=scale)
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", "1")
    before = launch_counts["flash_attention"]
    fused = tattn._sdpa(*t, scale=scale)
    assert launch_counts["flash_attention"] == before
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-5, atol=1e-5)
