"""The port's PRETSSEL vocoder and its loading against the JAX package in
fp32 on the CPU: the streamable convs (EnCodec padding, an odd total's extra
zero on the left), the resnet block, the skip-connected LSTM (one
``torch.lstm`` call against JAX's scan), SEANet, the PRETSSEL HiFi-GAN at
the 16 kHz and 24 kHz upsampling, ``pretssel_premel`` (the smallest margin
of sigmoid(vuv) to 0.5 printed), ``pretssel_forward``, ``PretsselGenerator``
(a 0-duration EOS unit each utterance), the exporters and converters
(``.pt`` round trips, either package's exporter), ``load_pretssel_vocoder``
and ``cli/expressivity_predict.py``, on a tiny PRETSSEL (one resblock
kernel, odd upsampling rates and SEANet ratios); the converters also on one
whose layer counts are the released configs' (5 postnet convs, 4
upsamplings, 3 resblock kernels, 4 SEANet ratios) at narrow widths.

The mel and the ECAPA embedding within 1e-5, waveforms within 1e-4 (a
stack of fp32 convolutions and an LSTM of two libraries); lengths, units
and converted leaves identical. TF32 is off (it is off on the CPU anyway).
Every random input comes from numpy's seeded generators."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.checkpoint import convert_fairseq2 as jf2
from seamless_communication_tpu.checkpoint import fairseq_export as jexport
from seamless_communication_tpu.inference.pretssel_generator import (
    PretsselGenerator as JPretsselGenerator, unique_consecutive as j_unique_consecutive,
)
from seamless_communication_tpu.models.pretssel import streamable as jst
from seamless_communication_tpu.models.pretssel import vocoder as jvoc
from seamless_communication_tpu.models.pretssel.ecapa_tdnn import EcapaConfig as JEcapa
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.models.unity.t2u import (
    variance_predictor as j_variance_predictor,
)
from seamless_communication_tpu.models.vocoder import hifigan as jhifi

from seamless_communication_torch.checkpoint import convert_fairseq2 as tf2
from seamless_communication_torch.checkpoint import fairseq_export as texport
from seamless_communication_torch.checkpoint.from_jax import (
    to_numpy, to_torch, unity_params_from_jax,
    unity_params_to_numpy,
)
from seamless_communication_torch.inference.pretssel_generator import (
    PretsselGenerator, unique_consecutive, unit_batch,
)
from seamless_communication_torch.models.pretssel import streamable as tst
from seamless_communication_torch.models.pretssel import vocoder as tvoc
from seamless_communication_torch.models.pretssel.ecapa_tdnn import EcapaConfig
from seamless_communication_torch.models.unity import model as tunity
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.unity.t2u import variance_predictor
from seamless_communication_torch.models.vocoder import hifigan as thifi

from test_torch_checkpoint import assert_trees_equal

MEL_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tiny ops on one intra-op thread and TF32 off while the file
    runs, both restored after: the suite runs six workers at once, and
    torch's default of a thread a core in each of them slows these files
    several times over."""
    n = torch.get_num_threads()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(n)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


WAV_TOL = dict(rtol=0, atol=1e-4)

# the tiny PRETSSEL: an odd upsampling rate (the output padding) and an odd
# SEANet ratio (the odd EnCodec padding), one resblock kernel
ECAPA = dict(channels=(16, 16, 16, 16, 32), attention_channels=8, res2net_scale=4,
             se_channels=8, embed_dim=16)
HIFI = dict(model_in_dim=80, upsample_initial_channel=32, upsample_rates=(5, 3),
            upsample_kernel_sizes=(10, 6), resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),), add_ups_out_pad=True, final_tanh=False)
SEANET = dict(dimension=16, n_filters=4, ratios=(5, 2), lstm=2)
PRETSSEL = dict(num_units=112, model_dim=32, num_heads=2, ffn_inner_dim=64,
                conv_kernel_size=5, num_encoder_layers=2, num_decoder_layers=2,
                num_langs=4, lang_embed_dim=8, prosody_dim=16, pn_conv_dim=16,
                pn_layers=2, pn_kernel_size=5, var_pred_hidden=16)
# the released configs' layer counts (the converters decode the flat layer
# list by them)
RELEASED = dict(hifi=dict(HIFI, upsample_rates=(5, 4, 2, 3),
                          upsample_kernel_sizes=(10, 8, 4, 6),
                          resblock_kernel_sizes=(3, 7, 11),
                          resblock_dilation_sizes=((1, 3, 5),) * 3),
                seanet=dict(SEANET, n_filters=2, ratios=(5, 4, 2, 2)),
                pretssel=dict(PRETSSEL, pn_layers=5))


def jcfg(released: bool = False) -> jvoc.PretsselConfig:
    hifi, sea, pre = ((RELEASED["hifi"], RELEASED["seanet"], RELEASED["pretssel"])
                      if released else (HIFI, SEANET, PRETSSEL))
    return jvoc.PretsselConfig(**pre, hifigan=jhifi.HifiGanConfig(**hifi),
                               seanet=jst.SeanetConfig(**sea), ecapa=JEcapa(**ECAPA))


def tcfg(released: bool = False) -> tvoc.PretsselConfig:
    hifi, sea, pre = ((RELEASED["hifi"], RELEASED["seanet"], RELEASED["pretssel"])
                      if released else (HIFI, SEANET, PRETSSEL))
    return tvoc.PretsselConfig(**pre, hifigan=thifi.HifiGanConfig(**hifi),
                               seanet=tst.SeanetConfig(**sea), ecapa=EcapaConfig(**ECAPA))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def released():
    """A port tree at the released layer counts, its postnet norms
    non-trivial (no JAX init: the converters are what it tests)."""
    tp = tvoc.pretssel_init(torch.Generator().manual_seed(5), tcfg(True))
    gen = torch.Generator().manual_seed(6)
    for lp in tp["postnet"]:
        n = lp["norm"]["scale"].shape[0]
        lp["norm"] = {"scale": torch.rand(n, generator=gen) + 0.5,
                      "bias": torch.randn(n, generator=gen) * 0.1}
    return tp


def make_pretssel(seed: int):
    """A tiny PRETSSEL as a JAX tree and the port's copy of it. The tree is
    drawn by the port's ``pretssel_init`` (eager JAX draws of its ~600
    leaves would cost most of this file's time on the CPU) and handed to
    JAX as numpy; its postnet norms and normalisation statistics are made
    non-trivial from a numpy seed. ``from_jax.to_torch`` carries it back."""
    tp = tvoc.pretssel_init(torch.Generator().manual_seed(seed), tcfg())
    p = to_numpy(tp)
    rng = np.random.default_rng(seed)
    for lp in p["postnet"]:
        n = lp["norm"]["scale"].shape[0]
        lp["norm"] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                      "bias": rng.normal(0, 0.1, n).astype(np.float32)}
    for k in ("gcmvn_mean", "mean"):
        p[k] = rng.normal(0.0, 0.5, 80).astype(np.float32)
    for k in ("gcmvn_std", "scale"):
        p[k] = rng.uniform(0.8, 1.5, 80).astype(np.float32)
    return jax.tree.map(jnp.asarray, p), to_torch(p)


@pytest.fixture(scope="module")
def pretssel():
    return make_pretssel(4)


@pytest.mark.parametrize("k,stride,dilation,causal", [
    (7, 1, 1, False), (10, 5, 1, False), (8, 4, 1, True), (3, 1, 3, False), (4, 1, 1, False)])
def test_streamable_conv(k, stride, dilation, causal):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, 23, 3)).astype(np.float32)
    p = {"weight": rng.standard_normal((k, 3, 4)).astype(np.float32),
         "bias": rng.standard_normal(4).astype(np.float32)}
    kw = dict(stride=stride, dilation=dilation, causal=causal)
    want = jst.streamable_conv(jax.tree.map(jnp.asarray, p), jnp.asarray(x), **kw)
    got = tst.streamable_conv(to_torch(p), _t(x), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MEL_TOL)


@pytest.mark.parametrize("k,stride,causal,trim", [(10, 5, False, 1.0), (8, 4, True, 1.0),
                                                  (6, 3, True, 0.5)])
def test_streamable_conv_transpose(k, stride, causal, trim):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 9, 4)).astype(np.float32)
    p = {"weight": rng.standard_normal((k, 4, 3)).astype(np.float32),
         "bias": rng.standard_normal(3).astype(np.float32)}
    kw = dict(stride=stride, causal=causal, trim_right_ratio=trim)
    want = jst.streamable_conv_transpose(jax.tree.map(jnp.asarray, p), jnp.asarray(x), **kw)
    got = tst.streamable_conv_transpose(to_torch(p), _t(x), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MEL_TOL)


@pytest.mark.parametrize("num_layers", [0, 1, 2])
def test_lstm_forward(num_layers):
    """One ``torch.lstm`` call (gates i, f, g, o; ``wx``'s bias as
    ``bias_ih``, ``bias_hh`` zero) against JAX's step scan."""
    layers = jst.lstm_init(jax.random.PRNGKey(num_layers), 12, num_layers)
    x = np.random.default_rng(num_layers).standard_normal((2, 31, 12)).astype(np.float32)
    want = jst.lstm_forward(layers, jnp.asarray(x))
    got = tst.lstm_forward(to_torch(_np(layers)), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MEL_TOL)
    resblock = jst.resnet_block_init(jax.random.PRNGKey(7), 12, true_skip=False)
    want = jst.resnet_block(resblock, jnp.asarray(x))
    got = tst.resnet_block(to_torch(_np(resblock)), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MEL_TOL)


def test_seanet_forward(pretssel):
    p, tp = pretssel
    x = (np.random.default_rng(8).standard_normal((2, 803, 1)) * 0.3).astype(np.float32)
    want = jax.jit(lambda p, x: jst.seanet_forward(p, x, jcfg().seanet))(
        p["seanet"], jnp.asarray(x))
    got = tst.seanet_forward(tp["seanet"], _t(x), tcfg().seanet)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **WAV_TOL)


@pytest.mark.parametrize("which", ["16khz", "24khz"])
def test_pretssel_hifigan_configs(which):
    """The PRETSSEL HiFi-GAN variant at each released config's upsampling
    (rates and kernels), at a narrow width."""
    full = {"16khz": tvoc.pretssel_16khz_config,
            "24khz": tvoc.pretssel_24khz_config}[which]().hifigan
    jfull = {"16khz": jvoc.pretssel_16khz_config,
             "24khz": jvoc.pretssel_24khz_config}[which]().hifigan
    assert full._asdict() == jfull._asdict()
    jc = jfull._replace(upsample_initial_channel=32)
    tc = full._replace(upsample_initial_channel=32)
    params = to_numpy(thifi.hifigan_init(torch.Generator().manual_seed(9), tc))
    x = np.random.default_rng(9).standard_normal((1, 7, 80)).astype(np.float32)
    want = jax.jit(lambda p, x: jhifi.hifigan_forward(p, x, jc))(params, jnp.asarray(x))
    got = thifi.hifigan_forward(to_torch(_np(params)), _t(x), tc)
    assert got.shape == want.shape == (1, 7 * tc.total_upsample)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **WAV_TOL)


def _units(seed: int, n: int = 13):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 100, n).tolist()
    u[3:6] = [u[3]] * 3                       # a repeated unit
    return u


def _prosody(seed: int, T: int = 96, valid: int = 80):
    f = np.zeros((1, T, 80), np.float32)
    f[0, :valid] = np.random.default_rng(seed).standard_normal((valid, 80))
    return f, np.array([valid], np.int32)


def test_pretssel_premel_and_vuv_margin(pretssel, capsys):
    """The pre-mel half with a 0-duration EOS unit; the mel within 1e-5.
    Prints the smallest margin of sigmoid(vuv) to 0.5 over the real units:
    a flip there would change the pitch."""
    p, tp = pretssel
    u_arr, d_arr, n, M = unit_batch(_units(10))
    assert d_arr[0, n - 1] == 0 and u_arr[0, n - 1] == 2
    f, fl = _prosody(10)
    lang = np.array([1], np.int32)
    jcond = jnp.concatenate([
        jvoc.ecapa_forward(p["prosody_encoder"], jnp.asarray(f), jcfg().ecapa,
                           padding_mask=jnp.arange(96)[None] < fl[:, None])[:, None],
        p["embed_lang"]["embedding"][jnp.asarray(lang)][:, None]], axis=-1)
    tcond = tvoc.pretssel_cond(tp, tcfg(), _t(f), _t(fl), _t(lang))
    np.testing.assert_allclose(tcond.numpy(), np.asarray(jcond), **MEL_TOL)
    lens = np.array([n], np.int32)
    jm, jtot, _ = jax.jit(lambda *a: jvoc.pretssel_premel(p, jcfg(), *a, max_mel_len=M))(
        jnp.asarray(u_arr), jnp.asarray(lens), jnp.asarray(d_arr), jcond)
    tm, ttot, _ = tvoc.pretssel_premel(tp, tcfg(), _t(u_arr), _t(lens), _t(d_arr), tcond,
                                       max_mel_len=M)
    assert int(ttot[0]) == int(jtot[0]) == int(d_arr.sum())
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **MEL_TOL)
    # the vuv gate's margin, from the encoder output both packages agree on
    x = tvoc.embedding(tp["embed_tokens"], _t(u_arr))
    x = tvoc._alpha_sin_pos(x, tp["pos_emb_alpha_enc"], 1)
    mask = torch.arange(u_arr.shape[1])[None] < n
    bias = tvoc.padding_bias(mask)
    for lp in tp["encoder_layers"]:
        x = tvoc.fft_layer(lp, x, bias, mask, tcfg().fft_cfg(), cond=tcond)
    vuv = variance_predictor(tp["vuv_predictor"], x, mask, cond=tcond)[0, :n]
    jx = jnp.asarray(x.numpy())
    jvuv = np.asarray(j_variance_predictor(p["vuv_predictor"], jx, jnp.asarray(mask.numpy()),
                                           cond=jcond))[0, :n]
    margin = float((torch.sigmoid(vuv) - 0.5).abs().min())
    with capsys.disabled():
        print(f"\nPRETSSEL tiny: smallest |sigmoid(vuv) - 0.5| over {n} units: "
              f"{margin:.4g}; voiced units: {int((torch.sigmoid(vuv) >= 0.5).sum())}")
    np.testing.assert_array_equal(torch.sigmoid(vuv).numpy() >= 0.5,
                                  1 / (1 + np.exp(-jvuv)) >= 0.5)
    assert margin > 1e-5


def test_pretssel_forward(pretssel):
    """Two utterances padded together; mel within 1e-5, waveforms within
    1e-4, sample lengths identical; ``duration_factor`` does nothing; a
    second prosody input changes the waveform in both packages."""
    p, tp = pretssel
    rows = [unit_batch(_units(11)), unit_batch(_units(12, 7))]
    U = max(r[0].shape[1] for r in rows)
    M = max(r[3] for r in rows)
    units = np.ones((2, U), np.int64)
    durs = np.zeros((2, U), np.int64)
    for i, (u, d, n, _) in enumerate(rows):
        units[i, :n], durs[i, :n] = u[0, :n], d[0, :n]
    lens = np.array([r[2] for r in rows])
    f0, l0 = _prosody(11)
    f1, l1 = _prosody(12, valid=60)
    fb, fl = np.concatenate([f0, f1]), np.concatenate([l0, l1])
    lang = np.array([0, 3])
    outs = []
    jforward = jax.jit(lambda *a: jvoc.pretssel_forward(p, jcfg(), *a, max_mel_len=M))
    for fbank in (fb, fb[::-1].copy() * 2.0):
        want = jforward(*map(jnp.asarray, (units, lens, durs, fbank, fl, lang)))
        for factor in (1.0, 1.7):
            got = tvoc.pretssel_forward(tp, tcfg(), *map(_t, (units, lens, durs, fbank, fl,
                                                              lang)),
                                        max_mel_len=M, duration_factor=factor)
            np.testing.assert_array_equal(got.sample_lengths.numpy(),
                                          np.asarray(want.sample_lengths))
            np.testing.assert_allclose(got.mel.numpy(), np.asarray(want.mel), **MEL_TOL)
            assert got.waveform.shape == want.waveform.shape
            np.testing.assert_allclose(got.waveform.numpy(), np.asarray(want.waveform),
                                       **WAV_TOL)
        outs.append((np.asarray(want.mel), np.asarray(want.waveform), got.mel.numpy(),
                     got.waveform.numpy()))
    for i, floor in enumerate((1e-2, 1e-5, 1e-2, 1e-5)):
        assert np.abs(outs[0][i] - outs[1][i]).max() > floor


def test_pretssel_generator(pretssel):
    p, tp = pretssel
    batch = [_units(13), [], _units(14, 5)]
    assert unique_consecutive(batch[0]) == j_unique_consecutive(batch[0])
    f0, l0 = _prosody(13)
    f2, l2 = _prosody(14, valid=96)
    fb = np.concatenate([f0, f0, f2])
    fl = np.concatenate([l0, l0, l2])
    jgen = JPretsselGenerator(p, jcfg(), lang_to_index={"eng": 0, "fra": 2})
    tgen = PretsselGenerator(tp, tcfg(), lang_to_index={"eng": 0, "fra": 2}, device="cpu")
    want = jgen.predict(batch, "fra", fb, fl)
    got = tgen.predict(batch, "fra", fb, fl, duration_factor=0.5)
    assert [g.shape for g in got] == [np.asarray(w).shape for w in want]
    assert got[1].size == 0 and got[0].size > 0
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), **WAV_TOL)
    assert set(tgen.last_timings) == {"premel", "wave_synth"}
    total = tcfg().hifigan.total_upsample
    assert tgen.last_mel_frames == [g.size // total for g in got]


def test_pretssel_pt_round_trips(released, tmp_path):
    """At the released layer counts: the port's exporter -> ``.pt`` -> the
    port's converter gives back every leaf exactly, as the file holds it: in
    fp32 every leaf but the HiFi-GAN's weight-norm convs bit for bit
    (``assert_as_exported``), the folded ones bit for bit as the JAX
    converter folds the same file; in fp16 every leaf rounded to fp16 equals
    the file's value. The JAX exporter's state dict -> the port's converter
    equals the JAX converter's tree carried across, bit for bit."""
    tp = released
    p = jax.tree.map(jnp.asarray, to_numpy(tp))
    cfg = tcfg(True)
    sd = texport.export_pretssel(tp, cfg)
    torch.save({"model": sd}, tmp_path / "p.pt")
    tree = tf2.pretssel_tree_from_pt(tf2.load_pt_state_dict(str(tmp_path / "p.pt")), cfg)
    want = dict(tp, gcmvn_mean=torch.zeros(80), gcmvn_std=torch.ones(80))
    assert_as_exported(want, tree)
    assert_trees_equal(to_torch(_np(jf2.pretssel_tree_from_pt(
        {k: v.numpy() for k, v in sd.items()}, jcfg(True)))), tree)
    sd16 = texport.export_pretssel(tp, cfg, dtype=torch.float16)
    assert sd16["layers.0.1.running_var"].dtype == torch.float32
    tree16 = tf2.pretssel_tree_from_pt(sd16, cfg)
    n = 0
    for path, a, b in _pairs(want, tree16):
        assert torch.equal(a.half(), b.half()), path
        n += 1
    assert n == len(list(_pairs(want, want)))
    jsd = jexport.export_pretssel(p, jcfg(True))
    jtree = jf2.pretssel_tree_from_pt(jsd, jcfg(True))
    assert_trees_equal(to_torch(_np(jtree)), tf2.pretssel_tree_from_pt(
        {k: _t(v.numpy()) for k, v in jsd.items()}, cfg))


def assert_as_exported(want: dict, got: dict) -> None:
    """Every leaf bit for bit, but the HiFi-GAN's weight-norm conv weights:
    the fold g * v / ||v|| rounds twice, and the exporter's g = ||v|| (the
    JAX exporter's arithmetic, bit for bit) sums the squares in another
    order than the fold's norm, so they come back within 8 ulps (4 seen)."""
    assert_trees_equal({k: v for k, v in want.items() if k != "hifigan"},
                       {k: v for k, v in got.items() if k != "hifigan"})
    for path, a, b in _pairs(want["hifigan"], got["hifigan"]):
        if path.endswith("bias"):
            assert torch.equal(a, b), path
        else:
            ulp = torch.finfo(torch.float32).eps * a.abs().clamp_min(1e-30)
            assert bool(((a - b).abs() <= 8 * ulp).all()), path


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}/{i}")
    else:
        yield path, a, b


def expressive_unity(seed: int) -> dict:
    """A ``tiny_expressive`` UnitY as a JAX tree, drawn by the port's
    ``unity_init`` and laid out as the JAX package's (``unity_params_to_numpy``);
    tests/test_torch_expressive.py draws one with JAX's own init."""
    tp = tunity.unity_init(torch.Generator().manual_seed(seed), get_arch("tiny_expressive"))
    return jax.tree.map(jnp.asarray, unity_params_to_numpy(tp))


def test_expressive_unity_pt_round_trips(tmp_path):
    """An expressive UnitY (ECAPA, FiLM, prosody_proj) through either
    package's exporter and the port's converter."""
    jp = expressive_unity(5)
    want = unity_params_from_jax(_np(jp))
    sd = texport.export_unity(want)
    torch.save({"model": sd}, tmp_path / "u.pt")
    got = tf2.unity_tree_from_fairseq2(tf2.load_pt_state_dict(str(tmp_path / "u.pt")))
    assert_trees_equal(want, got)
    jsd = jexport.export_unity(jp)
    jtree = jf2.unity_tree_from_fairseq2(jsd)
    assert_trees_equal(unity_params_from_jax(_np(jtree)), tf2.unity_tree_from_fairseq2(
        {k: _t(v.numpy()) for k, v in jsd.items()}))


def _write_cards(d, sample_rate: int):
    (d / "smoke_pretssel.yaml").write_text(
        f"name: smoke_pretssel\nbase: vocoder_pretssel\ncheckpoint: {d / 'p.pt'}\n"
        f"sample_rate: {sample_rate}\n")


@pytest.mark.parametrize("sample_rate", [16000, 24000])
def test_load_pretssel_vocoder(released, tmp_path, monkeypatch, sample_rate):
    """The card's sample rate picks the config (the converter decodes the
    flat layer list by it); the leaves are the file's; the card's langs and
    gcmvn statistics come back; the vocoder's own gcmvn stays the
    identity."""
    from seamless_communication_tpu.cli import loading as jloading

    from seamless_communication_torch.cli import loading
    tp = released
    torch.save({"model": texport.export_pretssel(tp, tcfg(True))}, tmp_path / "p.pt")
    _write_cards(tmp_path, sample_rate)
    monkeypatch.setenv("SEAMLESS_CARDS_DIR", str(tmp_path))
    rates = {16000: (5, 4, 2, 2), 24000: (5, 4, 2, 3)}
    for rate, name in ((16000, "pretssel_16khz_config"), (24000, "pretssel_24khz_config")):
        hifi = thifi.HifiGanConfig(**dict(RELEASED["hifi"], upsample_rates=rates[rate]))
        monkeypatch.setattr(loading, name, lambda h=hifi: tcfg(True)._replace(hifigan=h))
    params, cfg, mc, rate = loading.load_pretssel_vocoder("smoke_pretssel", device="cpu")
    assert rate == sample_rate and cfg.hifigan.upsample_rates == rates[sample_rate]
    assert mc["langs"][:3] == ["cmn", "deu", "eng"] and len(mc["gcmvn_stats"]["mean"]) == 80
    assert_as_exported(dict(tp, gcmvn_mean=torch.zeros(80), gcmvn_std=torch.ones(80)),
                       params)
    _, _, jmc, jrate = jloading.load_pretssel_vocoder("smoke_pretssel")
    assert jrate == rate and jmc == mc


def test_expressivity_predict_cli(pretssel, tmp_path, monkeypatch):
    """``cli/expressivity_predict.main`` on the CPU from ``.pt`` files
    (``tiny_expressive`` UnitY, the tiny PRETSSEL at 24 kHz): the text and
    units of the JAX Translator, and the waveform of the JAX
    ``PretsselGenerator``, on the same trees and the same two
    normalisations, within 1e-4. Both loaders cast the UnitY to bf16 by
    default, and JAX's S2ST raises in bf16 (``test_jax_bf16_redecode_raises``):
    the port's load is made fp32 here."""
    from seamless_communication_tpu.audio.fbank import fbank_numpy as j_fbank
    from seamless_communication_tpu.inference.generator import (
        SequenceGeneratorOptions as JOptions,
    )
    from seamless_communication_tpu.inference.translator import Translator as JTranslator
    from seamless_communication_tpu.models.unity.unit_tokenizer import (
        UnitTokenizer as JUnitTokenizer,
    )
    from seamless_communication_tpu.text.char_tokenizer import (
        CharTokenizer as JCharTokenizer,
    )
    from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
    from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

    from seamless_communication_torch.audio.wav import read_wav, write_wav
    from seamless_communication_torch.cli import expressivity_predict, loading
    from seamless_communication_torch.assets import load_card

    from test_torch_translator_s2st import CHAR_SPM, LANGS, TEXT_SPM
    p, tp = pretssel
    jp = expressive_unity(6)
    torch.save({"model": texport.export_unity(unity_params_from_jax(_np(jp)))},
               tmp_path / "u.pt")
    torch.save({"model": texport.export_pretssel(tp, tcfg())}, tmp_path / "p.pt")
    (tmp_path / "text.model").write_bytes(TEXT_SPM)
    (tmp_path / "char.model").write_bytes(CHAR_SPM)
    (tmp_path / "smoke_expressive.yaml").write_text(
        f"name: smoke_expressive\nbase: seamless_expressivity\nmodel_arch: tiny_expressive\n"
        f"checkpoint: {tmp_path / 'u.pt'}\ntokenizer: {tmp_path / 'text.model'}\n"
        f"char_tokenizer: {tmp_path / 'char.model'}\nlangs: [eng, fra]\nnum_units: 100\n"
        f"unit_langs: [eng, fra]\n")
    _write_cards(tmp_path, 24000)
    monkeypatch.setenv("SEAMLESS_CARDS_DIR", str(tmp_path))
    monkeypatch.setattr(loading, "pretssel_24khz_config", tcfg)
    monkeypatch.setattr(loading, "load_unity_model_and_tokenizers", functools.partial(
        loading.load_unity_model_and_tokenizers, dtype=torch.float32))
    wav = (np.random.default_rng(15).standard_normal(16000 * 2) * 0.1).astype(np.float32)
    write_wav(str(tmp_path / "in.wav"), wav, 16000)
    res = expressivity_predict.main([
        str(tmp_path / "in.wav"), "--tgt_lang", "fra", "--model_name", "smoke_expressive",
        "--vocoder_name", "smoke_pretssel", "--output_path", str(tmp_path / "out.wav"),
        "--device", "cpu", "--text_generation_max_len_a", "0",
        "--text_generation_max_len_b", "12",
        "--duration_factor", "1.1"])
    out, rate = read_wav(str(tmp_path / "out.wav"))
    assert rate == res.sample_rate == 24000 and out.size == res.waveform.size > 0

    # the JAX package's steps of its expressivity_predict on the same trees
    mc = load_card("smoke_pretssel")["model_config"]
    mean = np.asarray(mc["gcmvn_stats"]["mean"])
    std = np.asarray(mc["gcmvn_stats"]["std"])
    wav = read_wav(str(tmp_path / "in.wav"))[0]          # as the CLI reads it
    fbank = j_fbank(wav)
    gcmvn = ((fbank - mean[None]) / std[None]).astype(np.float32)
    jt = JTranslator(jp, jget_arch("tiny_expressive"),
                     JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS),
                     JUnitTokenizer(100, ["eng", "fra"], "base_v2"),
                     JCharTokenizer(JSpm.from_bytes(CHAR_SPM)))
    jtexts, jspeech = jt.predict(
        wav, "s2st", "fra", duration_factor=1.1, prosody_encoder_input=gcmvn,
        text_generation_opts=JOptions(soft_max_seq_len=(0, 12)))
    assert res.texts == jtexts and res.units == jspeech.units and len(res.units[0]) > 0
    jtree = dict(p, gcmvn_mean=jnp.zeros(80), gcmvn_std=jnp.ones(80))
    jgen = JPretsselGenerator(jtree, jcfg(), lang_to_index={
        lang: i for i, lang in enumerate(mc["langs"])}, sample_rate=24000)
    jwav = jgen.predict(jspeech.units, "fra", gcmvn[None], np.array([gcmvn.shape[0]]))[0]
    np.testing.assert_allclose(res.waveform, np.asarray(jwav), **WAV_TOL)


def test_jax_bf16_redecode_raises():
    """A fault of the JAX package the port does not copy: with bf16
    parameters (its loaders' default) and the fp32 encoder output an fp32
    fbank gives, JAX's full-sequence re-decode promotes the hidden states to
    fp32 in the cross-attention and its layer ``lax.scan`` raises on the
    carry's dtype, so its ``expressivity_predict`` (and any S2ST) cannot run
    as loaded. The port's re-decode runs."""
    from seamless_communication_tpu.models.unity import model as junity
    from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch

    from seamless_communication_torch.device import params_to

    jp = expressive_unity(7)
    rng = np.random.default_rng(7)
    ids = rng.integers(4, 256, (1, 9))
    enc = rng.standard_normal((1, 12, 64)).astype(np.float32)
    lens = np.array([12])
    with pytest.raises(TypeError, match="carry"):
        jax.jit(lambda p, i, e, n: junity.decode_text(
            p, jget_arch("tiny_expressive"), i, junity.EncoderOutput(e, n)))(
            jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp), jnp.asarray(ids),
            jnp.asarray(enc), jnp.asarray(lens))
    tp = params_to(unity_params_from_jax(_np(jp)), "cpu", torch.bfloat16)
    out = tunity.decode_text(tp, get_arch("tiny_expressive"), _t(ids),
                             tunity.EncoderOutput(_t(enc), _t(lens)))
    assert out.shape == (1, 9, 64) and bool(out.float().isfinite().all())
