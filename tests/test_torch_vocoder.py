"""The port's unit vocoder against the JAX package in fp32 on the CPU:
``conv_transpose1d`` with and without ``output_padding``, and
``code_hifigan_forward`` on the tiny vocoder of
tests/integration/conftest.py, carried across by ``checkpoint/from_jax.py``.

Waveforms within 1e-5 absolute: a stack of fp32 convolutions from two
libraries, summed in different orders, ends in a tanh (observed difference
below 1e-7). Sample lengths identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.models.vocoder.codehifigan import (
    CodeHifiGanConfig as JCodeHifiGanConfig, code_hifigan_forward as j_forward,
    code_hifigan_init as j_init,
)
from seamless_communication_tpu.models.vocoder.hifigan import (
    HifiGanConfig as JHifiGanConfig, hifigan_forward as j_hifigan_forward,
)
from seamless_communication_tpu.ops.modules import conv_transpose1d as j_conv_transpose1d

from seamless_communication_torch.checkpoint.from_jax import to_torch
from seamless_communication_torch.models.vocoder.codehifigan import (
    CodeHifiGanConfig, code_hifigan_forward,
)
from seamless_communication_torch.models.vocoder.hifigan import (
    HifiGanConfig, hifigan_forward,
)
from seamless_communication_torch.ops.modules import conv_transpose1d

from test_torch_translator_s2st import HIFIGAN, VOCODER


@pytest.mark.parametrize("stride,kernel,padding,output_padding", [
    (5, 11, 3, 0), (4, 8, 2, 0), (2, 4, 1, 0), (5, 11, 4, 1), (3, 7, 3, 1), (2, 3, 0, 1)])
def test_conv_transpose1d(stride, kernel, padding, output_padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    p = {"weight": rng.standard_normal((kernel, 6, 5)).astype(np.float32),
         "bias": rng.standard_normal((5,)).astype(np.float32)}
    kw = dict(stride=stride, padding=padding, output_padding=output_padding)
    want = j_conv_transpose1d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), **kw)
    got = conv_transpose1d(to_torch(p), torch.from_numpy(x), **kw)
    assert got.shape == want.shape == (2, (9 - 1) * stride - 2 * padding + kernel
                                       + output_padding, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def vocoder():
    jcfg = JCodeHifiGanConfig(**VOCODER, hifigan=JHifiGanConfig(**HIFIGAN))
    jparams = j_init(jax.random.PRNGKey(1), jcfg)
    tcfg = CodeHifiGanConfig(**VOCODER, hifigan=HifiGanConfig(**HIFIGAN))
    return jparams, jcfg, to_torch(jax.tree.map(np.asarray, jparams)), tcfg


@pytest.mark.parametrize("max_unit_len,dur_prediction",
                         [(None, True), (40, True), (None, False)])
def test_code_hifigan_forward(vocoder, max_unit_len, dur_prediction):
    """Two utterances with padding: with duration prediction, and with
    ``max_unit_len`` 40 cutting the upsampled frames (the sample lengths stay
    uncapped); and without it, one frame a unit, as the streaming vocoder
    calls it."""
    jparams, jcfg, tparams, tcfg = vocoder
    rng = np.random.default_rng(1)
    units = rng.integers(0, 120, (2, 32)).astype(np.int32)   # ids past num_units clip
    lens = np.array([32, 19], np.int32)
    lang, spkr = np.array([1, 0], np.int32), np.array([1, 3], np.int32)
    kw = dict(max_unit_len=max_unit_len, dur_prediction=dur_prediction)
    want = j_forward(jparams, jcfg, *map(jnp.asarray, (units, lens, lang, spkr)), **kw)
    got = code_hifigan_forward(tparams, tcfg, *map(torch.from_numpy,
                                                   (units, lens, lang, spkr)), **kw)
    np.testing.assert_array_equal(got.sample_lengths.numpy(),
                                  np.asarray(want.sample_lengths))
    assert got.waveform.shape == want.waveform.shape
    np.testing.assert_allclose(got.waveform.numpy(), np.asarray(want.waveform),
                               rtol=0, atol=1e-5)


def test_hifigan_output_padding_variant(vocoder):
    """The PRETSSEL variant of the generator (odd upsampling rates with
    output padding, no final tanh) on the same weights."""
    jparams, _, tparams, _ = vocoder
    kw = dict(HIFIGAN, upsample_rates=(3, 2), upsample_kernel_sizes=(8, 4),
              add_ups_out_pad=True, final_tanh=False)
    x = np.random.default_rng(2).standard_normal((1, 7, 48)).astype(np.float32)
    want = j_hifigan_forward(jparams["hifigan"], jnp.asarray(x), JHifiGanConfig(**kw))
    got = hifigan_forward(tparams["hifigan"], torch.from_numpy(x), HifiGanConfig(**kw))
    assert got.shape == want.shape == (1, 7 * 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
