"""The SeamlessStreaming speech encoder of the port against the JAX
package's, fp32 on the CPU, on the tiny chunk-causal encoder of the JAX
incremental-encoder test (dim 64, 3 Shaw layers, chunk 4, all chunks to the
left, causal depthwise conv): the chunk attention bias exactly; the chunked
``speech_encoder_forward`` and the standalone conformer-shaw forward within
1e-5; the incremental encoder against JAX's incremental encoder and against
the port's own full forward, on the frames of completed chunks, within the
JAX test's 2e-5; and the ``streaming`` arch as JAX defines it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.models.wav2vec2 import encoder as jenc
from seamless_communication_tpu.models.wav2vec2 import incremental as jinc
from seamless_communication_tpu.ops import conformer as jconformer

from seamless_communication_torch.checkpoint.from_jax import speech_encoder_from_jax
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.wav2vec2 import encoder as enc
from seamless_communication_torch.models.wav2vec2 import incremental as inc
from seamless_communication_torch.ops import conformer
from seamless_communication_torch.ops.conformer import ConformerConfig

TOL = dict(rtol=1e-5, atol=1e-5)
INC_TOL = dict(rtol=1e-5, atol=2e-5)      # tests/unit/test_incremental_encoder.py's
CONF = dict(dim=64, ffn_inner_dim=128, num_heads=4, num_layers=3, depthwise_kernel_size=7,
            pos_type="shaw", shaw_max_left=8, shaw_max_right=3, causal_depthwise_conv=True)
SPEECH = dict(model_dim=64, feature_dim=160, ffn_inner_dim=128, num_adaptor_heads=4,
              chunk_size=4, left_chunk_num=-1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jenc.SpeechEncoderConfig(conformer=jconformer.ConformerConfig(**CONF), **SPEECH)
    cfg = enc.SpeechEncoderConfig(conformer=ConformerConfig(**CONF), **SPEECH)
    jparams = jenc.speech_encoder_init(jax.random.PRNGKey(0), jcfg)
    params = speech_encoder_from_jax(jax.tree.map(np.asarray, jparams))
    fbank = np.random.default_rng(0).standard_normal((1, 96, 80)).astype(np.float32)
    return jcfg, jparams, cfg, params, fbank


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("left", [-1, 1])
def test_chunk_attention_bias(chunk, left):
    got = conformer.chunk_attention_bias(37, chunk, left)
    want = np.asarray(jconformer.chunk_attention_bias(37, chunk, left))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("frames", [96, 70])
def test_chunked_forward(setup, frames):
    """The chunked encoder over a padded batch: 96 frames, and 70 valid of
    96 (a padded tail inside a chunk)."""
    jcfg, jparams, cfg, params, fbank = setup
    lens = np.array([frames])
    got, glen = enc.speech_encoder_forward(params, torch.from_numpy(fbank),
                                           torch.from_numpy(lens), cfg)
    want, wlen = jenc.speech_encoder_forward(jparams, jnp.asarray(fbank),
                                             jnp.asarray(lens), jcfg)
    assert glen.tolist() == np.asarray(wlen).tolist()
    close(got, want)
    # the chunking is on: without it the outputs differ
    full, _ = enc.speech_encoder_forward(params, torch.from_numpy(fbank),
                                         torch.from_numpy(lens),
                                         cfg._replace(chunk_size=None))
    assert float((full - got).abs().max()) > 1e-3


def test_conformer_shaw_standalone(setup):
    jcfg, jparams, cfg, params, fbank = setup
    lens = np.array([90])
    got, glen = enc.conformer_shaw_standalone_forward(
        params, torch.from_numpy(fbank), torch.from_numpy(lens), cfg)
    want, wlen = jenc.conformer_shaw_standalone_forward(
        jparams, jnp.asarray(fbank), jnp.asarray(lens), jcfg)
    assert glen.tolist() == np.asarray(wlen).tolist() == [45]
    close(got, want)


def test_incremental_matches_jax_and_full(setup):
    """Fed in chunk-aligned pieces of 16, 32, 24, 24 fbank frames, then a
    zero-padded partial final block of 20 frames (10 stacked valid of 16)."""
    jcfg, jparams, cfg, params, fbank = setup
    state = inc.speech_encoder_stream_init(cfg, max_frames=64)
    jstate = jinc.speech_encoder_stream_init(jcfg, batch=1, max_frames=64)
    pos = 0
    tail = np.zeros((1, 32, 80), np.float32)
    tail[:, :20] = np.random.default_rng(1).standard_normal((1, 20, 80))
    stream = np.concatenate([fbank, tail[:, :20]], axis=1)
    for n, n_valid in ((16, None), (32, None), (24, None), (24, None), (32, 10)):
        block = fbank[:, pos:pos + n] if n_valid is None else tail
        state = inc.speech_encoder_stream_step(params, state, torch.from_numpy(block), cfg,
                                               n_valid=n_valid)
        jstate = jinc.speech_encoder_stream_step(
            jparams, jstate, jnp.asarray(block), jcfg,
            n_valid=None if n_valid is None else jnp.asarray(n_valid, jnp.int32))
        pos += n if n_valid is None else 20
        assert state.n == int(jstate.n)
        got, glen = inc.speech_encoder_stream_output(params, state, cfg)
        want, wlen = jinc.speech_encoder_stream_output(jparams, jstate, jcfg)
        S = int(wlen[0])
        assert int(glen[0]) == S
        close(got[0, :S], np.asarray(want)[0, :S], INC_TOL)
        full, flen = enc.speech_encoder_forward(params, torch.from_numpy(stream[:, :pos]),
                                                torch.tensor([pos]), cfg)
        assert int(flen[0]) == S
        close(got[0, :S], full[0, :S], INC_TOL)


def test_streaming_arch_matches_jax():
    got, want = get_arch("streaming"), jget_arch("streaming")
    sp, jsp = got.speech, want.speech
    assert (sp.chunk_size, sp.left_chunk_num) == (jsp.chunk_size, jsp.left_chunk_num) == (8, -1)
    assert tuple(sp.conformer) == tuple(jsp.conformer)
    assert tuple(got.nllb) == tuple(want.nllb)
    assert tuple(got.nar_t2u) == tuple(want.nar_t2u)
    assert (got.use_text_encoder, got.arch) == (want.use_text_encoder, want.arch)
    # the other archs keep full attention
    for name in ("base_v2", "tiny_v2", "base"):
        assert get_arch(name).speech.chunk_size is None


def test_chunked_forward_through_the_fused_option(setup, monkeypatch):
    """With ``SEAMLESS_FUSED_ATTN=1`` the chunked conformer's attentions
    (T = 150 >= 128) go through ``try_flash``, the chunk and padding biases
    folded into ``ab`` from their broadcast view (on the CPU the flash
    wrapper computes its plain version): the same output within 1e-5, and
    under ``ab`` the fp32 forward skips no tile pair."""
    from seamless_communication_torch.ops.kernels import flash_attention as fl

    _, _, cfg, params, _ = setup
    fbank = torch.from_numpy(
        np.random.default_rng(2).standard_normal((1, 300, 80)).astype(np.float32))
    lens = torch.tensor([283])
    calls = []
    reference = fl._reference_fwd

    def spy(*args, **kw):
        calls.append(args[3])
        return reference(*args, **kw)

    monkeypatch.setattr(fl, "_reference_fwd", spy)
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", "0")
    want, _ = enc.speech_encoder_forward(params, fbank, lens, cfg)
    assert not calls
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", "1")
    got, _ = enc.speech_encoder_forward(params, fbank, lens, cfg)
    close(got, want)
    assert len(calls) == cfg.conformer.num_layers
    ab = calls[0]
    assert ab.shape == (1, 4, 150, 150)
    assert not bool(fl.skippable_tiles_fwd(None, None, 150, 150, ab).any())
    # the chunk mask is in ab: query 0 sees keys 0-3 only
    assert bool((ab[0, :, 0, 4:] <= -1e8).all()) and bool((ab[0, :, 0, :4] > -1e8).all())


def test_fused_option_promotes_mixed_dtypes(monkeypatch):
    """The incremental agent's cross-attention: fp32 queries (the int8 EMMA
    decoder's activations) over bf16 keys and values (the incremental
    encoder's buffer). ``try_flash`` promotes them as the plain product
    does and returns v's dtype; the result is the plain attention's within
    one bf16 rounding of its probabilities."""
    from seamless_communication_torch.ops import attention as attn_ops
    from seamless_communication_torch.ops.masks import padding_bias

    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 2, 130, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 140, 16)).astype(np.float32)
                             ).to(torch.bfloat16) for _ in range(2))
    bias = padding_bias(torch.arange(140)[None] < 131)
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", "0")
    want = attn_ops._sdpa(q, k, v, bias)
    monkeypatch.setenv("SEAMLESS_FUSED_ATTN", "1")
    got = attn_ops._sdpa(q, k, v, bias)
    assert got.dtype == want.dtype == torch.bfloat16
    close(got.float(), want.float(), dict(rtol=1.6e-2, atol=1.6e-2))
