"""The port's log-mel fbank function (kernel K4 on the card) against the JAX
package: its plain version ``_reference`` against ``fbank_pallas`` in
interpret mode at the tolerance of tests/unit/test_pallas_kernels.py
(energetic bins, log-mel > 0: atol 2e-2, rtol 1e-3, mean < 2e-3; near-floor
bins are dominated by cancellation) and against the port's ``fbank_numpy``
(fp64) likewise; ``_fft_reference``, the kernel's own arithmetic (its FFT
stages, split step and compacted mel ranges) in PyTorch, against both at
the same tolerance, and its FFT against numpy's; the kernel's plan (grid
and shared memory) through ``frame_plan``. Frames past the waveform's end
hold log(MEL_FLOOR)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seamless_communication_tpu.ops.kernels.fbank_pallas import fbank_pallas
from seamless_communication_torch.audio.fbank import (
    MEL_FLOOR, fbank_numpy, num_frames,
)
from seamless_communication_torch.ops.kernels import fbank as tfb
from seamless_communication_torch.ops.kernels import launch_counts


def _signal(seconds: float, seed: int) -> np.ndarray:
    """A tone plus noise, as JAX's own fbank test draws it."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 330 * t)
            + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def _assert_energetic_close(got, want, n_frames):
    m = want[:n_frames] > 0
    np.testing.assert_allclose(got[:n_frames][m], want[:n_frames][m], atol=2e-2, rtol=1e-3)
    assert float(np.abs(got[:n_frames] - want[:n_frames])[m].mean()) < 2e-3


@pytest.mark.parametrize("seconds,max_frames", [(2.0, 256), (1.3, 128)])
def test_reference_matches_jax_kernel_and_numpy(seconds, max_frames):
    sig = _signal(seconds, 11)
    before = dict(launch_counts)
    got = tfb.fbank(torch.from_numpy(sig), max_frames=max_frames).numpy()
    assert launch_counts == before           # a CPU waveform launches nothing
    assert got.shape == (max_frames, 80) and got.dtype == np.float32
    T = num_frames(len(sig))
    jgot = np.asarray(fbank_pallas(jnp.asarray(sig), max_frames=max_frames,
                                   interpret=True))
    _assert_energetic_close(got, jgot, T)
    _assert_energetic_close(got, fbank_numpy(sig), T)
    # frames wholly past the end read zeros only
    past = tfb.needed_frames(len(sig), max_frames)
    np.testing.assert_array_equal(got[past:], np.float32(math.log(MEL_FLOOR)))
    np.testing.assert_allclose(np.asarray(jgot)[past:], got[past:], atol=1e-6)


def test_max_frames_must_be_a_multiple_of_128():
    with pytest.raises(ValueError, match="multiple of 128"):
        tfb.fbank(torch.zeros(16000), max_frames=100)


def test_bound_counts_needed_frames():
    # 1.3 s: 20800 samples, read by frames 0..129; 128 frames asked
    nbytes, flops = tfb.bound(20800, 128)
    assert tfb.needed_frames(20800, 128) == 128 and tfb.needed_frames(20800, 256) == 130
    assert nbytes == 4 * 20800 + 4 * 128 * 80
    # the 80 Kaldi filters over 257 bins hold 501 nonzero weights
    assert flops == 128 * (5 * 400 + 11520 + 257 * 3 + 2 * 501 + 80)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    sig = torch.from_numpy(_signal(4.0, 3)).cuda()
    got = tfb.fbank(sig, max_frames=512).cpu().numpy()
    want = tfb._reference(sig, 512).cpu().numpy()
    _assert_energetic_close(got, want, num_frames(len(sig)))


@pytest.mark.parametrize("seconds,max_frames", [(2.0, 256), (1.3, 128)])
def test_fft_reference_matches_plain_and_jax(seconds, max_frames):
    """The kernel's algorithm on the CPU: the same function as the plain
    version and the JAX kernel, at the same tolerance, and exactly
    log(MEL_FLOOR) on frames past the end."""
    sig = _signal(seconds, 11)
    got = tfb._fft_reference(torch.from_numpy(sig), max_frames).numpy()
    assert got.shape == (max_frames, 80) and got.dtype == np.float32
    T = num_frames(len(sig))
    want = tfb._reference(torch.from_numpy(sig), max_frames).numpy()
    _assert_energetic_close(got, want, T)
    jgot = np.asarray(fbank_pallas(jnp.asarray(sig), max_frames=max_frames, interpret=True))
    _assert_energetic_close(got, jgot, T)
    past = tfb.needed_frames(len(sig), max_frames)
    np.testing.assert_array_equal(got[past:], np.float32(math.log(MEL_FLOOR)))


def test_fft_stages_match_numpy():
    """The kernel's 256-point FFT (stages A, B, C of csrc/fbank.cu) equals
    numpy's FFT to fp32 rounding."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((4, 256)) + 1j * rng.standard_normal((4, 256))
    _, cos_t, sin_t, _, _ = (torch.as_tensor(a) for a in tfb._kernel_tables(80, 16000))
    zr, zi = tfb._fft256_reference(torch.tensor(z.real, dtype=torch.float32),
                                   torch.tensor(z.imag, dtype=torch.float32), cos_t, sin_t)
    want = np.fft.fft(z, axis=-1)
    err = np.abs(zr.numpy() + 1j * zi.numpy() - want).max()
    assert err <= 1e-6 * np.abs(want).max() * 16


def test_kernel_tables_compact_the_mel_filters():
    """Each filter's nonzero bins are one range [lo, hi); the compacted
    weights, filter by filter, are the dense matrix's nonzero weights."""
    from seamless_communication_torch.audio.fbank import kaldi_mel_filters

    win, cos_t, sin_t, weights, ranges = tfb._kernel_tables(80, 16000)
    dense = kaldi_mel_filters(257, 80, 16000, 20.0, 8000.0).astype(np.float32)
    assert weights.shape == (501,) and weights.shape[0] <= tfb.MAX_MEL_WEIGHTS
    assert win.shape == (400,) and cos_t.shape == sin_t.shape == (512,)
    rebuilt = np.zeros_like(dense)
    for m, (lo, hi, off) in enumerate(ranges):
        rebuilt[lo:hi, m] = weights[off:off + hi - lo]
        assert (dense[lo:hi, m] > 0).all()
    np.testing.assert_array_equal(rebuilt, dense)
    # the one buffer the kernel copies: window, cos, sin at 0, 400, 912, the
    # weights at 1424, the ranges (int32 bits) after the weights padded to 4
    packed = tfb._packed_tables(80, 16000)
    assert packed.dtype == np.float32 and len(packed) % 4 == 0
    np.testing.assert_array_equal(packed[:400], win)
    np.testing.assert_array_equal(packed[400:912], cos_t)
    np.testing.assert_array_equal(packed[912:1424], sin_t)
    np.testing.assert_array_equal(packed[1424:1925], weights)
    np.testing.assert_array_equal(packed[1928:1928 + 240].view(np.int32), ranges.reshape(-1))


def test_frame_plan_owns_every_frame_once():
    """The kernel's grid: every frame of max_frames = 128, 256, ..., 4096
    owned by exactly one block, a warp a frame; 128 blocks (one wave on 132
    SMs) up to 1024 frames; the block's static shared memory under 48 KB."""
    for max_frames in range(128, 4097, 128):
        plan = tfb.frame_plan(max_frames)
        F, blocks = plan["frames"], plan["blocks"]
        owner = np.zeros(max_frames, np.int64)
        for b in range(blocks):
            owner[b * F:(b + 1) * F] += 1
        assert (owner == 1).all() and plan["threads"] == 32 * F
        assert 1 <= F <= tfb.MAX_BLOCK_FRAMES and plan["smem"] <= tfb.SMEM_LIMIT
        if max_frames <= 1024:
            assert blocks == 128
    assert tfb.frame_plan(512)["frames"] == 4 and tfb.frame_plan(1024)["frames"] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("seconds,max_frames", [(4.0, 512), (10.0, 1024)])
def test_kernel_at_main_lengths_on_card(seconds, max_frames):
    """K4 at 4 s and 10 s against the plain version, once per call (one
    launch), frames past the end exactly log(MEL_FLOOR)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    sig = torch.from_numpy(_signal(seconds, 3)).cuda()
    before = launch_counts["fbank"]
    got = tfb.fbank(sig, max_frames=max_frames).cpu().numpy()
    assert launch_counts["fbank"] - before == 1
    want = tfb._reference(sig, max_frames).cpu().numpy()
    _assert_energetic_close(got, want, num_frames(len(sig)))
    past = tfb.needed_frames(len(sig), max_frames)
    np.testing.assert_array_equal(got[past:], np.float32(math.log(MEL_FLOOR)))
