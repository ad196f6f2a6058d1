"""The port's log-mel fbank function (kernel K4 on the card) against the JAX
package: its plain version ``_reference`` against ``fbank_pallas`` in
interpret mode at the tolerance of tests/unit/test_pallas_kernels.py
(energetic bins, log-mel > 0: atol 2e-2, rtol 1e-3, mean < 2e-3; near-floor
bins are dominated by cancellation) and against the port's ``fbank_numpy``
(fp64) likewise. Frames past the waveform's end hold log(MEL_FLOOR)."""

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
