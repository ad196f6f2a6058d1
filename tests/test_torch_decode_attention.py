"""The port's fused int8-KV decode-attention step against the JAX package:
its plain version ``_reference`` against JAX ``_reference`` and against the
Pallas kernel run in interpret mode, on the fixture of
tests/unit/test_decode_attention_kernel.py. ``out`` within 2e-5 (fp32
summation order); caches and scales exactly equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seamless_communication_tpu.ops.kernels import decode_attention as jda
from seamless_communication_torch.ops.kernels import decode_attention as tda
from seamless_communication_torch.ops.kernels import launch_counts

B, H, T, Dh = 5, 4, 24, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return dict(
        q=rng.standard_normal((B, H, Dh)).astype(np.float32),
        kt=rng.standard_normal((B, H, Dh)).astype(np.float32),
        vt=rng.standard_normal((B, H, Dh)).astype(np.float32),
        kc=rng.integers(-127, 128, (B, H, T, Dh)).astype(np.int8),
        vc=rng.integers(-127, 128, (B, H, T, Dh)).astype(np.int8),
        ks=(rng.random((B, H, T)) * 0.1 + 0.01).astype(np.float32),
        vs=(rng.random((B, H, T)) * 0.1 + 0.01).astype(np.float32),
        src=np.array([3, 0, 2, 1, 4], np.int32),
    )


def _args(d, step, lib):
    names = ("q", "kt", "vt", "kc", "vc", "ks", "vs")
    if lib == "jax":
        return (*(jnp.asarray(d[n]) for n in names), jnp.int32(step),
                jnp.asarray(d["src"]))
    return (*(torch.from_numpy(d[n]) for n in names), step, torch.from_numpy(d["src"]))


@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("step", [0, 5, T - 1])
def test_reference_matches_jax(data, step, against):
    jargs = _args(data, step, "jax")
    want = (jda._reference(*jargs) if against == "reference" else
            jda.fused_decode_self_attention_int8(*jargs, use_pallas=True,
                                                 interpret=True))
    got = tda._reference(*_args(data, step, "torch"))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-5, atol=2e-5)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # scales: absmax / 127 is an IEEE division in both packages' eager code;
    # under jit XLA rewrites it to absmax * (1/127), one ulp off at most
    rtol = 0.0 if against == "reference" else 2.0 ** -23
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=0)


def test_cpu_tensors_take_the_plain_version(data):
    """On CPU tensors the wrapper computes ``_reference`` and launches nothing."""
    before = launch_counts[tda.KERNEL]
    args = _args(data, 7, "torch")
    got = tda.fused_decode_self_attention_int8(*args)
    for g, w in zip(got, tda._reference(*args)):
        assert torch.equal(g, w)
    assert launch_counts[tda.KERNEL] == before


def test_bound_bytes_counts_each_byte_once():
    # distinct source beams read once; B new caches written once
    assert tda.bound_bytes(5, 16, 320, 64, n_src=5, elem=4) == (
        2 * 5 * 16 * 320 * (2 * 64 + 8) + 4 * 5 * 16 * 64 * 4 + 4 * 5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(dtype):
    """The CUDA kernel against its plain version at the main-path shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    Bm, Hm, Tm, Dm = 5, 16, 320, 64
    dev = torch.device("cuda")
    t = lambda a, d: torch.as_tensor(a).to(device=dev, dtype=d)
    vecs = [t(rng.standard_normal((Bm, Hm, Dm)), dt) for _ in range(3)]
    # caches as the decoder fills them: unit-variance rows, quantized
    (kq, ks), (vq, vs) = (tda.quantize_kv_rows(t(rng.standard_normal((Bm, Hm, Tm, Dm)),
                                                 torch.float32)) for _ in range(2))
    caches, scales = (kq, vq), (ks, vs)
    src = t(np.array([3, 0, 3, 1, 1]), torch.int32)
    for step in (0, 1, 137, Tm - 1):
        args = (*vecs, *caches, *scales, step, src)
        got = tda.fused_decode_self_attention_int8(*args)
        want = tda._reference(*args)
        tol = 2e-5 if dt == torch.float32 else 1.6e-2
        torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol, atol=tol)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w)
