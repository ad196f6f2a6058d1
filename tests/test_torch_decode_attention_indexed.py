"""The port's row-indexed int8-KV decode attention (the lazy beam reorder)
against the JAX package: its plain version ``_indexed_reference`` against
JAX ``_indexed_reference``, ``_indexed_onehot`` and the Pallas kernel in
interpret mode, on the fixture of tests/unit/test_decode_attention_kernel.py
(``row_src`` drawn uniformly from [0, B)), at steps 0, 5 and T-1: ``out``
within 2e-5 (fp32 summation order). With a table that is one permutation
for every position, it equals the classic step's ``_reference`` output
(within 2e-5), since that gathers the same rows."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seamless_communication_tpu.ops.kernels import decode_attention as jda
from seamless_communication_torch.ops.kernels import decode_attention as tda
from seamless_communication_torch.ops.kernels import launch_counts

B, H, T, Dh = 5, 4, 24, 8
NAMES = ("q", "kt", "vt", "kc", "vc", "ks", "vs")


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
        rs=rng.integers(0, B, (B, T)).astype(np.int32),
    )


def _torch(d, rs, step):
    return (*(torch.from_numpy(d[n]) for n in NAMES), torch.from_numpy(rs), step)


JAX_FORMS = {
    "reference": lambda *a: jda._indexed_reference(*a),
    "onehot": lambda *a: jda._indexed_onehot(*a),
    "pallas_interpret": lambda *a: jda.indexed_decode_self_attention_int8(
        *a, use_pallas=True, interpret=True),
}


@pytest.mark.parametrize("against", sorted(JAX_FORMS))
@pytest.mark.parametrize("step", [0, 5, T - 1])
def test_indexed_reference_matches_jax(data, step, against):
    want = JAX_FORMS[against](*(jnp.asarray(data[n]) for n in NAMES),
                              jnp.asarray(data["rs"]), step)
    got = tda._indexed_reference(*_torch(data, data["rs"], step))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("step", [0, 9, T - 1])
def test_one_permutation_table_equals_the_classic_step(data, step):
    """row_src[b, t] = src[b] for every t reads what the classic step's
    gather by src reads."""
    src = np.array([3, 0, 2, 1, 4], np.int32)
    rs = np.repeat(src[:, None], T, axis=1)
    got = tda._indexed_reference(*_torch(data, rs, step))
    want = tda._reference(*(torch.from_numpy(data[n]) for n in NAMES), step,
                          torch.from_numpy(src))[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_the_plain_version(data):
    """On CPU tensors the wrapper computes ``_indexed_reference``, reads only
    rows t < step and launches nothing."""
    before = dict(launch_counts)
    args = _torch(data, data["rs"], 7)
    got = tda.indexed_decode_self_attention_int8(*args)
    assert torch.equal(got, tda._indexed_reference(*args))
    # rows t >= step do not matter
    kc, vc = args[3].clone(), args[4].clone()
    kc[:, :, 7:], vc[:, :, 7:] = 99, -99
    again = tda.indexed_decode_self_attention_int8(*args[:3], kc, vc, *args[5:])
    assert torch.equal(got, again)
    assert launch_counts == before


def test_indexed_bound_counts_distinct_rows():
    """Two beams reading the same (slot, t) row count it once; no writes but
    out."""
    rs = torch.tensor([[0, 0, 1, 1], [0, 1, 1, 0]], dtype=torch.int32)
    rows = 1 + 2        # t=0: slot 0; t=1: slots 0 and 1; t=2 is the current step
    assert tda.indexed_bound_bytes(rs, 2, 16, 64, elem=4) == (
        rows * 16 * (2 * 64 + 8) + 4 * 2 * 2 + 3 * 2 * 16 * 64 * 4 + 2 * 16 * 64 * 4)
    assert tda.indexed_bound_bytes(rs, 0, 16, 64, elem=4) == 4 * 2 * 16 * 64 * 4


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
    (kq, ks), (vq, vs) = (tda.quantize_kv_rows(t(rng.standard_normal((Bm, Hm, Tm, Dm)),
                                                 torch.float32)) for _ in range(2))
    rs = t(rng.integers(0, Bm, (Bm, Tm)), torch.int32)
    tol = 2e-5 if dt == torch.float32 else 1.6e-2
    for step in (0, 200, Tm - 1):
        args = (*vecs, kq, vq, ks, vs, rs, step)
        got = tda.indexed_decode_self_attention_int8(*args)
        want = tda._indexed_reference(*args)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
